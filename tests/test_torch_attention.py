"""The port's attention against the JAX package on the CPU: K6's plain
version against ``flash_attention`` run through the Pallas kernel in
interpret mode, and the model's ``attention()`` (dense / chunked / tri)
and ``decode_attention`` against ``repro.models.attention``.  Inputs are
made with numpy from a seed and handed to both.

Tolerances: float32 1e-5 (the same math, summed in another order);
bfloat16 2e-2 (both compute in float32 and round once, from the same
bfloat16 inputs).  The numerical design of K6's bf16 tensor-core route is
held to its card limit, per output atol 1e-5 with rtol 2^-6."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ops import flash_attention as jax_flash
from repro.models import attention as jattn
from repro_torch.kernels.attention.kernel import flash_attention_cuda
from repro_torch.kernels.attention.ops import flash_attention, mha_ref
from repro_torch.models import attention as tattn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of ``dtype``."""
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)


# (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, fused)
FLASH_CASES = {
    "causal_gqa": (1, 4, 2, 64, 64, 16, True, None, 0, False),
    "full_mha": (2, 2, 2, 32, 64, 16, False, None, 0, False),
    "window": (1, 2, 1, 64, 64, 16, True, 24, 0, False),
    "q_offset": (1, 2, 2, 32, 64, 16, True, None, 32, False),
    "fused_aos": (1, 4, 2, 64, 64, 16, True, None, 0, True),
    # gemma3's and recurrentgemma's local layers: head dim 256, a window,
    # GQA and MQA
    "window_d256_gqa": (1, 4, 2, 64, 64, 256, True, 24, 0, False),
    "window_d256_mqa": (1, 4, 1, 64, 64, 256, True, 40, 0, False),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_matches_pallas_kernel(case, dtype):
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, fused = \
        FLASH_CASES[case]
    rng = np.random.default_rng(0)
    jq, q = _pair(rng.standard_normal((B, Hq, Sq, D)), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if fused:
        jkv, kv = _pair(rng.standard_normal((B, Hkv, Skv, 2, D)), dtype)
        want = jax_flash(jq, jkv, None, block_q=32, block_k=32,
                         use_pallas=True, interpret=True, **kw)
        got = flash_attention(q, kv, None, block_q=32, block_k=32, **kw)
    else:
        jk, k = _pair(rng.standard_normal((B, Hkv, Skv, D)), dtype)
        jv, v = _pair(rng.standard_normal((B, Hkv, Skv, D)), dtype)
        want = jax_flash(jq, jk, jv, block_q=32, block_k=32,
                         use_pallas=True, interpret=True, **kw)
        got = flash_attention(q, k, v, block_q=32, block_k=32, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, TOL[dtype])


def test_flash_keeps_the_reference_block_contract():
    """Explicit blocks must tile the sequences, as in the reference
    (which asserts it); without explicit blocks any length is taken."""
    q = torch.zeros(1, 1, 96, 16)
    with pytest.raises(ValueError, match="must tile"):
        flash_attention(q, q, q, block_q=64, block_k=64)
    with pytest.raises(AssertionError):
        jq = jnp.zeros((1, 1, 96, 16))
        jax_flash(jq, jq, jq, block_q=64, block_k=64, use_pallas=True)
    assert flash_attention(q, q, q).shape == q.shape


def test_cpu_tensors_take_the_plain_version():
    before = flash_attention_cuda.launches
    q = torch.randn(1, 2, 8, 16)
    torch.testing.assert_close(flash_attention(q, q, q), mha_ref(q, q, q))
    out = tattn.attention(q.transpose(1, 2), q.transpose(1, 2),
                          q.transpose(1, 2), qpos=torch.arange(8),
                          kpos=torch.arange(8), q_chunk=4, k_chunk=4)
    assert out.shape == (1, 8, 2, 16)
    assert flash_attention_cuda.launches == before


@pytest.mark.parametrize("impl", ["dense", "chunked", "tri"])
@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_attention_matches_reference(impl, window, dtype):
    B, S, H, Hkv, D = 2, 48, 4, 2, 16
    rng = np.random.default_rng(1)
    jq, q = _pair(rng.standard_normal((B, S, H, D)), dtype)
    jk, k = _pair(rng.standard_normal((B, S, Hkv, D)), dtype)
    jv, v = _pair(rng.standard_normal((B, S, Hkv, D)), dtype)
    pos = np.arange(S, dtype=np.int32)
    want = jattn.attention(jq, jk, jv, qpos=jnp.asarray(pos),
                           kpos=jnp.asarray(pos), window=window, impl=impl,
                           q_chunk=16, k_chunk=16)
    got = tattn.attention(q, k, v, qpos=torch.from_numpy(pos),
                          kpos=torch.from_numpy(pos), window=window,
                          impl=impl, q_chunk=16, k_chunk=16)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("fmt", ["bshd", "bhsd"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("gqa", [True, False])
def test_decode_attention_matches_reference(fmt, window, gqa):
    """Ragged cache lengths per batch row, GQA grouping against the
    reference's repeated KV heads."""
    B, S, H, D = 3, 20, 4, 16
    Hkv = 2 if gqa else H
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    shape = (B, S, Hkv, D) if fmt == "bshd" else (B, Hkv, S, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    cache_len = np.array([3, 20, 11], np.int32)
    h_ax = 2 if fmt == "bshd" else 1
    jk = jnp.repeat(jnp.asarray(k), H // Hkv, axis=h_ax)
    jv = jnp.repeat(jnp.asarray(v), H // Hkv, axis=h_ax)
    want = jattn.decode_attention(jnp.asarray(q), jk, jv,
                                  jnp.asarray(cache_len), window=window,
                                  kv_format=fmt)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(cache_len),
                                 window=window, kv_format=fmt)
    _close(got, want, 1e-5)


def test_decode_attention_explicit_kpos():
    B, S, H, D = 2, 8, 2, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    kpos = np.stack([np.arange(S), np.arange(S)[::-1]]).astype(np.int32)
    cache_len = np.array([5, 6], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(k), jnp.asarray(cache_len),
                                  kpos=jnp.asarray(kpos))
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(k),
                                 torch.from_numpy(cache_len),
                                 kpos=torch.from_numpy(kpos))
    _close(got, want, 1e-5)


# -- the numerical design of K6's bf16 route ----------------------------------

def _flash_pv(q, k, v, pv: str, block: int = 64):
    """Causal flash attention on bf16 inputs in float32, as K6's bf16 route
    runs it: online softmax over ``block``-key tiles, ``l`` summed from the
    float32 P, the output rounded once.  ``pv`` says how each tile's P·V is
    formed from bf16 operands, as the tensor cores take them: ``"float32"``
    (P kept in float32), ``"split"`` (P_hi = bf16(P) and P_lo = bf16(P -
    P_hi), both products summed in float32) or ``"rounded"`` (P rounded
    once to bf16)."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    k = k.float().repeat_interleave(group, 1)
    v = v.float().repeat_interleave(group, 1)
    scores = q.float() @ k.transpose(-1, -2) * (1 / math.sqrt(D))
    pos = torch.arange(S)
    m = torch.full((B, Hq, S, 1), -1e30)
    l = torch.zeros((B, Hq, S, 1))
    acc = torch.zeros((B, Hq, S, D))
    for j in range(0, S, block):
        seen = pos[:, None] >= pos[None, j:j + block]
        s = scores[..., j:j + block]
        m_new = torch.maximum(m, s.masked_fill(~seen, -1e30).amax(
            -1, keepdim=True))
        p = torch.where(seen, torch.exp(s - m_new), 0.0)
        vb = v[:, :, j:j + block]
        if pv == "float32":
            o = p @ vb
        else:
            hi = p.bfloat16().float()
            o = hi @ vb
            if pv == "split":
                o = o + (p - hi).bfloat16().float() @ vb
        alpha = torch.exp(m - m_new)
        acc = acc * alpha + o
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / l).to(q.dtype)


@pytest.mark.parametrize("pv,inside", [("float32", True), ("split", True),
                                       ("rounded", False)])
def test_k6_bf16_design_keeps_its_limit(pv, inside):
    """Why K6 splits P: with P rounded once to bf16 before P·V some 5 % of
    the outputs leave the limit against the float32 plain version; the
    hi/lo split, at 1.5x the tensor-core work, keeps them all inside, as
    float32 P does."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16() for shape in ((1, 4, 512, 128),
                                              (1, 1, 512, 128),
                                              (1, 1, 512, 128)))
    want = mha_ref(q, k, v).float()
    got = _flash_pv(q, k, v, pv).float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    outside = int((~((got - want).abs() <= 1e-5 + 2**-6 * want.abs()))
                  .sum())
    assert (outside == 0) == inside, f"{outside} outputs outside the limit"
