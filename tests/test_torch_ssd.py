"""The port's Mamba-2 SSD against the JAX package on the CPU: K7's plain
version against ``ssd_intra_chunk_pallas`` in interpret mode, the whole
``ssd`` against ``ssd_pallas``, ``ssd_chunked`` and ``ssd_naive``, and the
Mamba-2 block (``mamba2_forward`` at a length that is no chunk multiple,
``mamba2_decode``) against ``repro.models.ssm``.  Inputs are made with
numpy from a seed and handed to both.

Tolerances: float32 1e-5 for the kernel's function and the layers (the
same math summed in another order); bfloat16 2e-2."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import kernel as jk
from repro.kernels.ssd import ref as jr
from repro.models import ssm as jssm
from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
from repro_torch.kernels.ssd.ops import ssd, ssd_intra_chunk
from repro_torch.kernels.ssd import ref as tr
from repro_torch.models import ssm as tssm
from repro_torch.models.common import Init, ParamModule

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype="float32"):
    """numpy -> torch through the JAX dtype, so both hold the same bits."""
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TDT[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)


def _inputs(B, S, H, P, N, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((B, S, H, P)), dtype)
    dt = _t(rng.uniform(1e-3, 1e-1, (B, S, H)))
    A = _t(-np.linspace(1.0, 16.0, H))
    Bm = _t(rng.standard_normal((B, S, N)), dtype)
    C = _t(rng.standard_normal((B, S, N)), dtype)
    return x, dt, A, Bm, C


@pytest.mark.parametrize("shape", [(1, 64, 2, 16, 16, 16),
                                   (2, 48, 3, 8, 24, 24),
                                   (1, 512, 2, 16, 16, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_intra_chunk_plain_version_matches_pallas_kernel(shape, dtype):
    B, S, H, P, N, chunk = shape
    (jx, x), (jdt, dt), (jA, A), (jB, Bm), (jC, C) = _inputs(
        B, S, H, P, N, dtype)
    jy, js = jk.ssd_intra_chunk_pallas(jx, jdt, jA, jB, jC, chunk=chunk,
                                       interpret=True)
    before = ssd_intra_chunk_cuda.launches
    y, s = ssd_intra_chunk(x, dt, A, Bm, C, chunk=chunk)
    assert ssd_intra_chunk_cuda.launches == before   # CPU: plain version
    assert y.dtype == x.dtype and s.dtype == torch.float32
    _close(y, jy, TOL[dtype])
    _close(s, js, TOL[dtype])


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_matches_pallas_chunked_and_naive(with_state):
    B, S, H, P, N, chunk = 2, 64, 2, 8, 16, 16
    (jx, x), (jdt, dt), (jA, A), (jB, Bm), (jC, C) = _inputs(B, S, H, P, N)
    (jD, D) = _t(np.linspace(0.5, 1.5, H))
    js0 = t0 = None
    if with_state:
        js0, t0 = _t(np.random.default_rng(5).standard_normal((B, H, P, N)))
    y, st = ssd(x, dt, A, Bm, C, D, t0, chunk=chunk)
    for fn in (lambda *a: jk.ssd_pallas(*a, chunk=chunk, interpret=True),
               lambda *a: jr.ssd_chunked(*a, chunk=chunk), jr.ssd_naive):
        wy, wst = fn(jx, jdt, jA, jB, jC, jD, js0)
        _close(y, wy, 1e-4)
        _close(st, wst, 1e-4)
    py, pst = tr.ssd_chunked(x, dt, A, Bm, C, D, t0, chunk=chunk)
    ny, nst = tr.ssd_naive(x, dt, A, Bm, C, D, t0)
    _close(py, wy, 1e-4)
    _close(ny, wy, 1e-4)
    _close(nst, wst, 1e-4)


def test_decode_step_matches_reference():
    B, H, P, N = 2, 3, 8, 16
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, P, N), (B, H, P), (B, N), (B, N))]
    dtt = rng.uniform(1e-3, 1e-1, (B, H)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    D = np.ones(H, np.float32)
    ws, wy = jr.ssd_decode_step(*map(jnp.asarray, (arrs[0], arrs[1], dtt, A,
                                                   arrs[2], arrs[3], D)))
    gs, gy = tr.ssd_decode_step(*map(torch.from_numpy, (arrs[0], arrs[1],
                                                        dtt, A, arrs[2],
                                                        arrs[3], D)))
    _close(gs, ws, 1e-5)
    _close(gy, wy, 1e-5)


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((5, 4)).astype(np.float32)
    pre = rng.standard_normal((2, 3, 5)).astype(np.float32)
    for prefix in (None, pre):
        want = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  prefix=None if prefix is None
                                  else jnp.asarray(prefix))
        got = tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 prefix=None if prefix is None
                                 else torch.from_numpy(prefix))
        _close(got, want, 1e-5)


@functools.lru_cache(maxsize=None)
def _mamba_params(d=32, N=16, H=4, P=8):
    """JAX Mamba-2 parameters and the port's module holding the same."""
    from repro.models.common import ParamTree

    pt = ParamTree(jax.random.PRNGKey(3))
    jssm.init_mamba2(pt, d_model=d, d_state=N, n_heads=H, head_dim=P)
    jp = pt.params["mamba"]
    parent = ParamModule()
    tssm.init_mamba2(Init(torch.Generator().manual_seed(0), torch.float32,
                          "cpu"), parent, d_model=d, d_state=N, n_heads=H,
                     head_dim=P)
    tp = parent["mamba"]
    with torch.no_grad():
        for name, v in jp.items():
            tp[name].copy_(torch.from_numpy(np.array(v)))
    return jp, tp


# the JAX block compiled whole: op by op, each new shape costs seconds
_jax_forward = jax.jit(jssm.mamba2_forward, static_argnames="chunk")
_jax_decode = jax.jit(jssm.mamba2_decode)


@pytest.mark.parametrize("S", [32, 21])
def test_mamba2_forward_matches_reference(S):
    """21 is no multiple of the chunk (8): the sequence is padded with
    dt = 0 and the final state stays exact."""
    jp, tp = _mamba_params()
    x = np.random.default_rng(8).standard_normal((2, S, 32)).astype(
        np.float32)
    wy, (ws, wc) = _jax_forward(jp, jnp.asarray(x), chunk=8)
    gy, (gs, gc) = tssm.mamba2_forward(tp, torch.from_numpy(x), chunk=8)
    _close(gy, wy, 1e-5)
    _close(gs, ws, 1e-5)
    _close(gc, wc, 1e-5)


def test_mamba2_decode_matches_reference():
    jp, tp = _mamba_params()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    _, jstate = _jax_forward(jp, jnp.asarray(x), chunk=4)
    _, tstate = tssm.mamba2_forward(tp, torch.from_numpy(x), chunk=4)
    for _ in range(3):
        xt = rng.standard_normal((2, 32)).astype(np.float32)
        wo, jstate = _jax_decode(jp, jnp.asarray(xt), jstate)
        go, tstate = tssm.mamba2_decode(tp, torch.from_numpy(xt), tstate)
        _close(go, wo, 1e-5)
        _close(tstate[0], jstate[0], 1e-5)
        _close(tstate[1], jstate[1], 1e-5)


# -- the numerical design of K7's bf16 route ----------------------------------

@functools.lru_cache(maxsize=None)
def _k7_case():
    """mamba2-130m's prefill shape (B, S, H, P, N, chunk) = (1, 2048, 24,
    64, 128, 128) with inputs as ``chip_smoke.py`` makes them (x, B, C
    standard normal in bf16, dt uniform in [1e-3, 0.1), A = -(1 .. 16)),
    from a numpy seed; the plain version's outputs; and the kernel's
    float32 intermediates: S' = (C B^T) o decay o dt (B, nc, H, L, L), the
    state operand (w x)^T (B, nc, H, P, L) with w_j = dt_j exp(cs_{L-1} -
    cs_j), x as (B, nc, H, L, P) and B as (B, nc, 1, L, N)."""
    B_, S, H, P, N, L = 1, 2048, 24, 64, 128, 128
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B_, S, H, P)).astype(
        np.float32)).bfloat16()
    dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (B_, S, H)).astype(
        np.float32))
    A = -torch.from_numpy(np.linspace(1.0, 16.0, H).astype(np.float32))
    Bm, C = (torch.from_numpy(rng.standard_normal((B_, S, N)).astype(
        np.float32)).bfloat16() for _ in range(2))
    want = tr.ssd_intra_chunk_ref(x, dt, A, Bm, C, chunk=L)
    nc = S // L
    dtc = dt.reshape(B_, nc, L, H).movedim(3, 2)              # (B,nc,H,L)
    cs = torch.cumsum(dtc * A[:, None], dim=-1)
    tri = torch.ones((L, L), dtype=torch.bool).tril()
    decay = torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :],
                                  0.0)) * tri
    bc = Bm.float().reshape(B_, nc, L, N)
    cb = torch.einsum("bcin,bcjn->bcij", C.float().reshape(B_, nc, L, N), bc)
    s_prime = cb[:, :, None] * decay * dtc[..., None, :]
    xh = x.float().reshape(B_, nc, L, H, P).movedim(3, 2)
    w = dtc * torch.exp(cs[..., -1:] - cs)
    return want, s_prime, (xh * w[..., None]).transpose(-1, -2), xh, \
        bc[:, :, None]


def _bf16_pieces(a, n):
    """``a`` as ``n`` bf16 pieces that sum to it (hi, then what is left)."""
    pieces = []
    for _ in range(n):
        pieces.append(a.bfloat16().float())
        a = a - pieces[-1]
    return pieces


@pytest.mark.parametrize("part,design,inside", [
    ("y_intra", "float32", True), ("y_intra", "split", True),
    ("y_intra", "rounded", False), ("chunk states", 1, False),
    ("chunk states", 2, True), ("chunk states", 3, True)])
def test_k7_bf16_design_keeps_its_limit(part, design, inside):
    """Why K7 issues S' and the state weights as bf16 hi/lo pairs: the
    tensor cores take bf16 operands, and a float32 operand rounded once to
    bf16 puts outputs outside the limits ``chip_smoke.py`` holds K7 to
    against the plain version (y_intra (2e-4, 2^-6); the float32 chunk
    states (2e-5, 2e-5)).  Two pieces keep every output inside, as float32
    operands do; three gain nothing the limit sees."""
    want, s_prime, state_a, xh, bc = _k7_case()
    if part == "y_intra":
        pieces = {"float32": [s_prime], "split": _bf16_pieces(s_prime, 2),
                  "rounded": _bf16_pieces(s_prime, 1)}[design]
        got = sum(p @ xh for p in pieces).movedim(2, 3).reshape(
            want[0].shape).bfloat16()
        ref, (atol, rtol) = want[0], (2e-4, 2**-6)
    else:
        got = sum(p @ bc for p in _bf16_pieces(state_a, design))
        ref, (atol, rtol) = want[1], (2e-5, 2e-5)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    outside = int((~((got.float() - ref.float()).abs()
                     <= atol + rtol * ref.float().abs())).sum())
    assert (outside == 0) == inside, f"{outside} outputs outside the limit"
