"""Attention for the LM stack.

Three implementations of full-sequence attention, selected per config
(``attn_impl``), as in ``repro.models.attention``:

* ``dense``   — (S, S) scores with a mask; the tests' reference.
* ``chunked`` — online softmax over every (q-chunk, k-chunk) pair, the
                masked ones included.
* ``tri``     — online softmax over the pairs the causal / window mask
                needs.

``dense_attention`` and ``chunked_attention`` are the plain PyTorch
versions.  :func:`attention` sends ``chunked`` and ``tri`` on a CUDA
tensor to the K6 flash-attention kernel (``kernels/attention``), which
maps GQA heads itself (no ``repeat_kv``) and clips its KV loop to the
visible band, so both impls run the same kernel there; on a CPU tensor, or
with ``use_kernel=False``, they run the plain version.  The kernel runs
inside ``FlashAttentionFn``: its gradient is the plain version's,
recomputed in the backward, which is what the JAX package differentiates
when it trains (its training path runs no kernel).

Decode attention (one query token against the cache) stays plain torch,
as the JAX package computes it in jnp outside any Pallas kernel; the
LSE-combined version over a sequence-sharded cache waits for the
multi-GPU queue.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels._common import on_cuda
from ..kernels.attention.kernel import flash_attention_fn

__all__ = ["NEG_INF", "repeat_kv", "dense_attention", "chunked_attention",
           "attention", "decode_attention"]

NEG_INF = -1e30


def _mask_bias(qpos, kpos, *, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(..., Lq, Lk) additive bias from causal / sliding-window
    visibility."""
    d = qpos[..., :, None] - kpos[..., None, :]
    ok = (d >= 0) if causal else torch.ones_like(d, dtype=torch.bool)
    if window is not None:
        ok = ok & (d < window)
    return torch.where(ok, 0.0, NEG_INF).float()


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Replicate KV heads (axis 2 of ``(B, S, Hkv, D)``) to ``n_heads``."""
    Hkv = k.shape[2]
    if Hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // Hkv, dim=2)


def _gqa_scores(q, k, scale):
    """q (B,Lq,H,D), k (B,Lk,Hkv,D) -> scores (B,Hkv,G,Lq,Lk), float32."""
    B, Lq, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Lq, Hkv, H // Hkv, D)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale


def _gqa_out(p, v):
    """p (B,Hkv,G,Lq,Lk) float32, v (B,Lk,Hkv,D) -> (B,Lq,H,D) float32."""
    B, Hkv, G, Lq, _ = p.shape
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Lq, Hkv * G, v.shape[-1])


def dense_attention(q, k, v, *, qpos, kpos, causal=True, window=None,
                    scale=None):
    """Full (Lq, Lk) scores; qpos (Lq,), kpos (Lk,) global positions."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = _gqa_scores(q, k, scale)
    s = s + _mask_bias(qpos, kpos, causal=causal, window=window)
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v).to(q.dtype)


def _chunk_pairs(nq: int, nk: int, *, causal: bool,
                 window_chunks: Optional[int]) -> list[tuple[int, int]]:
    """The (qi, ki) chunk pairs the mask needs."""
    pairs = []
    for qi in range(nq):
        for ki in range(nk):
            if causal and ki > qi + (nk - nq):
                continue
            if window_chunks is not None and \
                    (qi + (nk - nq)) - ki >= window_chunks:
                continue
            pairs.append((qi, ki))
    return pairs


def _fit(L: int, c: int) -> int:
    """The largest divisor of ``L`` that is at most ``c``."""
    c = min(c, L)
    while L % c:
        c -= 1
    return c


def chunked_attention(q, k, v, *, qpos, kpos, causal=True, window=None,
                      q_chunk=512, k_chunk=512, impl="chunked", scale=None):
    """Flash-style attention (online softmax) over chunk pairs, the plain
    version.  q (B,Lq,H,D); k, v (B,Lk,Hkv,D); ``impl='tri'`` visits only
    the pairs the mask needs."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q_chunk, k_chunk = _fit(Lq, q_chunk), _fit(Lk, k_chunk)
    nq, nk = Lq // q_chunk, Lk // k_chunk
    G = H // Hkv
    wc = None
    if window is not None:
        wc = (window + k_chunk - 1) // k_chunk + 1
    if impl == "tri":
        pairs = _chunk_pairs(nq, nk, causal=causal, window_chunks=wc)
    else:
        pairs = [(qi, ki) for qi in range(nq) for ki in range(nk)]

    qf = q.float().reshape(B, nq, q_chunk, Hkv, G, D)
    kf = k.float().reshape(B, nk, k_chunk, Hkv, D)
    vf = v.float().reshape(B, nk, k_chunk, Hkv, D)
    qpos_c = qpos.reshape(nq, q_chunk)
    kpos_c = kpos.reshape(nk, k_chunk)
    # one running (acc, m, l) per query chunk, rebound and never written
    # in place, so that autograd can differentiate the loop
    acc = [torch.zeros((B, q_chunk, Hkv, G, D), dtype=torch.float32,
                       device=q.device) for _ in range(nq)]
    m = [torch.full((B, q_chunk, Hkv, G), NEG_INF, dtype=torch.float32,
                    device=q.device) for _ in range(nq)]
    l = [torch.zeros_like(m[0]) for _ in range(nq)]
    for qi, ki in pairs:
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, qi], kf[:, ki]) * scale
        s = s + _mask_bias(qpos_c[qi], kpos_c[ki], causal=causal,
                           window=window)
        m_blk = torch.movedim(s.amax(dim=-1), -1, 1)      # (B,Lqc,Hkv,G)
        m_new = torch.maximum(m[qi], m_blk)
        p = torch.exp(s - torch.movedim(m_new, 1, -1)[..., None])
        corr = torch.exp(m[qi] - m_new)
        l[qi] = l[qi] * corr + torch.movedim(p.sum(dim=-1), -1, 1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf[:, ki])
        acc[qi] = acc[qi] * corr[..., None] + o
        m[qi] = m_new
    out = torch.stack(acc, dim=1) / torch.clamp(
        torch.stack(l, dim=1)[..., None], min=1e-30)
    return out.reshape(B, Lq, H, D).to(q.dtype)


def attention(q, k, v, *, qpos, kpos, causal=True, window=None,
              impl="chunked", q_chunk=512, k_chunk=512, scale=None,
              replicate_kv: bool = True, q_offset: int = 0,
              use_kernel: bool = True):
    """Full-sequence attention, q (B,Lq,H,D), k/v (B,Lk,Hkv,D).

    On a CUDA tensor with ``impl`` ``chunked`` or ``tri`` this is the K6
    kernel, which takes the positions as ``qpos = q_offset + arange(Lq)``
    and ``kpos = arange(Lk)`` (the model's prefill positions); the plain
    versions read ``qpos``/``kpos`` as given.  The kernel's gradient is
    the plain version's on the same arguments.  ``use_kernel=False`` asks
    for the plain version on either device."""
    if use_kernel and impl in ("chunked", "tri") and on_cuda(q):
        def plain(q, k, v):
            return attention(q, k, v, qpos=qpos, kpos=kpos, causal=causal,
                             window=window, impl=impl, q_chunk=q_chunk,
                             k_chunk=k_chunk, scale=scale,
                             replicate_kv=replicate_kv, use_kernel=False)

        return flash_attention_fn(q, k, v, plain=plain, causal=causal,
                                  window=window, q_offset=q_offset,
                                  scale=scale)
    if replicate_kv:
        k = repeat_kv(k, q.shape[2])
        v = repeat_kv(v, q.shape[2])
    if impl == "dense":
        return dense_attention(q, k, v, qpos=qpos, kpos=kpos, causal=causal,
                               window=window, scale=scale)
    return chunked_attention(q, k, v, qpos=qpos, kpos=kpos, causal=causal,
                             window=window, q_chunk=q_chunk,
                             k_chunk=k_chunk, impl=impl, scale=scale)


# ---------------------------------------------------------------------------
# decode attention (one query token against the cache)
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None,
                     kpos=None, window: Optional[int] = None,
                     kv_format: str = "bshd"):
    """One decode step on one device.  q (B,H,D); caches (B,S,Hkv,D)
    ["bshd"] or (B,Hkv,S,D) ["bhsd"]; cache_len (B,) valid prefix length;
    ``kpos`` (B, S) the position each slot holds (default: its index).
    GQA is mapped by grouping the query heads, not by repeating KV."""
    if kv_format == "bshd":
        B, S, Hkv, D = k_cache.shape
        klbl = "bshd"
    else:
        B, Hkv, S, D = k_cache.shape
        klbl = "bhsd"
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kpos is None:
        kpos = torch.arange(S, dtype=torch.int32,
                            device=q.device)[None].expand(B, S)
    kmask = kpos < cache_len[:, None]
    if window is not None:
        kmask = kmask & (kpos >= (cache_len[:, None] - window))
    H = q.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum(f"bhgd,{klbl}->bhgs", qg, k_cache.float()) * scale
    s = torch.where(kmask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=-1)
    num = torch.einsum(f"bhgs,{klbl}->bhgd", p, v_cache.float())
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)
