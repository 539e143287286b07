"""Public flash-attention op over layout-polymorphic KV storage.

A CUDA tensor goes to the K6 kernel (or the wrapper raises), a CPU tensor
to the plain PyTorch version; ``use_kernel=False`` asks for the plain
version on either device.
"""

from __future__ import annotations

from ...tuning.tiles import resolve_tile
from .._common import on_cuda
from .kernel import DEFAULT_BLOCKS, TILE_KERNEL, flash_attention_cuda
from .ref import decode_ref, mha_ref

__all__ = ["flash_attention", "mha_ref", "decode_ref"]


def flash_attention(q, k, v=None, *, causal=True, window=None, q_offset=0,
                    scale=None, block_q=None, block_k=None,
                    use_kernel: bool = True):
    """Flash attention.  SoA KV: ``(q, k, v)`` with k, v ``(B, Hkv, S,
    D)``; AoS KV: ``(q, kv_fused, None)`` with kv ``(B, Hkv, S, 2, D)``.

    ``block_q``/``block_k`` given explicitly keep the reference's
    contract: after clamping to the sequence lengths they must tile them,
    on either device, so that the same calls fail in both packages.  They
    do not change the result: the CUDA kernel uses its own tiles."""
    if block_q is not None or block_k is not None:
        bq, bk = resolve_tile(TILE_KERNEL,
                              (block_q or DEFAULT_BLOCKS[0],
                               block_k or DEFAULT_BLOCKS[1]),
                              DEFAULT_BLOCKS, shape=(q.shape[2], k.shape[2]))
        bq, bk = min(bq, q.shape[2]), min(bk, k.shape[2])
        if q.shape[2] % bq or k.shape[2] % bk:
            raise ValueError(f"sequence lengths {(q.shape[2], k.shape[2])} "
                             f"must tile by blocks {(bq, bk)}")
    if use_kernel and on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
    if v is None:
        k, v = k[..., 0, :], k[..., 1, :]
    return mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                   scale=scale)

