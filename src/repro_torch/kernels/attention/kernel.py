"""Flash-attention forward CUDA kernel (K6) — wrapper of
``csrc/attention.cu``.

:func:`flash_attention_cuda` replaces ``flash_attention_pallas``
(``repro/kernels/attention/kernel.py``): GQA, causal masking with a query
offset, a sliding window, and KV given as separate k and v (SoA) or as one
fused ``(B, Hkv, Skv, 2, D)`` array (AoS).  The kernel reads its inputs
through element strides, so q, k, v and the output may be views whose last
dim is contiguous: the model passes its ``(B, S, H, D)`` projections
transposed, with no copy.  Any sequence length is taken: the kernel masks
its own ragged edge.

bfloat16 runs on the tensor cores (``wgmma``), which read 16-byte pieces:
it needs 16-byte-aligned tensors whose ``(b, h, s)`` strides and D are
multiples of 8 elements, and raises ``ValueError`` otherwise.  float32
runs on the CUDA cores and takes any strides.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...tuning.tiles import register_tile_kernel
from .. import _build
from .._common import DTYPE_SUFFIX, plain_vjp, refuse_grad, stream_of

__all__ = ["TILE_KERNEL", "DEFAULT_BLOCKS", "tile_candidates",
           "flash_attention_cuda", "FlashAttentionFn", "flash_attention_fn"]

TILE_KERNEL = "attention"  # name in the tile registry
DEFAULT_BLOCKS = (128, 128)

_SIG = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
_SIGNATURES = {"flash_attention_f32": _SIG, "flash_attention_bf16": _SIG}


def tile_candidates(shape: tuple[int, ...]) -> tuple[tuple[int, int], ...]:
    """Feasible ``(block_q, block_k)`` pairs for query/kv sequence lengths
    ``(sq, skv)``, as the reference registers them: multiples of 64 that
    tile both sequences exactly.  The CUDA kernel uses its own 64 x 64
    tiles and masks a ragged edge, so the pair only matters to the
    reference's contract (kernels/attention/ops.py)."""
    sq, skv = shape
    return tuple((bq, bk)
                 for bq in (64, 128, 256) if bq <= sq and sq % bq == 0
                 for bk in (64, 128, 256) if bk <= skv and skv % bk == 0)


register_tile_kernel(TILE_KERNEL, tile_candidates)


def _bhs_strides(t: torch.Tensor, what: str) -> list[int]:
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {what} has a non-contiguous "
                         f"last dim (stride {t.stride(-1)})")
    strides = [t.stride(0), t.stride(1), t.stride(2)]
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(st % 8 for st in strides)
            or t.shape[-1] % 8):
        raise ValueError(
            f"flash_attention: bfloat16 {what} needs a 16-byte-aligned "
            f"base, (b, h, s) strides and D that are multiples of 8 "
            f"elements, got offset {t.data_ptr() % 16} bytes, strides "
            f"{tuple(strides)}, D {t.shape[-1]}")
    return strides


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: Optional[torch.Tensor] = None, *,
                         causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0, scale: Optional[float] = None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention on the GPU.  q: ``(B, Hq, Sq, D)``; k, v: ``(B,
    Hkv, Skv, D)`` each, or the fused ``(B, Hkv, Skv, 2, D)`` as ``k`` with
    ``v=None``; float32 or bfloat16, all of one dtype, D <= 256.  ``out``
    (optional) is a ``(B, Hq, Sq, D)`` tensor of q's dtype to write into,
    which may be a strided view.  Returns the output, in q's dtype."""
    if v is None:
        if k.dim() != 5 or k.shape[3] != 2:
            raise ValueError(f"flash_attention: fused kv must be (B, Hkv, "
                             f"Skv, 2, D), got {tuple(k.shape)}")
        k, v = k[..., 0, :], k[..., 1, :]
    refuse_grad("flash_attention_cuda", "FlashAttentionFn "
                "(flash_attention_fn)", q, k, v)
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {what} is on {t.device}, "
                             f"not a CUDA device")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {what} dtype {t.dtype} != q "
                            f"dtype {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {what} must be 4-d, got "
                             f"{tuple(t.shape)}")
    if q.dtype not in DTYPE_SUFFIX:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not float32 "
                        f"or bfloat16")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Skv, D) or tuple(v.shape) != tuple(
            k.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads are not a "
                         f"multiple of {Hkv} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    elif tuple(out.shape) != tuple(q.shape) or out.dtype != q.dtype \
            or out.device != q.device:
        raise ValueError("flash_attention: out does not match q")
    strides = (ctypes.c_int64 * 12)(
        *_bhs_strides(q, "q"), *_bhs_strides(k, "k"), *_bhs_strides(v, "v"),
        *_bhs_strides(out, "out"))
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lib = _build.load("attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = getattr(lib, f"flash_attention_{DTYPE_SUFFIX[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, B, Hq, Hkv, Sq, Skv, D, q_offset,
            0 if window is None else window, int(causal), scale,
            stream_of(q))
    _build.check(lib, code, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K6 with a gradient, in the model's layout: q ``(B, Sq, Hq, D)``, k
    and v ``(B, Skv, Hkv, D)``.  The forward is the kernel; the backward
    recomputes ``plain(q, k, v)`` from the saved inputs and returns its
    gradient (the JAX package has no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, plain, causal, window, q_offset, scale):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window,
                             q_offset=q_offset, scale=scale,
                             out=out.transpose(1, 2))
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, grad_out):
        return plain_vjp(ctx.plain, ctx.saved_tensors,
                         ctx.needs_input_grad[:3], (grad_out,)) + (None,) * 5


def flash_attention_fn(q, k, v, *, plain, causal: bool = True,
                       window: Optional[int] = None, q_offset: int = 0,
                       scale: Optional[float] = None) -> torch.Tensor:
    """K6 on ``(B, S, H, D)`` tensors with a gradient: ``plain(q, k, v)``
    is the plain version of the same function, which the backward
    differentiates."""
    return FlashAttentionFn.apply(q, k, v, plain, causal, window, q_offset,
                                  scale)
