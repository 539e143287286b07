"""Mamba-2 SSD intra-chunk CUDA kernel (K7) — wrapper of ``csrc/ssd.cu``.

:func:`ssd_intra_chunk_cuda` replaces ``ssd_intra_chunk_pallas``
(``repro/kernels/ssd/kernel.py``): per (batch, chunk, head) the
intra-chunk quadratic dual form and the chunk's outgoing state.  The
inter-chunk scan around it is torch ops (``ref.ssd_inter_chunk``).

bfloat16 runs on the tensor cores (``wgmma``), which read 16-byte pieces:
it needs 16-byte-aligned x, B and C with P and N multiples of 8, and
raises ``ValueError`` otherwise.  float32 runs on the CUDA cores.

The kernel computes the forward only, as the Pallas kernel does.  On the
training path it runs inside :class:`SsdIntraChunkFn`, whose backward
recomputes the plain version (``ref.ssd_intra_chunk_ref``) and
differentiates it: the JAX package trains through its plain SSD, so that
is the gradient the reference takes.  The wrapper itself raises when grad
mode is on and an input requires grad.
"""

from __future__ import annotations

import ctypes

import torch

from ...tuning.tiles import register_tile_kernel
from .. import _build
from .._common import check_cuda_tensor, plain_vjp, refuse_grad, stream_of
from .ref import ssd_intra_chunk_ref

__all__ = ["TILE_KERNEL", "DEFAULT_CHUNK", "tile_candidates",
           "ssd_intra_chunk_cuda", "SsdIntraChunkFn"]

TILE_KERNEL = "ssd"       # name in the tile registry
DEFAULT_CHUNK = 64

_SIG = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SIGNATURES = {"ssd_intra_chunk_f32": _SIG, "ssd_intra_chunk_bf16": _SIG}


def tile_candidates(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Feasible chunk lengths for a sequence of ``S`` positions: exact
    tilings, as the reference registers them (the CUDA kernel takes
    every one: chunks of up to 256)."""
    (s,) = shape
    return tuple(c for c in (32, 64, 128, 256) if c <= s and s % c == 0)


register_tile_kernel(TILE_KERNEL, tile_candidates)


def ssd_intra_chunk_cuda(x, dt, A, Bm, C, *, chunk: int = DEFAULT_CHUNK):
    """K7 on the GPU.  x ``(B, S, H, P)`` and Bm, C ``(B, S, N)`` in one of
    float32 / bfloat16; dt ``(B, S, H)`` and A ``(H,)`` float32; all
    contiguous.  Returns ``(y_intra (B, S, H, P) in x's dtype, s_chunk (B,
    S/chunk, H, P, N) float32)``.  A chunk of 129-256 positions runs as
    two 128-row tiles in one block.  A chunk above 256, P above 64 or N
    above 128 is refused by the launch itself ("invalid argument")."""
    refuse_grad("ssd_intra_chunk_cuda", "SsdIntraChunkFn", x, dt, A, Bm, C)
    sfx = check_cuda_tensor(x, "ssd x")
    for t, what in ((Bm, "ssd B"), (C, "ssd C")):
        check_cuda_tensor(t, what)
        if t.dtype != x.dtype:
            raise TypeError(f"{what}: dtype {t.dtype} != x dtype {x.dtype}")
    for t, what in ((dt, "ssd dt"), (A, "ssd A")):
        check_cuda_tensor(t, what)
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: dtype {t.dtype} is not float32")
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B_, S, H) or tuple(A.shape) != (H,) or \
            tuple(Bm.shape) != (B_, S, N) or tuple(C.shape) != (B_, S, N):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(C.shape)} disagree")
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd: sequence {S} must tile by chunk {chunk}")
    offsets = [t.data_ptr() % 16 for t in (x, Bm, C)]
    if x.dtype == torch.bfloat16 and (P % 8 or N % 8 or any(offsets)):
        raise ValueError(f"ssd: bfloat16 needs 16-byte-aligned x, B and C "
                         f"and P, N that are multiples of 8, got P {P}, N "
                         f"{N}, offsets {offsets} bytes")
    nc = S // chunk
    y = torch.empty_like(x)
    s = torch.empty((B_, nc, H, P, N), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = getattr(lib, f"ssd_intra_chunk_{sfx}")(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), y.data_ptr(), s.data_ptr(), B_, S, H, P, N, chunk,
            stream_of(x))
    _build.check(lib, code, "ssd_intra_chunk")
    ssd_intra_chunk_cuda.launches += 1
    return y, s


ssd_intra_chunk_cuda.launches = 0


class SsdIntraChunkFn(torch.autograd.Function):
    """K7 with a gradient: ``apply(x, dt, A, Bm, C, chunk)`` returns the
    kernel's ``(y_intra, s_chunk)``; the backward recomputes
    ``ssd_intra_chunk_ref`` from the saved inputs and returns its gradient
    (the JAX package has no backward kernel)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, chunk):
        y, s = ssd_intra_chunk_cuda(x, dt, A, Bm, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, C)
        ctx.chunk = chunk
        return y, s

    @staticmethod
    def backward(ctx, grad_y, grad_s):
        chunk = ctx.chunk
        return plain_vjp(
            lambda *ins: ssd_intra_chunk_ref(*ins, chunk=chunk),
            ctx.saved_tensors, ctx.needs_input_grad[:5],
            (grad_y, grad_s)) + (None,)
