"""SAXPY CUDA kernels (paper §7.1, Table 2) — wrappers of ``csrc/saxpy.cu``.

K1 :func:`saxpy_cuda` replaces ``saxpy_pallas`` and K2
:func:`saxpy_record_cuda` replaces ``saxpy_record_pallas``
(``repro/kernels/saxpy/kernel.py``).  The paper uses SAXPY to measure the
overhead of its iterator abstraction: the bounds-checked (BC) variant tests
every index, the unchecked (NBC) variant runs its whole rounds of 16-byte
vectors without the test and only the last, partial round with it.  The
record form puts x and y in ONE record buffer, the layout axis of Table 2.

Each wrapper checks device, dtype, shape and contiguity, writes into
``out=`` (checked the same way) or else a new output from ``torch.empty``,
launches on PyTorch's current stream and adds one to its ``launches``
count.  Both kernels read and write each element in one thread, so
``out`` may be the tensor they update (``y``, or the record itself): the
CUDA sources promise no ``__restrict__`` between the two pointers.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.layout import Layout, RecordArray, RecordSpec, aosoa_tile
from ...tuning.tiles import register_tile_kernel
from .. import _build
from .._common import (LAYOUT_CODE, check_cuda_tensor, check_out, record_out,
                       round_to, stream_of)

SAXPY_SPEC = RecordSpec.create("x", "y")
SUPPORTED_LAYOUTS = (Layout.AOS, Layout.SOA, Layout.AOSOA)
PREFERRED_LAYOUT = Layout.SOA
TILE_KERNEL = "saxpy"
DEFAULT_BLOCK = 1024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FLAT = [_P, _P, _P, _F, ctypes.c_int64, _I, _P]
_RECORD = [_P, _P, _F, ctypes.c_int64, _I, _I, _I, _P]
_SIGNATURES = {"saxpy_f32": _FLAT, "saxpy_bf16": _FLAT,
               "saxpy_record_f32": _RECORD, "saxpy_record_bf16": _RECORD}


def tile_candidates(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Cells-per-block sizes that tile a 1-d record space of ``n`` cells."""
    (n,) = shape
    return tuple(b for b in (256, 512, 1024, 2048, 4096, 8192)
                 if b <= n and n % b == 0)


register_tile_kernel(TILE_KERNEL, tile_candidates)


def check_record_block(n: int, block: int) -> None:
    """The reference's contract for the record kernels: ``block`` cells
    per program must tile the ``n`` cells exactly."""
    if block < 1 or n % block:
        raise ValueError(f"n={n} must tile by block={block}")


def saxpy_cuda(a, x: torch.Tensor, y: torch.Tensor, *, block: int = 1024,
               bounds_check: bool = True,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a * x + y`` over flat CUDA tensors; ``a`` is rounded to the
    working dtype first.  Any ``n``, and views at any offset.  ``block``
    keeps the reference's contract (``>= 1``) but sets no grid: the kernel
    sizes its grid to the work, capped by the SM count, and moves 16 bytes
    per load; a view off the 16-byte grid, such as ``x[1:]``, runs the
    kernel's scalar loop.  ``out`` (``y`` itself for ``y += a * x``, or a
    tensor apart from ``x`` and ``y``) receives the result."""
    sfx = check_cuda_tensor(x, "saxpy x")
    check_cuda_tensor(y, "saxpy y")
    if x.dim() != 1 or x.shape != y.shape or x.dtype != y.dtype \
            or x.device != y.device:
        raise ValueError(f"saxpy: x {tuple(x.shape)} {x.dtype} and y "
                         f"{tuple(y.shape)} {y.dtype} must be equal 1-d")
    if block < 1:
        raise ValueError(f"saxpy: block must be >= 1, got {block}")
    if out is None:
        out = torch.empty_like(x)
    else:
        check_out(out, x.shape, x.dtype, x.device, "saxpy", apart=(x,),
                  in_place=(y,))
    lib = _build.load("saxpy", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = getattr(lib, f"saxpy_{sfx}")(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), round_to(a, x.dtype),
            x.numel(), int(bounds_check), stream_of(x))
    _build.check(lib, code, "saxpy")
    saxpy_cuda.launches += 1
    return out


saxpy_cuda.launches = 0


def saxpy_record_cuda(rec: RecordArray, a, *, block: int = 1024,
                      out: Optional[RecordArray] = None) -> RecordArray:
    """``y = a*x + y`` on a ``SAXPY_SPEC`` record on the GPU, in any of the
    three layouts (x copied through); into ``out`` when given, a record of
    the same spec, space and layout (``rec`` itself to update it in
    place)."""
    sfx = check_cuda_tensor(rec.data, "saxpy_record")
    if rec.spec != SAXPY_SPEC or rec.layout not in SUPPORTED_LAYOUTS \
            or len(rec.space) != 1:
        raise ValueError(f"saxpy_record: expects a 1-d SAXPY_SPEC record, "
                         f"got {rec!r}")
    (n,) = rec.space
    check_record_block(n, block)
    tile = aosoa_tile(n) if rec.layout is Layout.AOSOA else 1
    dst = record_out(out, rec, "saxpy_record")
    lib = _build.load("saxpy", _SIGNATURES)
    with torch.cuda.device(rec.data.device):
        code = getattr(lib, f"saxpy_record_{sfx}")(
            rec.data.data_ptr(), dst.data_ptr(), round_to(a, rec.dtype), n,
            LAYOUT_CODE[rec.layout], tile, block, stream_of(rec.data))
    _build.check(lib, code, "saxpy_record")
    saxpy_record_cuda.launches += 1
    return out if out is not None else RecordArray(dst, rec.spec, rec.layout)


saxpy_record_cuda.launches = 0
