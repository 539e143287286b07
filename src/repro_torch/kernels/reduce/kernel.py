"""NaN-ignoring max and min CUDA kernel — wrapper of ``csrc/reduce.cu``.

:func:`nan_ignoring_extremum_cuda` reduces a float32 view where it lies,
with no temporaries: no copy of a strided view, no NaN mask, no fill.  It
replaces no Pallas kernel (the JAX package reduces with ``jnp`` in XLA);
it is the local reduction of the ``MaxReducer`` and the ``MinReducer``
(``core/graph.py``) on the card.

The view is merged from its strides into ``rows`` rows of ``cols``
contiguous elements, ``row_stride`` elements apart
(:func:`merge_view`): an AoS record's field ``(n, 3)`` with strides
``(6, 1)`` is ``n`` rows of 3, 6 apart; a SoA field and a contiguous
tensor are one row.  Where the elements between rows add up to less than
a 32-byte sector, the card fetches every sector of the span anyway, and
the kernel reads the whole span and keeps the view's lanes (the span
read); otherwise it reads row by row (:func:`read_whole_span`).

The wrapper checks device, dtype and view, and ``out`` (a 0-d float32
tensor on the same device), allocates the per-block partials with
``torch.empty``, launches on PyTorch's current stream and adds one to
``launches``: no host synchronisation, so a CUDA graph captures it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import _build
from .._common import check_out, stream_of

#: bytes of the card's memory sector: gaps below it are fetched anyway
SECTOR_BYTES = 32
#: the most 256-thread blocks an SM holds (2048 threads), which sizes the
#: scratch for the per-block partials
BLOCKS_PER_SM = 8

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {"nan_ignoring_extremum_f32": [_P, _I64, _I64, _I64, _I, _I,
                                             _P, _I, _P, _P]}


def merge_view(shape, strides) -> Optional[tuple[int, int, int]]:
    """``(rows, cols, row_stride)`` of a view of ``shape`` and element
    ``strides`` with at least one element: ``cols`` contiguous elements a
    row, rows ``row_stride`` elements apart (one row: ``row_stride`` is
    ``cols``).  Dimensions of size 1 drop out and the others merge in the
    order of their strides, which a max or min may take.  None where the
    view is no such pair: a broadcast (stride 0) or overlapping
    dimension, or more than one gap."""
    dims = sorted((st, n) for n, st in zip(shape, strides) if n != 1)
    merged: list = []
    for st, n in dims:
        if st == 0:
            return None
        if merged and st == merged[-1][0] * merged[-1][1]:
            merged[-1] = (merged[-1][0], merged[-1][1] * n)
        else:
            merged.append((st, n))
    if not merged:
        return 1, 1, 1
    (s0, n0), *rest = merged
    if not rest:
        return (1, n0, n0) if s0 == 1 else (n0, 1, s0)
    if len(rest) > 1 or s0 != 1 or rest[0][0] < n0:
        return None
    row_stride, rows = rest[0]
    return rows, n0, row_stride


def read_whole_span(rows: int, cols: int, row_stride: int) -> bool:
    """True for the span read: one row, or gaps between rows below a
    sector (with a row stride that fits the kernel's 32-bit phase)."""
    return rows == 1 or ((row_stride - cols) * 4 < SECTOR_BYTES
                         and row_stride < 2**31)


def kernel_geometry(device_type: str, dtype: torch.dtype, shape,
                    strides) -> Optional[tuple[int, int, int, bool]]:
    """The kernel's route, decided from what a tensor shows: for a CUDA
    float32 view with elements whose strides merge, ``(rows, cols,
    row_stride, span)`` (:func:`merge_view`, :func:`read_whole_span`);
    None for everything else, which takes the plain version."""
    if device_type != "cuda" or dtype != torch.float32 \
            or math.prod(shape) == 0:
        return None
    view = merge_view(shape, strides)
    if view is None:
        return None
    return (*view, read_whole_span(*view))


@functools.lru_cache(maxsize=None)
def _capacity(index: int) -> int:
    return (torch.cuda.get_device_properties(index).multi_processor_count
            * BLOCKS_PER_SM)


def nan_ignoring_extremum_cuda(x: torch.Tensor, *, largest: bool,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The max (``largest``) or min of every element of the CUDA float32
    view ``x``, a quiet NaN ignored and the all-NaN view reduced to NaN,
    read where it lies; into ``out`` (a 0-d float32 tensor on ``x``'s
    device) when given.  Raises for any other tensor."""
    geometry = kernel_geometry(x.device.type, x.dtype, x.shape, x.stride())
    if geometry is None:
        raise ValueError(
            f"nan_ignoring_extremum: expects a CUDA float32 view with "
            f"elements whose strides merge into rows, got "
            f"{tuple(x.shape)} strides {x.stride()} {x.dtype} on "
            f"{x.device}")
    rows, cols, row_stride, span = geometry
    if out is None:
        out = torch.empty((), dtype=x.dtype, device=x.device)
    else:
        check_out(out, (), x.dtype, x.device, "nan_ignoring_extremum")
    capacity = _capacity(x.device.index)
    partials = torch.empty(capacity, dtype=x.dtype, device=x.device)
    lib = _build.load("reduce", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = lib.nan_ignoring_extremum_f32(
            x.data_ptr(), rows, cols, row_stride, int(span), int(largest),
            partials.data_ptr(), capacity, out.data_ptr(), stream_of(x))
    _build.check(lib, code, "nan_ignoring_extremum")
    nan_ignoring_extremum_cuda.launches += 1
    return out


nan_ignoring_extremum_cuda.launches = 0
