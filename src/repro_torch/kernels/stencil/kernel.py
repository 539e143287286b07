"""FORCE flux-difference CUDA kernel (paper §7.3, Table 4) — wrapper of
``csrc/stencil.cu``.

K4 :func:`flux_difference_cuda` replaces ``flux_difference_pallas``
(``repro/kernels/stencil/kernel.py``): the FORCE flux difference summed
over both dims of a haloed 2-D Euler record (space ``(nx+2, ny+2)`` in,
``(nx, ny)`` out) with per-dim λ.  Each warp streams a strip of rows
through registers and computes each face once: the x-face it carries from
row to row, the y-face its lanes pass each other by shuffles
(:func:`flux_geometry` says how strips map onto warps and blocks).  AoS
and SoA are native; AoSoA is relayouted by the ops wrapper.

The kernel's geometry is its own and masks the ragged edge; the
reference's ``block`` contract (clamped to the interior, dividing it) is
kept by :func:`check_block`, so the same calls succeed and fail in both
packages.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ...core.layout import Layout, RecordArray
from ...physics.euler import EULER_SPEC
from ...tuning.tiles import register_tile_kernel
from .. import _build
from .._common import (LAYOUT_CODE, check_cuda_tensor, check_out, round_to,
                       stream_of)

SUPPORTED_LAYOUTS = (Layout.AOS, Layout.SOA)
PREFERRED_LAYOUT = Layout.SOA
TILE_KERNEL = "flux"
DEFAULT_BLOCK = (8, 128)
#: the kernel's limits (``kMaxRows``, ``kMaxWarps`` in csrc/stencil.cu):
#: lane r of a warp prepares row r's edge faces in shared memory sized for
#: 8 rows and 4 warps; the grid's second dim is CUDA's
MAX_ROWS = 8
MAX_WARPS = 4
MAX_GRID_Y = 65535
#: the geometry taken: strips of 4 rows, 4 warps a block, the fastest that
#: ``tools/k4_geometry.py`` reads at 4096^2 float32 on an H100 (a strip's
#: loads all go out together at its start, and the walk keeps only two
#: rows ahead in flight, so short strips keep more loads in flight)
ROWS_PER_STRIP = 4
WARPS_PER_BLOCK = 4

_SIG = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
_SIGNATURES = {f"{fn}_{sfx}": _SIG
               for fn in ("flux_difference", "flux_traffic")
               for sfx in ("f32", "bf16")}


def tile_candidates(shape: tuple[int, ...]) -> tuple[tuple[int, int], ...]:
    """``(bx, by)`` tiles that divide an interior of ``(nx, ny)`` cells."""
    nx, ny = shape
    return tuple((bx, by)
                 for bx in (8, 16, 32, 64) if bx <= nx and nx % bx == 0
                 for by in (64, 128, 256) if by <= ny and ny % by == 0)


register_tile_kernel(TILE_KERNEL, tile_candidates)


def check_block(interior: tuple[int, int], block) -> None:
    """The reference's tile contract: ``block`` clamped to the interior
    must divide it."""
    nx, ny = interior
    bx, by = block
    bx, by = min(bx, nx), min(by, ny)
    if bx < 1 or by < 1 or nx % bx or ny % by:
        raise ValueError(f"interior {(nx, ny)} must tile by block "
                         f"{(bx, by)}")


class FluxGeometry(NamedTuple):
    """How K4 covers an ``(nx, ny)`` interior: warp ``w`` of block
    ``(gx, gy)`` of ``grid`` owns the 32 interior columns from
    ``(gx * warps_per_block + w) * 32`` (lane ``l`` the ``l``-th) and walks
    the rows ``gy * rows_per_strip`` up to ``rows_per_strip`` further, or
    to the interior's last row.  It reads the haloed rows from its first
    row to one past its last (haloed row ``x + 1`` holds interior row
    ``x``; the walk's loads run two rows further, clamped to ``nx + 1``),
    and the haloed columns from its first to two past its last, clamped to
    ``ny + 1``."""

    rows_per_strip: int
    warps_per_block: int
    grid: tuple[int, int]

    @property
    def threads(self) -> int:
        return 32 * self.warps_per_block


@functools.lru_cache(maxsize=64)
def flux_geometry(nx: int, ny: int) -> FluxGeometry:
    """K4's geometry for an ``(nx, ny)`` interior: strips of
    ``ROWS_PER_STRIP`` rows (all of them when fewer), up to
    ``WARPS_PER_BLOCK`` warps a block side by side along y."""
    if nx < 1 or ny < 1:
        raise ValueError(f"flux_difference: empty interior ({nx}, {ny})")
    rows = min(ROWS_PER_STRIP, nx)
    col_groups = -(-ny // 32)
    warps = min(WARPS_PER_BLOCK, col_groups)
    return FluxGeometry(rows, warps, (-(-col_groups // warps),
                                      -(-nx // rows)))


def _launch(fn: str, state_haloed: RecordArray, lam_x, lam_y,
            out: Optional[RecordArray] = None) -> RecordArray:
    sfx = check_cuda_tensor(state_haloed.data, "flux_difference")
    if state_haloed.spec != EULER_SPEC \
            or state_haloed.layout not in SUPPORTED_LAYOUTS \
            or len(state_haloed.space) != 2:
        raise ValueError(f"flux_difference: expects a 2-d AoS or SoA "
                         f"EULER_SPEC record, got {state_haloed!r}")
    nx, ny = (s - 2 for s in state_haloed.space)
    geo = flux_geometry(nx, ny)
    if geo.grid[1] > MAX_GRID_Y:
        raise ValueError(f"flux_difference: nx={nx} exceeds the grid")
    cell_bytes = 4 * state_haloed.data.element_size()
    if state_haloed.layout is Layout.AOS \
            and state_haloed.data.data_ptr() % cell_bytes:
        raise ValueError(f"flux_difference: an AoS record needs a base "
                         f"aligned to its {cell_bytes}-byte cells")
    shape = RecordArray.storage_shape(EULER_SPEC, (nx, ny),
                                      state_haloed.layout)
    if out is None:
        dst = torch.empty(shape, dtype=state_haloed.dtype,
                          device=state_haloed.device)
    else:
        if not isinstance(out, RecordArray) or out.spec != EULER_SPEC \
                or out.layout is not state_haloed.layout:
            raise ValueError(f"flux_difference: out must be an "
                             f"{state_haloed.layout.name} EULER_SPEC "
                             f"record, got {out!r}")
        # the kernel reads neighbours' cells: out never aliases the input
        check_out(out.data, shape, state_haloed.dtype, state_haloed.device,
                  "flux_difference", apart=(state_haloed.data,))
        dst = out.data
    lib = _build.load("stencil", _SIGNATURES)
    with torch.cuda.device(state_haloed.device):
        code = getattr(lib, f"{fn}_{sfx}")(
            state_haloed.data.data_ptr(), dst.data_ptr(), nx, ny,
            LAYOUT_CODE[state_haloed.layout],
            round_to(lam_x, state_haloed.dtype),
            round_to(lam_y, state_haloed.dtype), geo.rows_per_strip,
            geo.warps_per_block, *geo.grid, stream_of(state_haloed.data))
    _build.check(lib, code, fn)
    if out is not None:
        return out
    return RecordArray(dst, EULER_SPEC, state_haloed.layout)


def flux_difference_cuda(state_haloed: RecordArray, lam_x, lam_y, *,
                         out: Optional[RecordArray] = None) -> RecordArray:
    """Sum of FORCE flux differences over both dims of a haloed AoS or SoA
    ``EULER_SPEC`` record on the GPU; λ rounded to the working dtype,
    arithmetic in float32, the result rounded once.  ``out``, a record of
    the interior's storage in the input's layout that lies apart from the
    input, receives it."""
    out = _launch("flux_difference", state_haloed, lam_x, lam_y, out)
    flux_difference_cuda.launches += 1
    return out


flux_difference_cuda.launches = 0


def flux_traffic_cuda(state_haloed: RecordArray) -> RecordArray:
    """K4's loads, shuffles and stores with a sum in place of the flux
    arithmetic, on the same geometry: the kernel's traffic alone, for
    timing.  Its result is no flux."""
    return _launch("flux_traffic", state_haloed, 1.0, 1.0)
