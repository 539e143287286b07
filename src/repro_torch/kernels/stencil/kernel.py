"""FORCE flux-difference CUDA kernel (paper §7.3, Table 4) — wrapper of
``csrc/stencil.cu``.

K4 :func:`flux_difference_cuda` replaces ``flux_difference_pallas``
(``repro/kernels/stencil/kernel.py``): the FORCE flux difference summed
over both dims of a haloed 2-D Euler record (space ``(nx+2, ny+2)`` in,
``(nx, ny)`` out) with per-dim λ.  Each thread block stages its
halo-inclusive tile in shared memory (the paper's ``in_shared``).  AoS and
SoA are native; AoSoA is relayouted by the ops wrapper.

The kernel picks its own 16 x 32 tile and masks the ragged edge; the
reference's ``block`` contract (clamped to the interior, dividing it) is
kept by :func:`check_block`, so the same calls succeed and fail in both
packages.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.layout import Layout, RecordArray
from ...physics.euler import EULER_SPEC
from ...tuning.tiles import register_tile_kernel
from .. import _build
from .._common import LAYOUT_CODE, check_cuda_tensor, round_to, stream_of

SUPPORTED_LAYOUTS = (Layout.AOS, Layout.SOA)
PREFERRED_LAYOUT = Layout.SOA
TILE_KERNEL = "flux"
DEFAULT_BLOCK = (8, 128)
CUDA_TILE = (16, 32)   # cells per thread block, as in csrc/stencil.cu

_SIG = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_SIGNATURES = {"flux_difference_f32": _SIG, "flux_difference_bf16": _SIG}


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


def flux_difference_cuda(state_haloed: RecordArray, lam_x,
                         lam_y) -> RecordArray:
    """Sum of FORCE flux differences over both dims of a haloed AoS or SoA
    ``EULER_SPEC`` record on the GPU; λ rounded to the working dtype,
    arithmetic in float32."""
    sfx = check_cuda_tensor(state_haloed.data, "flux_difference")
    if state_haloed.spec != EULER_SPEC \
            or state_haloed.layout not in SUPPORTED_LAYOUTS \
            or len(state_haloed.space) != 2:
        raise ValueError(f"flux_difference: expects a 2-d AoS or SoA "
                         f"EULER_SPEC record, got {state_haloed!r}")
    nx, ny = (s - 2 for s in state_haloed.space)
    if nx < 1 or ny < 1:
        raise ValueError(f"flux_difference: empty interior ({nx}, {ny})")
    if -(-nx // CUDA_TILE[0]) > 65535:
        raise ValueError(f"flux_difference: nx={nx} exceeds the grid")
    out = torch.empty(
        RecordArray.storage_shape(EULER_SPEC, (nx, ny), state_haloed.layout),
        dtype=state_haloed.dtype, device=state_haloed.device)
    lib = _build.load("stencil", _SIGNATURES)
    with torch.cuda.device(state_haloed.device):
        code = getattr(lib, f"flux_difference_{sfx}")(
            state_haloed.data.data_ptr(), out.data_ptr(), nx, ny,
            LAYOUT_CODE[state_haloed.layout],
            round_to(lam_x, state_haloed.dtype),
            round_to(lam_y, state_haloed.dtype), stream_of(state_haloed.data))
    _build.check(lib, code, "flux_difference")
    flux_difference_cuda.launches += 1
    return RecordArray(out, EULER_SPEC, state_haloed.layout)


flux_difference_cuda.launches = 0
