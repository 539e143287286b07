"""Eikonal FIM CUDA kernel (paper §7.4, Table 5) — wrapper of
``csrc/eikonal.cu``.

Solves ``|grad phi| = 1/f`` (f = 1: signed-distance reinitialisation)
with the Fast Iterative Method.  K5 :func:`eikonal_fim_cuda` replaces
``eikonal_fim_pallas`` (``repro/kernels/eikonal/kernel.py``): each warp
keeps a strip of a halo-inclusive ``(bx, by)`` tile in registers and runs
``inner`` Jacobi sweeps on it with the halo frozen and the sources pinned
before writing the interior back (:func:`fim_geometry` says how tiles map
onto lanes, warps and blocks); the outer loop (a graph-level conditional
MapReduce with a convergence reduction) repeats until nothing changes.

The Godunov upwind update in 2-D (f = 1, grid step h):

    a = min(phi_W, phi_E);  b = min(phi_S, phi_N)
    phi' = min(a, b) + h                      if |a - b| >= h
         = (a + b + sqrt(2 h^2 - (a-b)^2))/2  otherwise
    phi  = min(phi, phi')   (monotone descent; sources pinned)
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ...tuning.tiles import register_tile_kernel
from .. import _build
from .._common import check_cuda_tensor, check_out, round_to, stream_of

TILE_KERNEL = "eikonal"   # name in the tile registry
DEFAULT_BLOCK = (8, 128)

_SIG = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_SIGNATURES = {"eikonal_fim_f32": _SIG, "eikonal_fim_bf16": _SIG}


def tile_candidates(shape: tuple[int, ...]) -> tuple[tuple[int, int], ...]:
    """Feasible ``(bx, by)`` FIM tile shapes for an interior of
    ``(nx, ny)`` cells.  Bigger tiles amortize the frozen-halo inner sweeps
    over more cells (the paper's ghost-zone trade); candidates tile the
    interior exactly."""
    nx, ny = shape
    return tuple((bx, by)
                 for bx in (8, 16, 32, 64) if bx <= nx and nx % bx == 0
                 for by in (64, 128, 256) if by <= ny and ny % by == 0)


register_tile_kernel(TILE_KERNEL, tile_candidates)


#: rows a warp holds, by the columns each lane holds: 16 cells a lane (32
#: at 8 columns), which fit in 64 registers (``RIPPLE_FIM_SHAPE`` in
#: ``csrc/eikonal.cu`` lists the kernel's instances)
ROWS_PER_WARP = {1: 16, 2: 8, 4: 4, 8: 4}
#: the kernel's budget: one register (and one bit of its ``live`` mask) per
#: cell and lane, at most 512 threads a block (so 128 registers a thread),
#: and the shared memory a block may take on an H100
MAX_CELLS_PER_LANE = 32
MAX_THREADS = 512
MAX_SMEM_BYTES = 232_448
#: warps a block holds when its tiles take fewer
BLOCK_WARPS = 8


class FimGeometry(NamedTuple):
    """How K5 maps ``(bx, by)`` tiles onto the card: lane ``l`` owns
    columns ``l * cols_per_lane + k`` (``k < cols_per_lane``) of the rows
    ``w * rows_per_warp + i`` of its tile, where ``w`` is its warp's index
    in the tile; a block holds ``tiles_per_block`` tiles stacked along dim
    0; block ``(gx, gy)`` of ``grid`` holds the tiles at column ``gx * by``
    and rows ``(gy * tiles_per_block + t) * bx``."""

    block: tuple[int, int]
    cols_per_lane: int
    rows_per_warp: int
    warps_per_tile: int
    tiles_per_block: int
    grid: tuple[int, int]

    @property
    def threads(self) -> int:
        return 32 * self.warps_per_tile * self.tiles_per_block

    @property
    def cells_per_lane(self) -> int:
        return self.cols_per_lane * self.rows_per_warp

    @property
    def smem_bytes(self) -> int:
        """Shared memory of a block: two buffers of every warp's first and
        last row, where warps share a tile."""
        if self.warps_per_tile == 1:
            return 0
        return 4 * 2 * self.tiles_per_block * self.warps_per_tile * 2 * 32 \
            * self.cols_per_lane


@functools.lru_cache(maxsize=64)
def fim_geometry(interior: tuple[int, int], block) -> FimGeometry:
    """K5's geometry for ``block`` tiles (clamped as :func:`clamp_block`
    does) of an ``(nx, ny)`` interior.  A tile the kernel has no instance
    for (``by`` above 256) still gets a geometry, which the launch
    refuses."""
    nx, ny = interior
    bx, by = clamp_block(interior, tuple(block))
    cpl = next((c for c in ROWS_PER_WARP if 32 * c >= by), -(-by // 32))
    rpw = ROWS_PER_WARP.get(cpl, 4)
    wpt = -(-bx // rpw)
    tiles_x = nx // bx
    tpb = 1
    while 2 * tpb * wpt <= BLOCK_WARPS and tiles_x % (2 * tpb) == 0:
        tpb *= 2
    return FimGeometry((bx, by), cpl, rpw, wpt, tpb,
                       (ny // by, tiles_x // tpb))


def godunov_update(phi: torch.Tensor, mask: torch.Tensor,
                   h: float) -> torch.Tensor:
    """One Jacobi sweep on haloed tiles; interior cells updated only.

    ``phi``: ``(..., m+2, n+2)``; ``mask``: ``(..., m, n)``, True where a
    source (pinned).  Returns the updated interiors ``(..., m, n)``, each
    operation rounded to ``phi``'s dtype as the reference's jnp ops are."""
    h = round_to(h, phi.dtype)
    w = phi[..., :-2, 1:-1]
    e = phi[..., 2:, 1:-1]
    s = phi[..., 1:-1, :-2]
    n = phi[..., 1:-1, 2:]
    c = phi[..., 1:-1, 1:-1]
    a = torch.minimum(w, e)
    b = torch.minimum(s, n)
    lo = torch.minimum(a, b)
    diff = torch.abs(a - b)
    two_hh = torch.tensor(2.0, dtype=phi.dtype, device=phi.device) * h * h
    quad = 0.5 * (a + b + torch.sqrt(torch.clamp(two_hh - diff * diff,
                                                 min=0.0)))
    new = torch.where(diff >= h, lo + h, quad)
    new = torch.minimum(c, new)
    return torch.where(mask, c, new)


def clamp_block(interior: tuple[int, int], block) -> tuple[int, int]:
    """The reference's tile contract: ``block`` clamped to the interior,
    which it must divide."""
    nx, ny = interior
    bx, by = min(block[0], nx), min(block[1], ny)
    if bx < 1 or by < 1 or nx % bx or ny % by:
        raise ValueError(f"interior {(nx, ny)} must tile by block "
                         f"{(bx, by)}")
    return bx, by


def eikonal_fim_cuda(phi_haloed: torch.Tensor, source_mask: torch.Tensor,
                     h: float, *, inner: int = 4, block=DEFAULT_BLOCK,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``inner`` FIM sweeps per ``block`` tile on the GPU, in registers.
    ``phi_haloed`` is a float32 or bfloat16 ``(nx+2, ny+2)`` tensor,
    ``source_mask`` a bool ``(nx, ny)`` tensor on the same device; returns
    the ``(nx, ny)`` interior.  ``h`` is rounded to the working dtype
    first; arithmetic is float32.  A tile the kernel cannot hold (``by``
    above 256, or more than 16 warps) or a negative ``inner`` is refused
    by the launch itself, as a CUDA "invalid argument" error.  ``out``, an
    ``(nx, ny)`` tensor apart from both inputs (tiles read their
    neighbours' halo cells), receives the interior."""
    sfx = check_cuda_tensor(phi_haloed, "eikonal_fim")
    if phi_haloed.dim() != 2 or min(phi_haloed.shape) < 3:
        raise ValueError(f"eikonal_fim: phi must be a haloed 2-d tensor, "
                         f"got shape {tuple(phi_haloed.shape)}")
    nx, ny = (s - 2 for s in phi_haloed.shape)
    if source_mask.dtype != torch.bool:
        raise TypeError(f"eikonal_fim: mask dtype {source_mask.dtype} is "
                        f"not bool")
    if source_mask.device != phi_haloed.device:
        raise ValueError(f"eikonal_fim: mask on {source_mask.device}, phi "
                         f"on {phi_haloed.device}")
    if tuple(source_mask.shape) != (nx, ny):
        raise ValueError(f"eikonal_fim: mask shape "
                         f"{tuple(source_mask.shape)} != interior "
                         f"{(nx, ny)}")
    if not source_mask.is_contiguous():
        raise ValueError("eikonal_fim: mask is not contiguous")
    geo = fim_geometry((nx, ny), tuple(block))
    if out is None:
        out = torch.empty((nx, ny), dtype=phi_haloed.dtype,
                          device=phi_haloed.device)
    else:
        check_out(out, (nx, ny), phi_haloed.dtype, phi_haloed.device,
                  "eikonal_fim", apart=(phi_haloed, source_mask))
    lib = _build.load("eikonal", _SIGNATURES)
    with torch.cuda.device(phi_haloed.device):
        code = getattr(lib, f"eikonal_fim_{sfx}")(
            phi_haloed.data_ptr(), source_mask.data_ptr(), out.data_ptr(),
            nx, ny, *geo.block, inner, round_to(h, phi_haloed.dtype),
            geo.cols_per_lane, geo.rows_per_warp, geo.warps_per_tile,
            geo.tiles_per_block, *geo.grid, stream_of(phi_haloed))
    _build.check(lib, code, "eikonal_fim")
    eikonal_fim_cuda.launches += 1
    return out


eikonal_fim_cuda.launches = 0
