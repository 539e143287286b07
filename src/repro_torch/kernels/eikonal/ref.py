"""Plain PyTorch version of the FIM kernel: identical block semantics
(frozen-halo inner sweeps per tile), plus a global-Jacobi reference used
for convergence testing.

The reference's oracle updates one tile after another in Python; here all
tiles are cut out at once into a ``(gx, gy, bx+2, by+2)`` batch (every tile
with its own copy of the halo it shares with its neighbours), swept
together, and their interiors put back, so a 4096^2 grid costs ``inner``
batched sweeps instead of 16,384 tile loops."""

from __future__ import annotations

import torch

from ...core.halo import Boundary, pad_boundary_only
from .._common import check_out
from .kernel import DEFAULT_BLOCK, clamp_block, godunov_update


def eikonal_fim_ref(phi_haloed: torch.Tensor, source_mask: torch.Tensor,
                    h: float, *, inner: int = 4, block=DEFAULT_BLOCK,
                    out=None) -> torch.Tensor:
    """``inner`` frozen-halo Jacobi sweeps per ``block`` tile of the
    haloed ``(nx+2, ny+2)`` ``phi``; returns the ``(nx, ny)`` interior,
    written into ``out`` when given (apart from both inputs, as the
    kernel wrapper takes it)."""
    nx, ny = (s - 2 for s in phi_haloed.shape)
    bx, by = clamp_block((nx, ny), block)
    gx, gy = nx // bx, ny // by
    p = phi_haloed.contiguous()
    sx, sy = p.stride()
    tiles = p.as_strided((gx, gy, bx + 2, by + 2),
                         (bx * sx, by * sy, sx, sy)).clone()
    mask = source_mask.reshape(gx, bx, gy, by).permute(0, 2, 1, 3)
    for _ in range(inner):
        tiles[..., 1:-1, 1:-1] = godunov_update(tiles, mask, h)
    res = tiles[..., 1:-1, 1:-1].permute(0, 2, 1, 3).reshape(nx, ny)
    if out is None:
        return res
    check_out(out, (nx, ny), phi_haloed.dtype, phi_haloed.device,
              "eikonal_fim", apart=(phi_haloed, source_mask))
    return out.copy_(res)


def eikonal_global_jacobi(phi: torch.Tensor, source_mask: torch.Tensor,
                          h: float, iters: int) -> torch.Tensor:
    """Whole-grid Jacobi iteration (transmissive edges) — convergence
    oracle: both block-FIM and this converge to the same viscosity
    solution (the distance field for f = 1)."""
    for _ in range(iters):
        pad = phi
        for ax in (0, 1):
            pad = pad_boundary_only(pad, axis=ax, width=1,
                                    boundary=Boundary.TRANSMISSIVE)
        phi = godunov_update(pad, source_mask, h)
    return phi
