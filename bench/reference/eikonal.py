"""Plain reference of the eikonal solve (paper Table 5, §7.4): level-set
reinitialisation of ``|grad phi| = 1`` on an ``n x n`` grid (h = 1/n) by
the Fast Iterative Method, as the paper's conditional MapReduce runs it.

One iteration: ``phi_prev <- phi``; pad ``phi`` by one cell, each edge
copied outwards (transmissive); cut the grid into ``block`` tiles, each
with its own copy of the halo ring it shares with its neighbours; run
``inner`` Jacobi sweeps of the Godunov upwind update on every tile with
its ring frozen and the sources pinned; put the interiors back; ``res =
max |phi - phi_prev|``.  Iterate while ``res > 0``.  Every sweep only
lowers ``phi``, so the loop ends.  The iteration count and the fixed
point both depend on the tiling, which is why the reference follows it.

The Godunov update (f = 1), each operation rounded to ``phi``'s dtype:

    a = min(phi_W, phi_E);  b = min(phi_S, phi_N)
    phi' = min(a, b) + h                      if |a - b| >= h
         = (a + b + sqrt(2 h^2 - (a-b)^2))/2  otherwise
    phi  = min(phi, phi')
"""

from __future__ import annotations

import torch


def godunov(tiles: torch.Tensor, mask: torch.Tensor, h) -> torch.Tensor:
    """One Jacobi sweep over ``(..., m+2, n+2)`` haloed tiles; returns the
    ``(..., m, n)`` interiors, sources (``mask``) unchanged."""
    h = torch.tensor(h, dtype=tiles.dtype, device=tiles.device)
    w, e = tiles[..., :-2, 1:-1], tiles[..., 2:, 1:-1]
    s, n = tiles[..., 1:-1, :-2], tiles[..., 1:-1, 2:]
    c = tiles[..., 1:-1, 1:-1]
    a = torch.minimum(w, e)
    b = torch.minimum(s, n)
    diff = torch.abs(a - b)
    quad = 0.5 * (a + b + torch.sqrt(torch.clamp(2.0 * h * h - diff * diff,
                                                 min=0.0)))
    new = torch.minimum(c, torch.where(diff >= h, torch.minimum(a, b) + h,
                                       quad))
    return torch.where(mask, c, new)


def iteration(phi: torch.Tensor, mask: torch.Tensor, h: float, inner: int,
              block: tuple) -> torch.Tensor:
    """One outer iteration (module docstring); returns the new ``phi``."""
    nx, ny = phi.shape
    bx, by = min(block[0], nx), min(block[1], ny)
    gx, gy = nx // bx, ny // by
    pad = torch.cat([phi[:1], phi, phi[-1:]], 0)
    pad = torch.cat([pad[:, :1], pad, pad[:, -1:]], 1).contiguous()
    sx, sy = pad.stride()
    tiles = pad.as_strided((gx, gy, bx + 2, by + 2),
                           (bx * sx, by * sy, sx, sy)).clone()
    m = mask.reshape(gx, bx, gy, by).permute(0, 2, 1, 3)
    for _ in range(inner):
        tiles[..., 1:-1, 1:-1] = godunov(tiles, m, h)
    return tiles[..., 1:-1, 1:-1].permute(0, 2, 1, 3).reshape(nx, ny)


def solve(phi: torch.Tensor, mask: torch.Tensor, *, inner: int,
          block: tuple, max_iters: int) -> tuple[torch.Tensor, int]:
    """Iterate from ``phi`` until no cell changes; returns the fixed point
    and the number of iterations, the last of which changed nothing.
    Raises past ``max_iters``.  ``phi``'s dtype is the working precision
    (the control passes bfloat16)."""
    n = phi.shape[0]
    h = 1.0 / n
    for it in range(1, max_iters + 1):
        new = iteration(phi, mask, h, inner, block)
        done = not bool((new != phi).any())
        phi = new
        if done:
            return phi, it
    raise RuntimeError(f"reference solve: still changing after "
                       f"{max_iters} iterations")
