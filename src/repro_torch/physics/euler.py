"""2-D compressible Euler equations + FORCE flux (Toro) — paper §7.3/§8.

State is a 4-component record over the grid: conserved variables ``rho``
(density), ``E`` (total energy), ``mom`` (momentum vector, 2).  All
functions operate on a *stacked* component-major tensor ``U`` of shape
``(4, *space)`` — the SoA storage of the record, so the SoA path is
zero-copy while AoS pays a transpose.

These are plain PyTorch functions in the working dtype of their input; the
CUDA flux kernel (``csrc/stencil.cu``) evaluates the same formulas per cell
in float32.
"""

from __future__ import annotations

import math

import torch

from ..core.device import resolve_device
from ..core.layout import Layout, RecordArray, RecordSpec, Vector, relayout

GAMMA = 1.4

EULER_SPEC = RecordSpec.create("rho", "E", Vector("mom", 2))

RHO, EN, MX, MY = 0, 1, 2, 3


def stack_state(state: RecordArray) -> torch.Tensor:
    """(4, *space) component-major view of an Euler state record
    (AoS/SoA are views, AoSoA relayouts)."""
    if state.layout is Layout.SOA:
        return state.data
    if state.layout is Layout.AOS:
        return torch.movedim(state.data, -1, 0)
    return relayout(state, Layout.SOA).data


def unstack_state(U: torch.Tensor, like: RecordArray) -> RecordArray:
    """A record in ``like``'s layout holding the stacked state ``U``."""
    if like.layout is Layout.SOA:
        return RecordArray(U, like.spec, Layout.SOA)
    if like.layout is Layout.AOS:
        return RecordArray(torch.movedim(U, 0, -1).contiguous(), like.spec,
                           Layout.AOS)
    return relayout(RecordArray(U, like.spec, Layout.SOA), like.layout)


def pressure(U: torch.Tensor) -> torch.Tensor:
    """Ideal-gas pressure ``(gamma-1) (E - |m|^2 / (2 rho))``."""
    ke = 0.5 * (U[MX] ** 2 + U[MY] ** 2) / U[RHO]
    return (GAMMA - 1.0) * (U[EN] - ke)


def sound_speed(U: torch.Tensor) -> torch.Tensor:
    """Speed of sound ``sqrt(gamma p / rho)``."""
    return torch.sqrt(GAMMA * pressure(U) / U[RHO])


def max_wavespeed(U: torch.Tensor) -> torch.Tensor:
    """max(|u_d| + c) over the grid — sets the CFL time step."""
    c = sound_speed(U)
    sx = torch.abs(U[MX] / U[RHO]) + c
    sy = torch.abs(U[MY] / U[RHO]) + c
    return torch.maximum(sx.max(), sy.max())


def flux(U: torch.Tensor, dim: int) -> torch.Tensor:
    """Physical flux along grid dim (0=x, 1=y) of the stacked state."""
    p = pressure(U)
    m_d = U[MX + dim]
    u_d = m_d / U[RHO]
    return torch.stack(
        [
            m_d,
            (U[EN] + p) * u_d,
            U[MX] * u_d + (p if dim == 0 else 0.0),
            U[MY] * u_d + (p if dim == 1 else 0.0),
        ],
        dim=0,
    )


def force_flux(UL: torch.Tensor, UR: torch.Tensor, dim: int,
               lam) -> torch.Tensor:
    """FORCE flux (first-ORder CEntred, Toro): mean of Lax-Friedrichs and
    Richtmyer fluxes at the interface.  ``lam = dt / dx``."""
    FL, FR = flux(UL, dim), flux(UR, dim)
    f_lf = 0.5 * (FL + FR) - 0.5 / lam * (UR - UL)
    u_rm = 0.5 * (UL + UR) - 0.5 * lam * (FR - FL)
    return 0.5 * (f_lf + flux(u_rm, dim))


def _shift(U: torch.Tensor, dim: int, off: int, n: int) -> torch.Tensor:
    """Slice of length n starting at ``off`` along space dim (axis dim+1)."""
    return U.narrow(dim + 1, off, n)


def flux_difference_dim(U_haloed: torch.Tensor, dim: int, lam) -> torch.Tensor:
    """lam * (F_{i+1/2} - F_{i-1/2}) along ``dim``; input haloed by 1 in
    ``dim`` only."""
    n = U_haloed.shape[dim + 1] - 2
    Um = _shift(U_haloed, dim, 0, n + 1)
    Up = _shift(U_haloed, dim, 1, n + 1)
    F = force_flux(Um, Up, dim, lam)       # n+1 faces
    return lam * (_shift(F, dim, 1, n) - _shift(F, dim, 0, n))


def flux_difference(U_haloed: torch.Tensor, lam_x, lam_y) -> torch.Tensor:
    """Sum of directional flux differences (paper Table 4 kernel).

    Input haloed by 1 in BOTH space dims: shape (4, nx+2, ny+2)."""
    dx = flux_difference_dim(U_haloed[:, :, 1:-1], 0, lam_x)
    dy = flux_difference_dim(U_haloed[:, 1:-1, :], 1, lam_y)
    return dx + dy


def update_dim(U_haloed: torch.Tensor, dim: int, lam) -> torch.Tensor:
    """Dimension-split FORCE update U' = U - lam (F_+ - F_-); haloed by 1
    in ``dim`` only."""
    n = U_haloed.shape[dim + 1] - 2
    return _shift(U_haloed, dim, 1, n) - flux_difference_dim(U_haloed, dim,
                                                             lam)


def update_full(U_haloed: torch.Tensor, lam_x, lam_y) -> torch.Tensor:
    """Unsplit FORCE update U' = U - lam_x dF_x - lam_y dF_y, haloed by 1
    in both space dims: (4, m+2, n+2) -> (4, m, n)."""
    center = U_haloed[:, 1:-1, 1:-1]
    return center - flux_difference(U_haloed, lam_x, lam_y)


def shock_bubble_init(nx: int, ny: int, *, mach: float = 3.81,
                      device=None) -> torch.Tensor:
    """Initial conditions: Mach-3.81 shock hitting a low-density bubble
    (paper Fig. 11), on [0,2]x[0,1]; float32 of shape (4, nx, ny) on
    ``device`` (``None``: the GPU, raising without one)."""
    f32 = torch.float32
    device = resolve_device(device)
    x = (torch.arange(nx, dtype=f32, device=device) + 0.5) * (2.0 / nx)
    y = (torch.arange(ny, dtype=f32, device=device) + 0.5) * (1.0 / ny)
    X, Y = torch.meshgrid(x, y, indexing="ij")

    rho = torch.ones((nx, ny), dtype=f32, device=device)
    p = torch.ones((nx, ny), dtype=f32, device=device)
    u = torch.zeros((nx, ny), dtype=f32, device=device)
    v = torch.zeros((nx, ny), dtype=f32, device=device)

    # low-density bubble at (0.8, 0.5), r = 0.2
    bubble = (X - 0.8) ** 2 + (Y - 0.5) ** 2 < 0.2**2
    rho = torch.where(bubble, 0.1, rho)

    # post-shock state (left of x = 0.3), normal shock relations, Ms = mach
    ms, g = mach, GAMMA
    rho_r, p_r = 1.0, 1.0
    p_l = p_r * (2 * g * ms**2 - (g - 1)) / (g + 1)
    rho_l = rho_r * ((g + 1) * ms**2) / ((g - 1) * ms**2 + 2)
    c_r = math.sqrt(g * p_r / rho_r)
    u_l = ms * c_r * (1 - rho_r / rho_l)
    shock = X < 0.3
    rho = torch.where(shock, rho_l, rho)
    p = torch.where(shock, p_l, p)
    u = torch.where(shock, u_l, u)

    E = p / (GAMMA - 1.0) + 0.5 * rho * (u**2 + v**2)
    return torch.stack([rho, E, rho * u, rho * v], dim=0)
