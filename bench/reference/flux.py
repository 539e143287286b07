"""Plain reference of the marched FORCE scheme (paper Table 4, §8): the
2-D compressible Euler equations of an ideal gas (gamma = 1.4) on a
grid, the state held as four fields of conserved variables in the
order ``rho``, ``E``, ``rho u``, ``rho v`` (axis 0 of a ``(4, nx, ny)``
tensor; x along axis 1, y along axis 2).  Written from the equations
(Toro, "Riemann Solvers and Numerical Methods for Fluid Dynamics",
§7.4.2 and §16.8): nothing of the port is imported.

One step, with ``lam_x = dt / dx`` and ``lam_y = dt / dy``, is the mean
of two one-dimensional FORCE steps of ``2 dt``, one along x and one
along y:

    pressure   p = (gamma - 1) (E - (m_x^2 + m_y^2) / (2 rho))
    fluxes     F(U) = (m_x, (E + p) u, m_x u + p, m_y u),   u = m_x / rho
               G(U) = (m_y, (E + p) v, m_x v, m_y v + p),   v = m_y / rho
    pad        one cell on every side, each edge cell copied outwards
               (transmissive), corners included
    x faces    between each cell L and its neighbour R along x, with
               a = 2 lam_x:
               F_LF  = (F(U_L) + F(U_R)) / 2 - (U_R - U_L) / (2 a)
               U_RI  = (U_L + U_R) / 2 - a (F(U_R) - F(U_L)) / 2
               F_i+1/2 = (F_LF + F(U_RI)) / 2
               U_x = U - a (F_i+1/2 - F_i-1/2)
    y faces    the same with G and b = 2 lam_y: U_y
    update     U <- (U_x + U_y) / 2

Why the mean: the plain sum ``U - lam_x dF - lam_y dG`` of fluxes at
``lam_x`` and ``lam_y`` gives the grid's checkerboard mode the factor
``-1 - c_x^2 - c_y^2`` a step under linear advection (``c`` the Courant
numbers), so it grows at any step.  Each one-dimensional step is stable
while its Courant number ``2 lam s`` is at most 1, and the mean of two
stable steps is stable.

The initial state (:func:`shock_bubble`) is §8's Fig. 11 problem, built
here from its numbers.

Every operation runs in the input's dtype: the check passes float64,
the control bfloat16.  The corners of the pad are filled though the
five-point stencil never reads them.
"""

from __future__ import annotations

import torch

GAMMA = 1.4
RHO, EN, MX, MY = 0, 1, 2, 3


def pad(u: torch.Tensor) -> torch.Tensor:
    """``(4, nx, ny)`` -> ``(4, nx + 2, ny + 2)``: the transmissive halo,
    each edge cell copied outwards, the corners from the corner cells."""
    u = torch.cat([u[:, :1], u, u[:, -1:]], dim=1)
    return torch.cat([u[:, :, :1], u, u[:, :, -1:]], dim=2)


def pressure(u: torch.Tensor) -> torch.Tensor:
    """The ideal-gas pressure of each cell."""
    kinetic = (u[MX] * u[MX] + u[MY] * u[MY]) / (2 * u[RHO])
    return (GAMMA - 1) * (u[EN] - kinetic)


def physical_flux(u: torch.Tensor, axis: int) -> torch.Tensor:
    """F(U) (``axis`` 0, along x) or G(U) (``axis`` 1, along y)."""
    p = pressure(u)
    m = u[MX + axis]
    vel = m / u[RHO]
    out = torch.stack([m, (u[EN] + p) * vel, u[MX] * vel, u[MY] * vel])
    out[MX + axis] += p
    return out


def force_flux(left: torch.Tensor, right: torch.Tensor, axis: int,
               lam: float) -> torch.Tensor:
    """The FORCE flux of the faces between ``left`` and ``right`` (each
    ``(4, ...)``, neighbours along ``axis``): the mean of the
    Lax-Friedrichs flux and the flux of the Richtmyer state."""
    f_l, f_r = physical_flux(left, axis), physical_flux(right, axis)
    lax_friedrichs = (f_l + f_r) / 2 - (right - left) / (2 * lam)
    richtmyer = (left + right) / 2 - lam * (f_r - f_l) / 2
    return (lax_friedrichs + physical_flux(richtmyer, axis)) / 2


def one_dimensional_step(u: torch.Tensor, axis: int,
                         lam: float) -> torch.Tensor:
    """``U - lam (F_i+1/2 - F_i-1/2)`` along ``axis`` (0: x, 1: y), the
    faces' FORCE fluxes at ``lam``, from the ``(4, nx, ny)`` state."""
    p = pad(u)
    if axis == 0:
        rows = p[:, :, 1:-1]                   # the x neighbours of a row
        f = force_flux(rows[:, :-1], rows[:, 1:], 0, lam)  # nx + 1 faces
        return u - lam * (f[:, 1:] - f[:, :-1])
    cols = p[:, 1:-1]
    g = force_flux(cols[:, :, :-1], cols[:, :, 1:], 1, lam)
    return u - lam * (g[:, :, 1:] - g[:, :, :-1])


def step(u: torch.Tensor, lam_x: float, lam_y: float) -> torch.Tensor:
    """One step from the ``(4, nx, ny)`` state: the mean of the x and y
    one-dimensional steps of ``2 dt``."""
    return (one_dimensional_step(u, 0, 2 * lam_x)
            + one_dimensional_step(u, 1, 2 * lam_y)) / 2


def march(u: torch.Tensor, lam_x: float, lam_y: float,
          steps: int) -> torch.Tensor:
    """``steps`` steps of the scheme from ``u`` in ``u``'s dtype; returns
    the final state, ``u`` unchanged.  TF32 is turned off first: no
    operation here is a matrix product, but none may round to it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for _ in range(steps):
        u = step(u, lam_x, lam_y)
    return u


def wavespeed_sum(u: torch.Tensor, lam_x: float, lam_y: float) -> float:
    """``lam_x max(|u| + c) + lam_y max(|v| + c)`` over the grid, ``c`` the
    speed of sound, NaN where a cell's pressure or density went
    negative.  At most 0.5 keeps each one-dimensional step's Courant
    number ``2 lam s`` within 1."""
    u = u.double()
    c = torch.sqrt(GAMMA * pressure(u) / u[RHO])
    sx = (u[MX] / u[RHO]).abs() + c
    sy = (u[MY] / u[RHO]).abs() + c
    if torch.isnan(sx).any() or torch.isnan(sy).any():
        return float("nan")
    return lam_x * float(sx.max()) + lam_y * float(sy.max())


def shock_bubble(nx: int, ny: int, *, mach: float = 3.81,
                 dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Fig. 11's initial state on ``[0, 2] x [0, 1]`` as ``(4, nx, ny)``
    cell averages taken at the cell centres: gas at rest with ``rho = p
    = 1``, a bubble of ``rho = 0.1`` (same pressure) of radius 0.2 around
    ``(0.8, 0.5)``, and left of ``x = 0.3`` the gas behind a normal shock
    of Mach ``mach`` running to the right into the resting gas.  Behind
    the shock (Rankine-Hugoniot, ``M = mach``, ``g = gamma``):

        rho_s / rho = (g + 1) M^2 / ((g - 1) M^2 + 2)
        p_s / p     = (2 g M^2 - (g - 1)) / (g + 1)
        u_s         = M c (1 - rho / rho_s),   c = sqrt(g p / rho)
    """
    g, m2 = GAMMA, mach * mach
    rho_s = (g + 1) * m2 / ((g - 1) * m2 + 2)
    p_s = (2 * g * m2 - (g - 1)) / (g + 1)
    u_s = mach * (g ** 0.5) * (1 - 1 / rho_s)
    x = (torch.arange(nx, dtype=dtype, device=device) + 0.5) * (2 / nx)
    y = (torch.arange(ny, dtype=dtype, device=device) + 0.5) * (1 / ny)
    x, y = x[:, None].expand(nx, ny), y[None, :].expand(nx, ny)
    behind = x < 0.3
    in_bubble = (x - 0.8) ** 2 + (y - 0.5) ** 2 < 0.04

    def field(value_behind, value_bubble, value_rest):
        out = torch.full((nx, ny), value_rest, dtype=dtype, device=device)
        out[in_bubble] = value_bubble
        out[behind] = value_behind
        return out

    rho, p = field(rho_s, 0.1, 1.0), field(p_s, 1.0, 1.0)
    vel = field(u_s, 0.0, 0.0)
    return torch.stack([rho, p / (g - 1) + rho * vel * vel / 2, rho * vel,
                        torch.zeros_like(rho)])
