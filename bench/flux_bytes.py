"""The yardstick's arithmetic for the finite-volume cells (paper Table
4): the bytes and operations that K4 and a whole marched step need,
counted from the grid's shape whatever implements them, as
``roofline.py`` counts the other cells'.  Each input byte is counted
read once and each output byte written once."""

from __future__ import annotations

from .roofline import F32

FIELDS = 4
# operations of one FORCE face flux as the plain version writes it
# (physics/euler.py force_flux): three physical fluxes of 13 each, 2 for
# the lambda factors, 10 a component for the Lax-Friedrichs flux and the
# Richtmyer state, 2 a component to average (chip_smoke.OPS_PER_FACE)
OPS_PER_FACE = 3 * 13 + 2 + 4 * 10 + 4 * 2
# per cell: lam (F+ - F-) per dim and component, and the sum of the dims
OPS_PER_CELL = 2 * 4 * 2 + 4


def k4_bytes(nx: int, ny: int) -> int:
    """K4 over an ``nx x ny`` grid: the padded ``u`` read, ``du`` written,
    four float32 fields each."""
    return FIELDS * F32 * ((nx + 2) * (ny + 2) + nx * ny)


def k4_ops(nx: int, ny: int) -> int:
    """K4's operations: each unique face once, then each cell's sum."""
    faces = (nx + 1) * ny + nx * (ny + 1)
    return faces * OPS_PER_FACE + nx * ny * OPS_PER_CELL


def step_bytes(nx: int, ny: int) -> int:
    """What one marched step needs: ``u`` read and written once; the
    padded copy and ``du`` are the implementation's."""
    return 2 * FIELDS * F32 * nx * ny
