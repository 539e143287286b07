"""Halo (padding) cells on one process — paper §4.1/§5.4, local half.

Ripple tensors carry ``padding`` cells filled either from neighbouring
partitions or from a boundary policy (constant value, zero-gradient or
first-order extrapolation, periodic wrap).  This module holds the
boundary-policy half: every haloed axis is filled locally.  The exchange
between partitions (``torch.distributed`` sends of edge strips and the
two-phase corner hops) belongs to the multi-process executor and is not
here yet; a :class:`HaloAxis` naming a mesh axis raises
``NotImplementedError``.

Multi-axis fills follow the reference's transfer-schedule order: axis by
axis in list order, each axis filling the array already extended along the
earlier ones, so corner cells come from filling the earlier axes' halo
strips along the later axis.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

__all__ = [
    "Boundary",
    "HaloAxis",
    "exchange_multi",
    "pad_boundary_only",
    "unpad",
    "interior",
]

_MESH_ITEM = ("halo exchange between partitions is ROADMAP item 8 "
              "(halo exchange and the multi-process executor)")


class Boundary(enum.Enum):
    """Fill policy for halo cells at the global domain edge."""

    TRANSMISSIVE = "transmissive"  # constant (zero-gradient) extrapolation
    LINEAR = "linear"              # first-order extrapolation
    PERIODIC = "periodic"          # wrap around the global domain
    CONSTANT = "constant"          # fixed value


def _take(x: torch.Tensor, axis: int, start: int, size: int) -> torch.Tensor:
    return x.narrow(axis, start if start >= 0 else x.shape[axis] + start, size)


def _edge_fill(x: torch.Tensor, axis: int, width: int, side: str,
               boundary: Boundary, constant) -> torch.Tensor:
    """Halo block (``width`` cells) synthesized from the array's own edge."""
    if boundary is Boundary.CONSTANT:
        shape = list(x.shape)
        shape[axis] = width
        return torch.full(shape, constant, dtype=x.dtype, device=x.device)
    n = x.shape[axis]
    if side == "left":
        edge = _take(x, axis, 0, 1)
        nxt = _take(x, axis, 1, 1) if n > 1 else edge
        steps = torch.arange(width, 0, -1, device=x.device)
    else:
        edge = _take(x, axis, n - 1, 1)
        nxt = _take(x, axis, n - 2, 1) if n > 1 else edge
        steps = torch.arange(1, width + 1, device=x.device)
    reps = [1] * x.dim()
    reps[axis] = width
    tiled = edge.repeat(reps)
    if boundary is Boundary.TRANSMISSIVE:
        return tiled
    shape = [1] * x.dim()
    shape[axis] = width
    k = steps.reshape(shape).to(x.dtype)
    return tiled + k * (edge - nxt)   # LINEAR: edge + k * (edge - next_inner)


@dataclass(frozen=True)
class HaloAxis:
    """One haloed storage axis.  ``axis_name=None`` means the axis is not
    partitioned: its halo comes from the boundary policy."""

    axis: int
    width: int
    axis_name: Optional[str] = None


def _block_pair(x: torch.Tensor, a: HaloAxis, boundary: Boundary,
                constant) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) halo blocks of ``x`` along one unpartitioned axis."""
    if a.axis_name is not None:
        raise NotImplementedError(_MESH_ITEM)
    if boundary is Boundary.PERIODIC:
        n = x.shape[a.axis]
        # modular gather supports width > n (wraps several times)
        low = torch.arange(-a.width, 0, device=x.device) % n
        high = torch.arange(a.width, device=x.device) % n
        return (torch.index_select(x, a.axis, low),
                torch.index_select(x, a.axis, high))
    return (_edge_fill(x, a.axis, a.width, "left", boundary, constant),
            _edge_fill(x, a.axis, a.width, "right", boundary, constant))


def pad_boundary_only(x: torch.Tensor, *, axis: int, width: int,
                      boundary: Boundary = Boundary.TRANSMISSIVE,
                      constant: Any = 0.0) -> torch.Tensor:
    """Halo padding along an unpartitioned axis: both halos come from the
    boundary policy (PERIODIC wraps the array onto itself)."""
    if width == 0:
        return x
    low, high = _block_pair(x, HaloAxis(axis, width), boundary, constant)
    return torch.cat([low, x, high], dim=axis)


def exchange_multi(x: torch.Tensor, axes: Sequence[HaloAxis], *,
                   boundary: Boundary = Boundary.TRANSMISSIVE,
                   constant: Any = 0.0) -> torch.Tensor:
    """Extend ``x`` along every haloed axis, corners included — the local
    counterpart of the reference's transfer schedule, value-equal to it for
    axes with ``axis_name=None``."""
    for a in axes:
        if a.width:
            if a.axis_name is not None:
                raise NotImplementedError(_MESH_ITEM)
            x = pad_boundary_only(x, axis=a.axis, width=a.width,
                                  boundary=boundary, constant=constant)
    return x


def unpad(x: torch.Tensor, *, axis: int, width: int) -> torch.Tensor:
    """Strip ``width`` halo cells from both ends of ``axis``."""
    if width == 0:
        return x
    return _take(x, axis, width, x.shape[axis] - 2 * width)


def interior(x: torch.Tensor, *, axis: int, width: int) -> torch.Tensor:
    """The part of a shard whose stencil result needs no halo."""
    return unpad(x, axis=axis, width=width)
