"""Halo (padding) cells — paper §4.1/§5.4, on one process over a mesh.

Ripple tensors carry ``padding`` cells filled either from neighbouring
partitions (an inter-device copy) or from a boundary policy (constant
value, zero-gradient or first-order extrapolation, periodic wrap).  One
process holds every shard of a partitioned tensor (``core/mesh.py``), so
where the JAX package's shard receives a halo block by ``lax.ppermute``,
here the block is a copy of the neighbour shard's edge strip onto this
shard's device (a device-to-device copy; a peer copy between two cards),
with periodic wrap between the first and last shard and the boundary
policy at the global edges.  A :class:`HaloAxis` with ``axis_name=None``
is filled locally from the policy, so fill-only schedules need no mesh.

Multi-axis halos are a *transfer schedule* over blocks keyed by which
sides of which axes they extend (paper §5.4's scheduling across a
multi-dimensional space):

* phase 1 — every axis's edge strips leave at once (independent copies
  from the unextended shards);
* phase p — corner/vertex blocks: each phase-(p-1) block's edge along a
  later axis travels one more hop (the two-phase extended-edge exchange,
  so diagonal neighbours never talk directly);
* :func:`assemble_region` stitches any rectangular region of a shard's
  extended array from its blocks — the whole padded shard for the
  synchronous lowering, a boundary strip's input for the overlapped one.

No copy depends on compute (phase p reads only phase p-1's blocks), so
the executor starts them all on a copy stream while the interior program
runs.  The multi-shard functions take the shards as a sequence in mesh
order (C order over the mesh axes) and return per-shard results;
:func:`exchange_blocks` trips the ``halo.block`` fault site once per
scheduled block, as the JAX package does.  :func:`schedule_blocks` is the
static (shape-level) description of the same schedule, which the plan
uses for per-block byte accounting.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from ..runtime.faults import trip as _fault_trip
from .mesh import Mesh

__all__ = [
    "Boundary",
    "HaloAxis",
    "exchange",
    "exchange_blocks",
    "exchange_multi",
    "assemble_region",
    "block_shape",
    "iter_block_keys",
    "schedule_blocks",
    "halo_blocks",
    "pad_boundary_only",
    "unpad",
    "interior",
]


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
    left = side == "left"
    edge = _take(x, axis, 0 if left else n - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = width
    tiled = edge.repeat(reps)
    if boundary is Boundary.TRANSMISSIVE:
        return tiled
    nxt = _take(x, axis, 1 if left else n - 2, 1) if n > 1 else edge
    steps = (torch.arange(width, 0, -1, device=x.device) if left
             else torch.arange(1, width + 1, device=x.device))
    shape = [1] * x.dim()
    shape[axis] = width
    k = steps.reshape(shape).to(x.dtype)
    return tiled + k * (edge - nxt)   # LINEAR: edge + k * (edge - next_inner)


def _transfer(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``x`` on ``device`` — the block a neighbour sends: on the
    current stream, and on one card a device-to-device copy."""
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(
        x, non_blocking=True)


def halo_blocks(shards: Sequence[torch.Tensor], mesh: Mesh, *, axis: int,
                width: int, axis_name: str,
                boundary: Boundary = Boundary.TRANSMISSIVE,
                constant: Any = 0.0) -> tuple[list, list]:
    """The (low, high) halo blocks every shard receives along storage
    ``axis`` over mesh axis ``axis_name``, NOT yet concatenated: per shard,
    a copy of the low neighbour's last ``width`` cells and of the high
    neighbour's first, or the boundary policy's fill at a global edge
    (``PERIODIC`` wraps between the first and last shard).  Exposing the
    blocks separately lets the executor overlap the copies with interior
    compute (paper Fig. 7)."""
    wrap = boundary is Boundary.PERIODIC
    lows, highs = [], []
    for i, x in enumerate(shards):
        lo_src = mesh.neighbour(i, axis_name, -1, wrap)
        hi_src = mesh.neighbour(i, axis_name, +1, wrap)
        if lo_src is None:
            lows.append(_edge_fill(x, axis, width, "left", boundary,
                                   constant))
        else:
            src = shards[lo_src]
            lows.append(_transfer(
                _take(src, axis, src.shape[axis] - width, width), x.device))
        if hi_src is None:
            highs.append(_edge_fill(x, axis, width, "right", boundary,
                                    constant))
        else:
            highs.append(_transfer(_take(shards[hi_src], axis, 0, width),
                                   x.device))
    return lows, highs


def exchange(shards: Sequence[torch.Tensor], mesh: Mesh, *, axis: int,
             width: int, axis_name: str,
             boundary: Boundary = Boundary.TRANSMISSIVE,
             constant: Any = 0.0) -> list[torch.Tensor]:
    """Every shard extended by ``width`` cells on both sides of storage
    ``axis``: interior halos copied from the neighbours along mesh axis
    ``axis_name``, global-edge halos from the boundary policy."""
    if width == 0:
        return list(shards)
    lows, highs = halo_blocks(shards, mesh, axis=axis, width=width,
                              axis_name=axis_name, boundary=boundary,
                              constant=constant)
    return [torch.cat([lo, x, hi], dim=axis)
            for lo, x, hi in zip(lows, shards, highs)]


def pad_boundary_only(x: torch.Tensor, *, axis: int, width: int,
                      boundary: Boundary = Boundary.TRANSMISSIVE,
                      constant: Any = 0.0) -> torch.Tensor:
    """Halo padding along an unpartitioned axis: both halos come from the
    boundary policy (PERIODIC wraps the array onto itself)."""
    if width == 0:
        return x
    low, high = _local_pair(x, HaloAxis(axis, width), boundary, constant)
    return torch.cat([low, x, high], dim=axis)


# -- multi-axis transfer schedule ---------------------------------------------

@dataclass(frozen=True)
class HaloAxis:
    """One haloed storage axis of a shard's block schedule.

    ``axis_name=None`` means the axis is not mesh-partitioned: its halo
    comes from the boundary policy (a local fill, no transfer)."""

    axis: int                       # storage axis
    width: int
    axis_name: Optional[str] = None  # mesh axis; None -> local fill


# A block key identifies which sides of which axes a block extends: a
# tuple of (axis_list_index, 'low'|'high') pairs with strictly ascending
# indices.  () is the shard itself; ((0,'low'),) its low edge strip along
# axes[0]; ((0,'low'),(1,'high')) the corner beyond both.
BlockKey = tuple


def iter_block_keys(axes: Sequence[HaloAxis]):
    """Yield ``(phase, key)`` for every block the schedule transfers.

    Phase 1 keys are the per-axis edge strips (sent from the unextended
    shard, all independent); phase p keys extend a phase-(p-1) block along
    a strictly later axis — the extended-edge exchange that routes corner
    data through face neighbours.  Zero-width axes contribute nothing.
    """
    frontier: list[BlockKey] = [()]
    phase = 0
    while frontier:
        phase += 1
        nxt: list[BlockKey] = []
        for key in frontier:
            start = key[-1][0] + 1 if key else 0
            for j in range(start, len(axes)):
                if axes[j].width == 0:
                    continue
                for side in ("low", "high"):
                    k = key + ((j, side),)
                    yield phase, k
                    nxt.append(k)
        frontier = nxt


def schedule_blocks(shape: Sequence[int], axes: Sequence[HaloAxis]):
    """Yield ``(phase, key, block_shape)`` for every transfer block of a
    shard of ``shape`` — the static, shape-level description of the
    schedule :func:`exchange_blocks` executes (``HaloTransfer.nbytes``)."""
    for phase, key in iter_block_keys(axes):
        yield phase, key, block_shape(shape, axes, key)


def block_shape(shape: Sequence[int], axes: Sequence[HaloAxis],
                key: BlockKey) -> tuple[int, ...]:
    """Shape of the halo block ``key`` for a shard of ``shape``: ``width``
    cells thick along every axis the key extends, the shard's extent along
    every other axis."""
    out = list(shape)
    for j, _side in key:
        out[axes[j].axis] = axes[j].width
    return tuple(out)


def _local_pair(x: torch.Tensor, a: HaloAxis, boundary: Boundary,
                constant) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) halo blocks of ``x`` along an unpartitioned axis, from
    the boundary policy."""
    if boundary is Boundary.PERIODIC:
        n = x.shape[a.axis]
        # modular gather supports width > n (wraps several times)
        low = torch.arange(-a.width, 0, device=x.device) % n
        high = torch.arange(a.width, device=x.device) % n
        return (torch.index_select(x, a.axis, low),
                torch.index_select(x, a.axis, high))
    return (_edge_fill(x, a.axis, a.width, "left", boundary, constant),
            _edge_fill(x, a.axis, a.width, "right", boundary, constant))


def _block_pairs(xs: Sequence[torch.Tensor], a: HaloAxis,
                 mesh: Optional[Mesh], boundary: Boundary,
                 constant) -> tuple[list, list]:
    """Per shard, the (low, high) blocks along one axis: neighbour copies
    for a partitioned axis, boundary-policy fills otherwise."""
    if a.axis_name is None:
        pairs = [_local_pair(x, a, boundary, constant) for x in xs]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return halo_blocks(xs, mesh, axis=a.axis, width=a.width,
                       axis_name=a.axis_name, boundary=boundary,
                       constant=constant)


def _as_shards(x, axes: Sequence[HaloAxis], mesh: Optional[Mesh]):
    """``(shards, single)``: a tensor is one shard of no mesh."""
    if isinstance(x, torch.Tensor):
        if any(a.axis_name is not None and a.width for a in axes):
            raise ValueError(
                "a HaloAxis names a mesh axis: pass the shards of every "
                "mesh coordinate (a sequence in mesh order) and the mesh")
        return [x], True
    shards = list(x)
    if mesh is None or len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards need the mesh they lie on "
                         f"(got {mesh})")
    return shards, False


def exchange_blocks(x, axes: Sequence[HaloAxis], *,
                    boundary: Boundary = Boundary.TRANSMISSIVE,
                    constant: Any = 0.0, mesh: Optional[Mesh] = None):
    """Run the transfer schedule: every block of :func:`iter_block_keys`,
    plus the shard itself under ``()``.

    ``x`` is a tensor (every axis fill-only; returns its block dict) or
    the shards of every mesh coordinate in mesh order with their ``mesh``
    (returns one block dict per shard).  All phase-1 copies read the
    shards directly and phase p reads only phase p-1's blocks, so nothing
    here waits on compute.  Value-equal to the sequential per-axis
    exchange-then-concatenate chain (fills commute with earlier-axis
    extension because they act pointwise along the filled axis)."""
    shards, single = _as_shards(x, axes, mesh)
    blocks = [{(): s} for s in shards]
    frontier: list[BlockKey] = [()]
    while frontier:
        nxt: list[BlockKey] = []
        for key in frontier:
            start = key[-1][0] + 1 if key else 0
            for j in range(start, len(axes)):
                a = axes[j]
                if a.width == 0:
                    continue
                # fault injection point: one scheduled halo block, before
                # any of its copies starts
                _fault_trip("halo.block",
                            detail=f"axis{j}:{a.axis_name or 'fill'}")
                lows, highs = _block_pairs([b[key] for b in blocks], a,
                                           mesh, boundary, constant)
                for b, lo, hi in zip(blocks, lows, highs):
                    b[key + ((j, "low"),)] = lo
                    b[key + ((j, "high"),)] = hi
                nxt += [key + ((j, "low"),), key + ((j, "high"),)]
        frontier = nxt
    return blocks[0] if single else blocks


def assemble_region(blocks: dict, axes: Sequence[HaloAxis],
                    ranges: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Stitch one rectangular region of a shard's extended array from its
    ``blocks``.

    ``ranges[i]`` is the half-open extent along ``axes[i].axis`` in
    *extended* coordinates: ``[0, w)`` is the low halo zone, ``[w, w+m)``
    the shard, ``[w+m, w+2w+m)`` the high halo zone.  Full ranges
    reproduce the whole extended shard; sub-ranges cut exactly the input
    a boundary-strip program needs without touching unrelated blocks.  A
    region inside one block is a view of it (no copy); any other is one
    new tensor, each block's part copied into place once.
    """
    x = blocks[()]
    shape = list(x.shape)
    for a, (lo, hi) in zip(axes, ranges):
        shape[a.axis] = hi - lo
    # (block key, [(axis, start, size)] cut from the block, where it goes:
    # [(axis, offset)] in the region)
    pieces: list[tuple[BlockKey, list, list]] = []

    def rec(idx: int, key: BlockKey, cuts: list, offs: list) -> None:
        if idx == len(axes):
            pieces.append((key, cuts, offs))
            return
        a = axes[idx]
        lo, hi = ranges[idx]
        m = x.shape[a.axis]
        base = a.width + m
        zones = [(key + ((idx, "low"),), 0, a.width),    # low halo zone
                 (key, a.width, base),                    # the shard
                 (key + ((idx, "high"),), base, base + a.width)]
        pos = 0
        for k, z_lo, z_hi in zones:
            start, end = max(lo, z_lo), min(hi, z_hi)
            if start >= end:
                continue
            cut = cuts if (start, end) == (z_lo, z_hi) else \
                cuts + [(a.axis, start - z_lo, end - start)]
            rec(idx + 1, k, cut, offs + [(a.axis, pos)])
            pos += end - start
        if pos == 0:
            raise ValueError(f"empty region range {ranges[idx]} on axis "
                             f"{a.axis}")

    rec(0, (), [], [])

    def cut(key, cuts):
        out = blocks[key]
        for ax, start, size in cuts:
            out = _take(out, ax, start, size)
        return out

    if len(pieces) == 1:
        return cut(*pieces[0][:2])
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    for key, cuts, offs in pieces:
        src = cut(key, cuts)
        dst = out
        for ax, off in offs:
            dst = dst.narrow(ax, off, src.shape[ax])
        dst.copy_(src)
    return out


def exchange_multi(x, axes: Sequence[HaloAxis], *,
                   boundary: Boundary = Boundary.TRANSMISSIVE,
                   constant: Any = 0.0, mesh: Optional[Mesh] = None):
    """Extend a tensor (fill-only axes) or every shard of a mesh along
    every haloed axis at once via the transfer schedule, corners
    included.  Value-equal to chaining :func:`exchange` /
    :func:`pad_boundary_only` per axis in list order."""
    axes = [a for a in axes if a.width]
    if not axes:
        return x if isinstance(x, torch.Tensor) else list(x)
    blocks = exchange_blocks(x, axes, boundary=boundary, constant=constant,
                             mesh=mesh)

    def full(b):
        s = b[()]
        return assemble_region(
            b, axes, [(0, s.shape[a.axis] + 2 * a.width) for a in axes])

    if isinstance(blocks, dict):
        return full(blocks)
    return [full(b) for b in blocks]


def unpad(x: torch.Tensor, *, axis: int, width: int) -> torch.Tensor:
    """Strip ``width`` halo cells from both ends of ``axis``."""
    if width == 0:
        return x
    return _take(x, axis, width, x.shape[axis] - 2 * width)


def interior(x: torch.Tensor, *, axis: int, width: int) -> torch.Tensor:
    """The part of a shard whose stencil result needs no halo."""
    return unpad(x, axis=axis, width=width)
