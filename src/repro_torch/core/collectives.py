"""Collectives over the axes of a :class:`Mesh` held by one process: the
port's counterparts of ``lax.psum``, ``pmax``, ``pmean``, ``all_gather``,
``ppermute``, the tiled ``all_to_all`` and the tiled ``psum_scatter``
that the JAX package calls inside ``shard_map``.

A value is one tensor per mesh coordinate (a shard), in the mesh's C
order: a list, or a :class:`ShardedArray` (its ``shards``).  Each function
returns a new list in that order.  ``axes`` names one mesh axis or a
tuple of them.  The shards that agree on every other axis form a group,
ordered by their coordinates along ``axes`` with the first named axis
outermost (as ``lax.axis_index`` counts over a tuple), and the
collective runs within each group.

One process drives every shard, so a function built on these cannot
pause in the middle of one shard's body for a collective the way a
``shard_map`` body does: it is written in stages over all shards, with
the collectives between the stages (``models/moe.py``'s
``make_moe_a2a``).

Reductions run left to right in group order, as XLA's CPU all-reduce
does, so they are bit for bit ``lax``'s there.  A block that goes to
another device is copied with ``halo._transfer``, whose backward reaches
its source.  On one device a block is read where it lies, and the shards
of a group that share a device share one result tensor of a reduction
or gather (treat results as read-only).  Everything is torch ops, so
autograd differentiates it: the backward of an ``all_to_all`` is the
reverse exchange, of a ``psum`` the sum of the cotangents.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from .halo import _transfer
from .mesh import Mesh, ShardedArray

__all__ = ["axis_groups", "axis_index", "axis_size", "to_device", "psum",
           "pmax", "pmean", "all_gather", "ppermute", "all_to_all",
           "psum_scatter"]

Axes = Union[str, Sequence[str]]


def _axes(mesh: Mesh, axes: Axes) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"mesh {mesh.shape} has no axis {a!r}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes repeat: {axes}")
    return axes


def axis_size(mesh: Mesh, axes: Axes) -> int:
    """The number of shards in a group over ``axes``."""
    return math.prod(mesh.shape[a] for a in _axes(mesh, axes))


def axis_index(mesh: Mesh, axes: Axes, index: int) -> int:
    """Device ``index``'s position in its group over ``axes``."""
    coords = dict(zip(mesh.axis_names, mesh.coords(index)))
    i = 0
    for a in _axes(mesh, axes):
        i = i * mesh.shape[a] + coords[a]
    return i


def axis_groups(mesh: Mesh, axes: Axes) -> list[list[int]]:
    """The device indices of every group over ``axes``, each ordered by
    :func:`axis_index`."""
    axes = _axes(mesh, axes)
    groups: dict[tuple, list] = {}
    for i in range(mesh.size):
        key = tuple(c for a, c in zip(mesh.axis_names, mesh.coords(i))
                    if a not in axes)
        groups.setdefault(key, []).append(i)
    return [sorted(g, key=lambda i: axis_index(mesh, axes, i))
            for g in groups.values()]


def _shards(xs, mesh: Mesh) -> list:
    if isinstance(xs, ShardedArray):
        if xs.mesh is not mesh:
            raise ValueError("the ShardedArray lies on another mesh")
        xs = xs.shards
    xs = list(xs)
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shards for a mesh of {mesh.size} "
                         f"devices")
    return xs


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: itself where it lies there, else a copy
    (``halo._transfer``, differentiable)."""
    return x if x.device == device else _transfer(x, device)


def _per_device(mesh: Mesh, group: list, make) -> dict:
    """``make(device)`` once for each device that holds a member of
    ``group`` -> {member: result}."""
    done: dict = {}
    out = {}
    for i in group:
        dev = mesh.devices[i]
        if dev not in done:
            done[dev] = make(dev)
        out[i] = done[dev]
    return out


def _fold(xs, mesh: Mesh, axes: Axes, op) -> list:
    xs = _shards(xs, mesh)
    out = [None] * mesh.size
    for group in axis_groups(mesh, axes):
        def make(dev, group=group):
            acc = to_device(xs[group[0]], dev)
            for j in group[1:]:
                acc = op(acc, to_device(xs[j], dev))
            return acc
        for i, r in _per_device(mesh, group, make).items():
            out[i] = r
    return out


def psum(xs, mesh: Mesh, axes: Axes) -> list:
    """Every shard gets the sum of its group's shards (``lax.psum``)."""
    return _fold(xs, mesh, axes, torch.add)


def pmax(xs, mesh: Mesh, axes: Axes) -> list:
    """Every shard gets the elementwise max of its group's shards
    (``lax.pmax``)."""
    return _fold(xs, mesh, axes, torch.maximum)


def pmean(xs, mesh: Mesh, axes: Axes) -> list:
    """The :func:`psum` divided by the group size (``lax.pmean``)."""
    n = axis_size(mesh, axes)
    return [s / n for s in psum(xs, mesh, axes)]


def all_gather(xs, mesh: Mesh, axes: Axes) -> list:
    """Every shard gets its group's shards in order, stacked on a new
    leading axis (``lax.all_gather``)."""
    xs = _shards(xs, mesh)
    out = [None] * mesh.size
    for group in axis_groups(mesh, axes):
        made = _per_device(mesh, group, lambda dev, group=group: torch.stack(
            [to_device(xs[j], dev) for j in group]))
        for i, r in made.items():
            out[i] = r
    return out


def ppermute(xs, mesh: Mesh, axes: Axes, perm) -> list:
    """Group position ``dst`` gets position ``src``'s shard for each
    ``(src, dst)`` of ``perm``; a position no pair sends to gets zeros
    (``lax.ppermute``).  A block on the receiver's device is not
    copied."""
    xs = _shards(xs, mesh)
    n = axis_size(mesh, axes)
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            not all(0 <= k < n for k in srcs + dsts):
        raise ValueError(f"ppermute over {axes} ({n} shards): {perm} is not "
                         f"a partial permutation of 0..{n - 1}")
    out = [None] * mesh.size
    for group in axis_groups(mesh, axes):
        for s, d in perm:
            dst = group[d]
            out[dst] = to_device(xs[group[s]], mesh.devices[dst])
    return [torch.zeros_like(x) if o is None else o for x, o in zip(xs, out)]


def _split_extent(xs: list, axes, n: int, dim: int, what: str) -> int:
    ext = xs[0].shape[dim]
    if ext % n:
        raise ValueError(f"{what} over {axes} ({n} shards): axis {dim} of "
                         f"extent {ext} is not divisible by {n}")
    return ext // n


def all_to_all(xs, mesh: Mesh, axes: Axes, split_axis: int,
               concat_axis: int) -> list:
    """The tiled ``lax.all_to_all``: each shard splits along
    ``split_axis`` into as many blocks as its group has shards, and group
    position ``j`` gets block ``j`` of every shard, concatenated along
    ``concat_axis`` in group order.  Its backward is the reverse
    exchange (``split_axis`` and ``concat_axis`` swapped)."""
    xs = _shards(xs, mesh)
    n = axis_size(mesh, axes)
    m = _split_extent(xs, axes, n, split_axis, "all_to_all")
    out = [None] * mesh.size
    for group in axis_groups(mesh, axes):
        for j, i in enumerate(group):
            dev = mesh.devices[i]
            out[i] = torch.cat(
                [to_device(xs[k].narrow(split_axis, j * m, m), dev)
                 for k in group], dim=concat_axis)
    return out


def psum_scatter(xs, mesh: Mesh, axes: Axes, *,
                 scatter_dimension: int = 0) -> list:
    """The tiled ``lax.psum_scatter``: group position ``j`` gets block
    ``j`` along ``scatter_dimension`` of the :func:`psum`, summed left
    to right as ``psum`` sums."""
    xs = _shards(xs, mesh)
    n = axis_size(mesh, axes)
    m = _split_extent(xs, axes, n, scatter_dimension, "psum_scatter")
    out = [None] * mesh.size
    for group in axis_groups(mesh, axes):
        for j, i in enumerate(group):
            dev = mesh.devices[i]
            blocks = [to_device(xs[k].narrow(scatter_dimension, j * m, m),
                                dev) for k in group]
            acc = blocks[0]
            for b in blocks[1:]:
                acc = acc + b
            out[i] = acc
    return out
