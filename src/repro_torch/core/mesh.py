"""A mesh of devices held by one process, and the sharded state on it.

The counterpart of ``jax.sharding.Mesh`` and of a ``NamedSharding``-placed
``jax.Array`` for a single controller: one :class:`Executor` drives every
device of a :class:`Mesh` (paper §5: one process over several GPUs and
their streams), so a partitioned state entry is a :class:`ShardedArray`,
one tensor per mesh coordinate, each on that coordinate's device.

* :func:`make_mesh` names the devices: ``cuda:0 … cuda:k-1`` by default,
  or any list (``["cuda:0"] * 4`` puts four shards on one card,
  ``["cpu"] * 8`` eight on the host).  A CUDA device that does not exist
  raises; nothing falls back to the CPU or shrinks the mesh.
* :class:`Placement` says which slice of a tensor's global storage each
  mesh coordinate holds: ``spec`` names a mesh axis (or ``None``) per
  storage axis, as a ``PartitionSpec`` does.  Mesh axes that a spec does
  not name replicate the shard.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

__all__ = ["Mesh", "make_mesh", "Placement", "ShardedArray"]


class Mesh:
    """A named grid of devices: ``shape`` maps axis name -> size (in
    order), ``devices`` holds one ``torch.device`` per mesh coordinate in
    C order over the axes.

    Example::

        mesh = make_mesh((2, 2), ("gx", "gy"), devices=["cuda:0"] * 4)
        mesh.coords(3)            # (1, 1)
        mesh.neighbour(0, "gy", +1, wrap=False)   # 1
    """

    def __init__(self, shape, devices: Sequence[Any]):
        self.shape: dict[str, int] = dict(shape)
        self.devices: tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if any(n < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axes must have size >= 1, got "
                             f"{self.shape}")
        if len(self.devices) != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} "
                             f"devices, got {len(self.devices)}")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"mesh devices mix types: "
                             f"{[str(d) for d in self.devices]}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        """The number of mesh coordinates (shards of a tensor partitioned
        over every axis)."""
        return math.prod(self.shape.values())

    def coords(self, index: int) -> tuple[int, ...]:
        """The mesh coordinate of device ``index`` (C order)."""
        out = []
        for n in reversed(list(self.shape.values())):
            out.append(index % n)
            index //= n
        return tuple(reversed(out))

    def index(self, coords: Sequence[int]) -> int:
        """The device index of a mesh coordinate (C order)."""
        i = 0
        for c, n in zip(coords, self.shape.values()):
            i = i * n + c
        return i

    def neighbour(self, index: int, axis_name: str, step: int,
                  wrap: bool) -> Optional[int]:
        """The device ``step`` places along ``axis_name`` from ``index``:
        wrapped around the axis when ``wrap``, else ``None`` past its
        ends."""
        axis = self.axis_names.index(axis_name)
        c = list(self.coords(index))
        n = self.shape[axis_name]
        j = c[axis] + step
        if not wrap and not 0 <= j < n:
            return None
        c[axis] = j % n
        return self.index(c)

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]})")


def _cuda_device(d: torch.device) -> torch.device:
    """``d`` with its index checked against the cards this machine has."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = d.index
    if index is None:
        if count == 0:
            raise RuntimeError(f"mesh device {d}: no CUDA device is "
                               f"available")
        index = torch.cuda.current_device()
    if not 0 <= index < count:
        raise RuntimeError(f"mesh device cuda:{index} does not exist: "
                           f"this machine has {count} CUDA device(s)")
    return torch.device("cuda", index)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axis_names``.

    ``devices=None`` means ``cuda:0 … cuda:k-1`` for a mesh of ``k``
    coordinates, and raises when the machine has fewer cards.  Several
    shards on one device are asked for explicitly, e.g.
    ``devices=["cuda:0"] * 4``; the CPU tests pass ``["cpu"] * 8``.
    Every CUDA device named must exist."""
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names "
                         f"{axis_names} differ in length")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axis names repeat: {axis_names}")
    k = math.prod(shape)
    if devices is None:
        count = torch.cuda.device_count() \
            if torch.cuda.is_available() else 0
        if count < k:
            raise RuntimeError(
                f"make_mesh{shape}: needs {k} CUDA devices, this machine "
                f"has {count}; pass devices= to place several shards on "
                f"one device (e.g. ['cuda:0'] * {k}, or ['cpu'] * {k})")
        devices = [f"cuda:{i}" for i in range(k)]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            d = _cuda_device(d)
        elif d.type != "cpu":
            raise ValueError(f"unsupported mesh device {d}")
        devs.append(d)
    return Mesh(zip(axis_names, shape), devs)


@dataclass(frozen=True)
class Placement:
    """Which slice of a global storage array each mesh coordinate holds:
    ``spec[i]`` is the mesh axis that splits storage axis ``i`` (``None``:
    not split).  The counterpart of a ``NamedSharding``."""

    mesh: Mesh
    spec: tuple[Optional[str], ...]

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of one shard of a global storage ``shape``."""
        return tuple(s if ax is None else s // self.mesh.shape[ax]
                     for s, ax in zip(shape, self.spec))

    def slices(self, shape: Sequence[int], index: int) -> tuple[slice, ...]:
        """The slice of a global storage ``shape`` that device ``index``
        holds."""
        coords = dict(zip(self.mesh.axis_names, self.mesh.coords(index)))
        out = []
        for s, ax in zip(shape, self.spec):
            if ax is None:
                out.append(slice(None))
            else:
                m = s // self.mesh.shape[ax]
                out.append(slice(coords[ax] * m, (coords[ax] + 1) * m))
        return tuple(out)

    def representatives(self) -> list[int]:
        """One device index per distinct shard: those at coordinate 0 on
        every mesh axis the spec does not name (the others hold
        replicas)."""
        named = {ax for ax in self.spec if ax is not None}
        return [i for i in range(self.mesh.size)
                if all(c == 0 for ax, c in zip(self.mesh.axis_names,
                                               self.mesh.coords(i))
                       if ax not in named)]


class ShardedArray:
    """One tensor per mesh coordinate, each on its device: the state value
    of a partitioned tensor.  ``shape`` is the global storage shape.

    Example::

        x = ShardedArray.from_global(torch.arange(16.), mesh, ("d",))
        x.shards[1]           # the second quarter, on mesh.devices[1]
        x.to_global()         # the whole array, on mesh.devices[0]
    """

    def __init__(self, shards: Sequence[torch.Tensor], placement: Placement,
                 shape: Sequence[int]):
        self.shards = tuple(shards)
        self.placement = placement
        self.shape = tuple(shape)
        if len(self.shards) != placement.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{placement.mesh.size} devices")

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The mesh's first device (where :meth:`to_global` gathers)."""
        return self.mesh.devices[0]

    @classmethod
    def from_global(cls, x: torch.Tensor, mesh: Mesh, spec) -> "ShardedArray":
        """Scatter a global tensor into shards: ``spec`` is a per-storage-
        axis tuple of mesh axes or a ``DistTensor`` (its ``pspec()``).
        Every shard is a copy on its device."""
        if hasattr(spec, "pspec"):
            spec = spec.pspec()
        placement = Placement(mesh, tuple(spec))
        x = torch.as_tensor(x)
        if x.dim() != len(placement.spec):
            raise ValueError(f"array of shape {tuple(x.shape)} for a "
                             f"{len(placement.spec)}-axis spec")
        for s, ax in zip(x.shape, placement.spec):
            if ax is not None and s % mesh.shape[ax]:
                raise ValueError(f"extent {s} not divisible by mesh axis "
                                 f"{ax!r} ({mesh.shape[ax]})")
        shards = []
        for i, dev in enumerate(mesh.devices):
            part = x[placement.slices(x.shape, i)]
            shards.append(torch.empty(part.shape, dtype=x.dtype,
                                      device=dev).copy_(part))
        return cls(shards, placement, x.shape)

    def to_global(self) -> torch.Tensor:
        """The whole array on the mesh's first device (a new tensor)."""
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        for i in self.placement.representatives():
            out[self.placement.slices(self.shape, i)] = self.shards[i]
        return out

    def map(self, fn, placement: Placement,
            shape: Sequence[int]) -> "ShardedArray":
        """``fn`` applied to every shard, the result placed by
        ``placement`` with global ``shape`` (a relayout changes both)."""
        return ShardedArray([fn(s) for s in self.shards], placement, shape)

    def __repr__(self):
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.placement.spec}, mesh={self.mesh})")
