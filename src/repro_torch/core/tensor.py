"""N-dimensional distributed tensor handle (paper §4.1) on a device mesh.

A :class:`DistTensor` describes a logical space: its record spec and
polymorphic layout, per-dimension partitioning onto mesh axes,
per-dimension halo widths and the boundary policy.  The storage itself
lives in the executor's state dict: a ``torch.Tensor`` without a mesh (or
for a tensor that names no mesh axis), a
:class:`~repro_torch.core.mesh.ShardedArray` placed by :meth:`placement`
on a :class:`~repro_torch.core.mesh.Mesh` otherwise.

Paper mapping:
  * ``Tensor<double, 2> t({2, 2}, size_x, size_y)``  ->
    ``DistTensor("t", space=(sx, sy), partition=("gx", "gy"))``
  * padding parameter                                ->  ``halo`` widths.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import torch

from .device import resolve_device
from .halo import Boundary
from .layout import Layout, RecordArray, RecordSpec
from .mesh import Mesh, Placement, ShardedArray

__all__ = ["DistTensor", "ReductionResult", "make_reduction_result"]


@dataclass(frozen=True)
class DistTensor:
    """Handle for a partitioned, haloed, layout-polymorphic tensor.

    Example::

        mesh = make_mesh((4,), ("d",), devices=["cuda:0"] * 4)
        u = DistTensor("u", (1024, 1024), partition=("d",), halo=(1, 1),
                       boundary=Boundary.PERIODIC)
        p = DistTensor("p", (65536,), spec=RecordSpec.create("x", "y"),
                       layout=Layout.AOS, pin_layout=True)
    """

    name: str
    space: tuple[int, ...]
    dtype: Any = torch.float32
    spec: Optional[RecordSpec] = None          # None -> scalar cells
    layout: Layout = Layout.SOA
    pin_layout: bool = False                   # user pin: solver must honor
    partition: tuple[Optional[str], ...] = ()  # mesh axis per space dim
    halo: tuple[int, ...] = ()
    boundary: Boundary = Boundary.TRANSMISSIVE
    boundary_constant: float = 0.0
    subblocks: tuple[int, ...] = ()            # per-device sub-partition hint

    def __post_init__(self):
        nd = len(self.space)
        object.__setattr__(self, "space", tuple(self.space))
        part = tuple(self.partition) + (None,) * (nd - len(self.partition))
        object.__setattr__(self, "partition", part[:nd])
        h = tuple(self.halo) + (0,) * (nd - len(self.halo))
        object.__setattr__(self, "halo", h[:nd])

    @property
    def is_record(self) -> bool:
        """True when cells are records (``spec`` given) rather than scalars."""
        return self.spec is not None

    @property
    def is_partitioned(self) -> bool:
        """True when any space dim names a mesh axis."""
        return any(ax is not None for ax in self.partition)

    @property
    def storage_shape(self) -> tuple[int, ...]:
        """Shape of the backing tensor under the declared layout."""
        if not self.is_record:
            return self.space
        return RecordArray.storage_shape(self.spec, self.space, self.layout)

    def storage_axis(self, dim: int) -> int:
        """Storage axis for space dim (skips the SoA component axis)."""
        if not self.is_record or self.layout is Layout.AOS:
            return dim
        if self.layout is Layout.SOA:
            return dim + 1
        if dim == len(self.space) - 1:
            raise ValueError(
                f"{self.name}: AOSOA tiles the last space dim; halo/"
                f"per-axis ops are unsupported there")
        return dim

    # -- sharding ----------------------------------------------------------
    def pspec(self) -> tuple[Optional[str], ...]:
        """The mesh axis per *storage* axis (the component axis is never
        split): what a ``PartitionSpec`` says in the JAX package."""
        dims: list[Optional[str]] = list(self.partition)
        if self.is_record:
            if self.layout is Layout.AOS:
                dims = dims + [None]
            elif self.layout is Layout.SOA:
                dims = [None] + dims
            else:  # AOSOA: (*space[:-1], n_tiles, C, tile); the tiled dim
                # stays unsplit (validate_mesh enforces it)
                dims = dims[:-1] + [None, None, None]
        return tuple(dims)

    def placement(self, mesh: Mesh) -> Placement:
        """Which slice of this tensor's storage each mesh coordinate
        holds (the counterpart of a ``NamedSharding``)."""
        return Placement(mesh, self.pspec())

    def shards_along(self, mesh: Mesh, dim: int) -> int:
        """How many shards space dim ``dim`` splits into on ``mesh``."""
        ax = self.partition[dim]
        return 1 if ax is None else mesh.shape[ax]

    def shard_space(self, mesh: Mesh) -> tuple[int, ...]:
        """The per-shard space extents on ``mesh``."""
        return tuple(
            s // self.shards_along(mesh, d) for d, s in enumerate(self.space)
        )

    def validate_mesh(self, mesh: Mesh) -> None:
        """Raise ``ValueError`` when this handle cannot live on ``mesh``:
        unknown axis, non-divisible extent, shard smaller than its halo,
        or AoSoA carrying halo/partition on the tiled dim."""
        if self.is_record and self.layout is Layout.AOSOA:
            nd = len(self.space)
            if self.partition[nd - 1] is not None:
                raise ValueError(
                    f"{self.name}: AOSOA cannot be partitioned along the "
                    f"tiled (last) space dim")
            if self.halo[nd - 1]:
                raise ValueError(
                    f"{self.name}: AOSOA cannot carry a halo on the tiled "
                    f"(last) space dim")
        for d, ax in enumerate(self.partition):
            if ax is None:
                continue
            if ax not in mesh.shape:
                raise ValueError(f"{self.name}: mesh has no axis {ax!r}")
            n = mesh.shape[ax]
            if self.space[d] % n:
                raise ValueError(
                    f"{self.name}: space dim {d} ({self.space[d]}) not "
                    f"divisible by mesh axis {ax!r} ({n})"
                )
            if self.halo[d] and self.space[d] // n < self.halo[d]:
                raise ValueError(
                    f"{self.name}: shard extent {self.space[d] // n} smaller "
                    f"than halo {self.halo[d]} in dim {d}"
                )

    # -- materialization ---------------------------------------------------
    def init(self, device: Any = None, fill: float = 0.0,
             mesh: Optional[Mesh] = None):
        """Allocate storage filled with ``fill`` on ``device`` (``None``:
        the GPU, raising without one).  With a ``mesh``, a tensor that
        names a mesh axis is returned as its raw storage in shards (a
        :class:`~repro_torch.core.mesh.ShardedArray`, one on each mesh
        device); one that names none lies on the mesh's first device."""
        if mesh is not None:
            self.validate_mesh(mesh)
            if self.is_sharded(mesh):
                pl = self.placement(mesh)
                shape = pl.shard_shape(self.storage_shape)
                return ShardedArray(
                    [torch.full(shape, fill, dtype=self.dtype, device=d)
                     for d in mesh.devices], pl, self.storage_shape)
            device = mesh.devices[0]
        arr = torch.full(self.storage_shape, fill, dtype=self.dtype,
                         device=resolve_device(device))
        if self.is_record:
            return RecordArray(arr, self.spec, self.layout)
        return arr

    def is_sharded(self, mesh: Optional[Mesh]) -> bool:
        """True when this tensor's state on ``mesh`` is a ShardedArray:
        some space dim names a mesh axis."""
        return mesh is not None and self.is_partitioned

    def wrap(self, data: torch.Tensor) -> torch.Tensor | RecordArray:
        """View raw state storage through this handle (a RecordArray for
        record tensors, pass-through otherwise)."""
        if self.is_record:
            return RecordArray(data, self.spec, self.layout)
        return data

    def with_(self, **kw) -> "DistTensor":
        """A copy of this handle with fields replaced (handles are frozen)."""
        return replace(self, **kw)

    def storage_key(self) -> tuple:
        """Identity of the storage this handle refers to (halo widths and
        boundary policies are per-access and excluded)."""
        return (self.name, self.space, str(self.dtype), self.spec,
                self.layout, self.partition, self.subblocks)


@dataclass(frozen=True)
class ReductionResult:
    """Paper's ``ReductionResult<T>``: a named scalar slot in the executor
    state, filled by a reduce node."""

    name: str
    dtype: Any = torch.float32
    init: float = 0.0

    def value(self, state: dict) -> torch.Tensor:
        """The slot's current value in ``state``."""
        return state[self.name]


def make_reduction_result(name: str, init: float = 0.0,
                          dtype: Any = torch.float32) -> ReductionResult:
    """Declare a named reduction slot for ``Graph.reduce`` to fill.

    Example::

        total = make_reduction_result("total")
        g.then_reduce(t, total, SumReducer())   # state["total"] holds the sum
    """
    return ReductionResult(name=name, dtype=dtype, init=init)
