"""N-dimensional tensor handle (paper §4.1) for the single-process executor.

A :class:`DistTensor` describes a logical space: its record spec and
polymorphic layout, per-dimension partitioning, per-dimension halo widths
and the boundary policy.  The storage itself is a ``torch.Tensor`` in the
executor's state dict.  ``partition`` is kept as a plain tuple of axis
names; the single-process executor refuses a partitioned axis (placement
over several GPUs is ROADMAP item 8).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import torch

from .device import resolve_device
from .halo import Boundary
from .layout import Layout, RecordArray, RecordSpec

__all__ = ["DistTensor", "ReductionResult", "make_reduction_result"]


@dataclass(frozen=True)
class DistTensor:
    """Handle for a partitioned, haloed, layout-polymorphic tensor.

    Example::

        u = DistTensor("u", (1024, 1024), halo=(1, 1),
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

    def init(self, device: Any = None,
             fill: float = 0.0) -> torch.Tensor | RecordArray:
        """Allocate storage filled with ``fill`` on ``device`` (``None``:
        the GPU, raising without one)."""
        arr = torch.full(self.storage_shape, fill, dtype=self.dtype,
                         device=resolve_device(device))
        if self.is_record:
            return RecordArray(arr, self.spec, self.layout)
        return arr

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
