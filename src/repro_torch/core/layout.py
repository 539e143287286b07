"""Polymorphic data layout (paper §4.2) on PyTorch tensors.

A :class:`RecordSpec` plays the role of Ripple's ``StorageDescriptor`` and a
:class:`RecordArray` is the materialized storage over a space, held in ONE
``torch.Tensor``:

* ``Layout.AOS``   -> shape ``(*space, C)``   (components minor)
* ``Layout.SOA``   -> shape ``(C, *space)``   (space minor)
* ``Layout.AOSOA`` -> shape ``(*space[:-1], n_tiles, C, tile)`` — the last
  space dimension is blocked into tiles and the component axis sits
  between tiles.  ``tile = gcd(n, 128)``, the same rule as the JAX
  package, so storage shapes (and raw storage) are identical across the
  two packages and every relayout is a pure permutation of values.

Conversions between any two layouts go through :func:`relayout`, a
movedim + reshape materialized with ``.contiguous()`` so a kernel sees the
new physical order.  AoSoA storage does not support halo or partitioning
along the tiled (last) space dimension.

On the kernel side the layout-generic accessor is ``csrc/record_index.cuh``
(element offset of component ``c`` of cell ``i`` in each layout); every
CUDA record kernel indexes through it, so a kernel body is written once for
all three layouts.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .device import resolve_device

__all__ = [
    "Layout",
    "Field",
    "Vector",
    "RecordSpec",
    "RecordArray",
    "relayout",
    "relayout_data",
    "dispatch_with_relayout",
    "storage_candidates",
    "aosoa_tile",
    "AOSOA_LANE",
]


class Layout(enum.Enum):
    """Storage layout for record data (paper: contiguous vs strided)."""

    AOS = "aos"      # array-of-structs: components contiguous per cell
    SOA = "soa"      # struct-of-arrays: each component contiguous over space
    AOSOA = "aosoa"  # tiled hybrid: component blocks of `tile` cells

    def __repr__(self) -> str:
        return f"Layout.{self.name}"


#: Preferred AoSoA tile extent.  Kept equal to the JAX package's value so
#: storage shapes match it; a Hopper-specific tile width is tuning work.
AOSOA_LANE = 128


def aosoa_tile(n: int) -> int:
    """Tile extent for an AoSoA last-space-dim of ``n`` cells:
    ``gcd(n, 128)``, an exact tiling for every ``n`` (no padding)."""
    if n < 1:
        raise ValueError(f"space extent must be >= 1, got {n}")
    return math.gcd(n, AOSOA_LANE)


@dataclass(frozen=True)
class Field:
    """One named member of a record; ``size > 1`` is the paper's Vector<T, D>."""

    name: str
    size: int = 1

    def __post_init__(self) -> None:
        if self.size < 1:
            raise ValueError(f"field {self.name!r}: size must be >= 1")


def Vector(name: str, size: int) -> Field:  # noqa: N802 - mirrors paper API
    """Paper's ``Vector<T, Size>`` member declaration."""
    return Field(name, size)


@dataclass(frozen=True)
class RecordSpec:
    """The ``StorageDescriptor``: ordered named fields of a record."""

    fields: tuple[Field, ...]

    def __post_init__(self) -> None:
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in {names}")

    @classmethod
    def create(cls, *fields: Field | tuple[str, int] | str) -> "RecordSpec":
        """Build a spec from Fields, ``(name, size)`` pairs or bare names."""
        norm = []
        for f in fields:
            if isinstance(f, Field):
                norm.append(f)
            elif isinstance(f, str):
                norm.append(Field(f))
            else:
                norm.append(Field(*f))
        return cls(tuple(norm))

    @property
    def num_components(self) -> int:
        """Total scalar components per record (vector fields flattened)."""
        return sum(f.size for f in self.fields)

    @property
    def names(self) -> tuple[str, ...]:
        """Field names in declaration order."""
        return tuple(f.name for f in self.fields)

    def offset(self, name: str) -> tuple[int, int]:
        """(start, size) of a field in the component axis."""
        start = 0
        for f in self.fields:
            if f.name == name:
                return start, f.size
            start += f.size
        raise KeyError(f"no field {name!r} in {self.names}")


def _as_tensor(v, dtype=None, device=None) -> torch.Tensor:
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return torch.as_tensor(v, dtype=dtype, device=device)


class RecordArray:
    """A record-of-fields stored over an N-d space with polymorphic layout.

    One backing tensor holds every field, so field access is a view and
    whole-record operations (halo fill, relayout, transfer) touch a single
    buffer, as in Ripple's single-allocation storage.
    """

    __slots__ = ("data", "spec", "layout")

    def __init__(self, data: torch.Tensor, spec: RecordSpec, layout: Layout):
        self.data = data
        self.spec = spec
        self.layout = layout

    # -- construction ----------------------------------------------------
    @classmethod
    def create(cls, spec: RecordSpec, space: Sequence[int],
               layout: Layout = Layout.SOA, dtype: Any = torch.float32,
               fill: float = 0.0, device: Any = None) -> "RecordArray":
        """A record array filled with ``fill`` on ``device`` (``None``: the
        GPU, raising without one)."""
        shape = cls.storage_shape(spec, tuple(space), layout)
        return cls(torch.full(shape, fill, dtype=dtype,
                              device=resolve_device(device)),
                   spec, layout)

    @classmethod
    def from_fields(cls, spec: RecordSpec, fields: Mapping[str, Any],
                    layout: Layout = Layout.SOA) -> "RecordArray":
        """Build from per-field tensors of shape ``(*space[, size])``;
        size-1 fields may pass ``(*space)`` or ``(*space, 1)``."""
        vals = {f.name: _as_tensor(fields[f.name]) for f in spec.fields}
        space = None
        for f in spec.fields:
            if f.size > 1:
                space = tuple(vals[f.name].shape[:-1])
                break
        if space is None:
            space = tuple(vals[spec.fields[0].name].shape)
        parts = []
        for f in spec.fields:
            v = vals[f.name]
            if f.size == 1 and tuple(v.shape) == space:
                v = v[..., None]
            if tuple(v.shape) != (*space, f.size):
                raise ValueError(
                    f"field {f.name!r}: expected {(*space, f.size)} or "
                    f"{space}, got {tuple(v.shape)}")
            parts.append(v)
        out = cls(torch.cat(parts, dim=-1), spec, Layout.AOS)
        return out if layout is Layout.AOS else out.with_layout(layout)

    @staticmethod
    def storage_shape(spec: RecordSpec, space: Sequence[int],
                      layout: Layout) -> tuple[int, ...]:
        """Shape of the backing tensor for ``space`` under ``layout``."""
        c = spec.num_components
        space = tuple(space)
        if layout is Layout.AOS:
            return (*space, c)
        if layout is Layout.SOA:
            return (c, *space)
        tile = aosoa_tile(space[-1])
        return (*space[:-1], space[-1] // tile, c, tile)

    # -- basic properties -------------------------------------------------
    @property
    def space(self) -> tuple[int, ...]:
        """The logical N-d space extents (layout-independent)."""
        s = tuple(self.data.shape)
        if self.layout is Layout.AOS:
            return s[:-1]
        if self.layout is Layout.SOA:
            return s[1:]
        return (*s[:-3], s[-3] * s[-1])

    @property
    def dtype(self) -> torch.dtype:
        """Element dtype of the backing storage."""
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        """Device of the backing storage."""
        return self.data.device

    @property
    def num_components(self) -> int:
        """Total scalar components per record (see RecordSpec)."""
        return self.spec.num_components

    def __repr__(self) -> str:
        return (f"RecordArray(space={self.space}, fields={self.spec.names}, "
                f"layout={self.layout.name}, dtype={self.dtype}, "
                f"device={self.device})")

    # -- accessors (paper §4.3) -------------------------------------------
    def field(self, name: str) -> torch.Tensor:
        """Field with shape ``(*space,)`` (size 1) or ``(*space, size)``;
        a view for AoS/SoA, a copy for AoSoA."""
        start, size = self.spec.offset(name)
        if self.layout is Layout.AOS:
            v = self.data[..., start:start + size]
        elif self.layout is Layout.SOA:
            v = torch.movedim(self.data[start:start + size], 0, -1)
        else:  # (*sp', nt, C, tile) -> (*sp', nt, tile, size) -> merge
            v = torch.movedim(self.data[..., start:start + size, :], -2, -1)
            v = v.reshape(*self.space, size)
        return v[..., 0] if size == 1 else v

    f = field

    def set_field(self, name: str, value) -> "RecordArray":
        """A new RecordArray with field ``name`` replaced by ``value``
        (shape ``(*space,)`` or ``(*space, size)``); ``self`` is unchanged."""
        out = RecordArray(self.data.clone(), self.spec, self.layout)
        out.write_field(name, value)
        return out

    def write_field(self, name: str, value) -> None:
        """Write ``value`` into field ``name`` of this record's storage, in
        place (an output buffer's field, as ``set_field`` writes its
        copy's)."""
        start, size = self.spec.offset(name)
        value = _as_tensor(value, dtype=self.dtype, device=self.device)
        if size == 1 and value.dim() == len(self.space):
            value = value[..., None]
        if tuple(value.shape) != (*self.space, size):
            raise ValueError(f"set_field({name!r}): expected "
                             f"{(*self.space, size)}, got {tuple(value.shape)}")
        data = self.data
        if self.layout is Layout.AOS:
            data[..., start:start + size] = value
        elif self.layout is Layout.SOA:
            data[start:start + size] = torch.movedim(value, -1, 0)
        else:
            nt, tile = data.shape[-3], data.shape[-1]
            v = value.reshape(*self.space[:-1], nt, tile, size)
            data[..., start:start + size, :] = torch.movedim(v, -1, -2)

    def to_fields(self) -> dict[str, torch.Tensor]:
        """All fields as a name -> tensor dict (inverse of from_fields)."""
        return {f.name: self.field(f.name) for f in self.spec.fields}

    # -- layout interop ----------------------------------------------------
    def _to_aos_data(self) -> torch.Tensor:
        """Canonical AoS view ``(*space, C)`` of the storage."""
        nd = len(self.space)
        if self.layout is Layout.AOS:
            return self.data
        if self.layout is Layout.SOA:
            return torch.movedim(self.data, 0, nd)
        v = torch.movedim(self.data, -2, -1)
        return v.reshape(*self.space, self.num_components)

    def with_layout(self, layout: Layout) -> "RecordArray":
        """Convert to ``layout`` (value-exact; all pairs go via AoS).  The
        result is contiguous, i.e. the transpose is materialized."""
        if layout is self.layout:
            return self
        aos = self._to_aos_data()
        space = self.space
        if layout is Layout.AOS:
            data = aos
        elif layout is Layout.SOA:
            data = torch.movedim(aos, len(space), 0)
        else:
            tile = aosoa_tile(space[-1])
            v = aos.reshape(*space[:-1], space[-1] // tile, tile,
                            self.num_components)
            data = torch.movedim(v, -1, -2)
        data = data.contiguous()
        if data.data_ptr() == self.data.data_ptr():
            data = data.clone()
        return RecordArray(data, self.spec, layout)

    def map_data(self, fn) -> "RecordArray":
        """Apply ``fn`` to the raw storage (shape-preserving)."""
        return RecordArray(fn(self.data), self.spec, self.layout)

    def space_axis(self, dim: int) -> int:
        """Storage axis corresponding to space dimension ``dim``."""
        nd = len(self.space)
        if not 0 <= dim < nd:
            raise ValueError(f"dim {dim} out of range for space {self.space}")
        if self.layout is Layout.AOS:
            return dim
        if self.layout is Layout.SOA:
            return dim + 1
        if dim == nd - 1:
            raise ValueError(
                "AOSOA tiles the last space dim across two storage axes; "
                "per-axis ops (halo, partition) are unsupported there")
        return dim


def relayout(arr: RecordArray, target: Layout) -> RecordArray:
    """Convert ``arr`` to ``target`` layout (no-op when already there)."""
    return arr.with_layout(target)


def relayout_data(data: torch.Tensor, spec: RecordSpec, src: Layout,
                  dst: Layout) -> torch.Tensor:
    """Relayout on raw record storage:
    ``relayout(RecordArray(data, spec, src), dst).data``."""
    if src is dst:
        return data
    return RecordArray(data, spec, src).with_layout(dst).data


def storage_candidates(space: Sequence[int], halo: Sequence[int] = (),
                       partition: Sequence = ()) -> tuple[Layout, ...]:
    """The layouts a record over ``space`` can physically be stored in:
    AoS and SoA always; AoSoA unless the last space dim carries a halo or
    a partition."""
    space = tuple(space)
    nd = len(space)
    halo = tuple(halo) or (0,) * nd
    partition = tuple(partition) or (None,) * nd
    if halo[nd - 1] or partition[nd - 1] is not None:
        return (Layout.AOS, Layout.SOA)
    return (Layout.AOS, Layout.SOA, Layout.AOSOA)


def dispatch_with_relayout(kernel_fn, rec: RecordArray, *args,
                           supported: Sequence[Layout],
                           preferred: Layout, out=None, **kw):
    """Run ``kernel_fn(rec, *args, **kw)``, staging ``rec`` through
    ``preferred`` when its layout is not in ``supported`` and converting
    the result back.  ``out`` (a record in ``rec``'s layout) is handed to
    the kernel when it runs in that layout, and otherwise receives the
    converted result."""
    if rec.layout in supported:
        if out is None:
            return kernel_fn(rec, *args, **kw)
        return kernel_fn(rec, *args, out=out, **kw)
    res = relayout(kernel_fn(relayout(rec, preferred), *args, **kw),
                   rec.layout)
    if out is None:
        return res
    out.data.copy_(res.data)
    return out
