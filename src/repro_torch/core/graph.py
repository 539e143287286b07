"""Graph builder (paper §5.3): emplace / then / split / then_split /
reduce / then_reduce / conditional / sync / subgraphs + access modifiers.

A :class:`Graph` records *levels* of :class:`Node` s — the paper's DAG where
a level holds nodes that may execute in parallel and each level depends on
the previous one.  The builder is pure Python and identical in structure to
the JAX package's; only the reducer library computes (with torch, and
the max and min of a float32 view on the card with a hand-written
kernel).

Access modifiers say how a kernel touches halo data:

* plain tensor arg                      — no halo read;
* ``concurrent_padded_access(t)``       — reads halo, writes another buffer;
* ``exclusive_padded_access(t)``        — reads halo of a buffer the kernel
  itself updates;
* ``*_in_shared(t)``                    — the kernel additionally stages its
  blocks in shared memory (the CUDA kernels do so by design).
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field as dfield
from typing import Any, Callable, Optional, Sequence, Union

import torch

from .layout import Layout
from .tensor import DistTensor, ReductionResult

__all__ = [
    "ExecutionKind",
    "AccessMode",
    "TensorArg",
    "preferred_layout",
    "concurrent_padded_access",
    "exclusive_padded_access",
    "in_shared",
    "in_place",
    "concurrent_padded_access_in_shared",
    "exclusive_padded_access_in_shared",
    "Reducer",
    "SumReducer",
    "MaxReducer",
    "MinReducer",
    "MulReducer",
    "AndReducer",
    "OrReducer",
    "XorReducer",
    "MinimumReducer",
    "MaximumReducer",
    "Node",
    "Graph",
]

_node_counter = itertools.count()


class ExecutionKind(enum.Enum):
    """Where a node runs: the host between device segments, or the device."""

    Cpu = "cpu"
    Gpu = "gpu"


class AccessMode(enum.Enum):
    """How a node touches a tensor's halo (see the module docstring)."""

    DEFAULT = "default"
    CONCURRENT_PADDED = "concurrent_padded"
    EXCLUSIVE_PADDED = "exclusive_padded"
    SHARED = "shared"
    CONCURRENT_PADDED_SHARED = "concurrent_padded_shared"
    EXCLUSIVE_PADDED_SHARED = "exclusive_padded_shared"

    @property
    def padded(self) -> bool:
        """True when the node reads the halo."""
        return self in (
            AccessMode.CONCURRENT_PADDED,
            AccessMode.EXCLUSIVE_PADDED,
            AccessMode.CONCURRENT_PADDED_SHARED,
            AccessMode.EXCLUSIVE_PADDED_SHARED,
        )

    @property
    def exclusive(self) -> bool:
        """True when the node also updates the haloed buffer in place."""
        return self in (
            AccessMode.EXCLUSIVE_PADDED,
            AccessMode.EXCLUSIVE_PADDED_SHARED,
        )

    @property
    def shared(self) -> bool:
        """True when the node stages blocks in shared memory."""
        return self in (
            AccessMode.SHARED,
            AccessMode.CONCURRENT_PADDED_SHARED,
            AccessMode.EXCLUSIVE_PADDED_SHARED,
        )


@dataclass(frozen=True)
class TensorArg:
    """A tensor argument with its access mode and optional layout hint."""

    tensor: DistTensor
    mode: AccessMode = AccessMode.DEFAULT
    layout: Optional[Layout] = None  # kernel's preferred layout (solver hint)


def preferred_layout(t: DistTensor | TensorArg,
                     layout: Layout) -> TensorArg:
    """Annotate an argument with the kernel's preferred layout — a solver
    hint that a user pin or a halo requirement overrides."""
    if isinstance(t, TensorArg):
        return TensorArg(t.tensor, t.mode, layout)
    return TensorArg(t, AccessMode.DEFAULT, layout)


def concurrent_padded_access(t: DistTensor) -> TensorArg:
    """Mark ``t`` as read *including its halo*, written elsewhere.

    Example::

        g.split(laplace, concurrent_padded_access(src), dst)
    """
    return TensorArg(t, AccessMode.CONCURRENT_PADDED)


def exclusive_padded_access(t: DistTensor) -> TensorArg:
    """Mark ``t`` as read including its halo by a node that also updates
    ``t`` in place (paper Fig. 9).

    Example::

        g.split(fim_sweep, exclusive_padded_access(phi), mask, writes=(0,))
    """
    return TensorArg(t, AccessMode.EXCLUSIVE_PADDED)


def in_shared(t: DistTensor) -> TensorArg:
    """Mark ``t`` for staging through shared memory (paper's
    ``in_shared()``).  Example: ``g.split(kern, in_shared(u), out)``."""
    return TensorArg(t, AccessMode.SHARED)


def concurrent_padded_access_in_shared(t: DistTensor) -> TensorArg:
    """:func:`concurrent_padded_access` + :func:`in_shared`."""
    return TensorArg(t, AccessMode.CONCURRENT_PADDED_SHARED)


def exclusive_padded_access_in_shared(t: DistTensor) -> TensorArg:
    """:func:`exclusive_padded_access` + :func:`in_shared`."""
    return TensorArg(t, AccessMode.EXCLUSIVE_PADDED_SHARED)


def _torch_route(x) -> str:
    return "torch"


@dataclass(frozen=True)
class Reducer:
    """Local reduction + cross-partition combiner name.  ``route(x)``
    says how ``local`` reduces ``x``: ``"kernel"`` where it launches a
    hand-written kernel, ``"torch"`` where it runs torch ops."""

    name: str
    local: Callable  # tensor -> 0-d tensor
    combine: str     # 'add'|'mul'|'max'|'min'|'and'|'or'|'xor'|
                     # 'minimum'|'maximum'
    route: Callable = _torch_route  # tensor -> 'kernel' | 'torch'


def SumReducer() -> Reducer:  # noqa: N802 - mirrors paper naming
    """Sum reduction.  Example: ``g.then_reduce(t, total, SumReducer())``."""
    return Reducer("sum", torch.sum, "add")


def _nan_ignoring(largest: bool):
    """Ripple's ``max`` (``largest``) / ``min``: a quiet NaN operand is
    ignored (the all-NaN tensor still reduces to NaN).  ``out`` (a 0-d
    tensor of the input's dtype) receives the result, as the executor's
    regions write a result into its static buffer.  A CUDA float32 view
    goes to the hand-written kernel, read where it lies; everything else
    to the plain PyTorch version (``kernels/reduce``)."""

    def local(x, out=None):
        # imported at the call: the kernels' package imports core
        from ..kernels.reduce.ops import nan_ignoring_extremum

        return nan_ignoring_extremum(x, largest=largest, out=out)

    return local


def _nan_ignoring_route(x) -> str:
    """How :func:`_nan_ignoring`'s ``local`` reduces ``x``."""
    from ..kernels.reduce.ops import route

    return route(x)


def _nan_propagating(reduce_all):
    """``minimum``/``maximum``: any quiet NaN operand makes the result NaN
    (into ``out`` when given, as :func:`_nan_ignoring`)."""

    def local(x, out=None):
        x = torch.as_tensor(x)
        m = reduce_all(x)
        if x.is_floating_point():
            return torch.where(torch.isnan(x).any(),
                               torch.full_like(m, float("nan")), m, out=out)
        return m if out is None else out.copy_(m)

    return local


def _bitwise_fold(op, identity: int):
    """Reduce every element with a bitwise ``op`` by pairwise halving
    (torch has no bitwise reduction)."""

    def local(x):
        x = torch.as_tensor(x).reshape(-1)
        ident = torch.full((1,), identity, device=x.device).to(x.dtype)
        if x.numel() == 0:
            return ident[0]
        while x.numel() > 1:
            if x.numel() % 2:
                x = torch.cat([x, ident])
            x = op(x[0::2], x[1::2])
        return x[0]

    return local


def MaxReducer() -> Reducer:  # noqa: N802
    """NaN-ignoring max (spec: NUM vs qNaN -> NUM).  For the
    NaN-propagating variant use :func:`MaximumReducer`."""
    return Reducer("max", _nan_ignoring(True), "max", _nan_ignoring_route)


def MinReducer() -> Reducer:  # noqa: N802
    """NaN-ignoring min.  For the NaN-propagating variant use
    :func:`MinimumReducer`."""
    return Reducer("min", _nan_ignoring(False), "min", _nan_ignoring_route)


def MulReducer() -> Reducer:  # noqa: N802
    """Product reduction."""
    return Reducer("mul", torch.prod, "mul")


def AndReducer() -> Reducer:  # noqa: N802
    """Bitwise/logical AND over integer or boolean tensors."""
    return Reducer("and", _bitwise_fold(torch.bitwise_and, -1), "and")


def OrReducer() -> Reducer:  # noqa: N802
    """Bitwise/logical OR over integer or boolean tensors."""
    return Reducer("or", _bitwise_fold(torch.bitwise_or, 0), "or")


def XorReducer() -> Reducer:  # noqa: N802
    """Bitwise XOR over integer or boolean tensors."""
    return Reducer("xor", _bitwise_fold(torch.bitwise_xor, 0), "xor")


def MinimumReducer() -> Reducer:  # noqa: N802
    """NaN-propagating min (spec ``minimum``: NUM vs qNaN -> qNaN)."""
    return Reducer("minimum", _nan_propagating(torch.amin), "minimum")


def MaximumReducer() -> Reducer:  # noqa: N802
    """NaN-propagating max (spec ``maximum``: NUM vs qNaN -> qNaN)."""
    return Reducer("maximum", _nan_propagating(torch.amax), "maximum")


def in_place(fn: Callable) -> Callable:
    """Mark a node function that takes ``out=`` as safe when ``out`` is the
    very tensor it receives for the key it writes: it reads each element
    of that input before it writes the element, in one thread (K1-K3, the
    KV cache writes), or does not read that input at all.  Under
    ``regions=True`` the executor hands such a node its key's static
    buffer, which then also holds the input (see ``core/executor.py``).
    Returns ``fn``."""
    fn.in_place = True
    return fn


NodeArg = Union[DistTensor, TensorArg, ReductionResult, Any]


@dataclass
class Node:
    """One graph node: a tensor op, a reduction, a barrier or a subgraph."""

    kind: str                      # 'op' | 'split' | 'reduce' | 'sync' | 'loop'
    fn: Optional[Callable] = None
    args: tuple = ()
    writes: Optional[tuple[int, ...]] = None  # arg indices the fn returns
    exec_kind: ExecutionKind = ExecutionKind.Gpu
    reducer: Optional[Reducer] = None
    result: Optional[ReductionResult] = None
    overlap: bool = False          # interior/boundary comm-compute overlap
    subgraph: Optional["Graph"] = None
    name: str = dfield(default_factory=lambda: f"node{next(_node_counter)}")

    def tensor_args(self):
        """Yield ``(arg index, tensor, access mode)`` per tensor argument."""
        for i, a in enumerate(self.args):
            if isinstance(a, TensorArg):
                yield i, a.tensor, a.mode
            elif isinstance(a, DistTensor):
                yield i, a, AccessMode.DEFAULT

    def default_writes(self) -> tuple[int, ...]:
        """The written argument indices: ``writes`` when given, else the
        last tensor argument (paper convention for split nodes)."""
        if self.writes is not None:
            return self.writes
        tidx = [i for i, _, _ in self.tensor_args()]
        return (tidx[-1],) if tidx else ()


class Graph:
    """Builder for a level-structured DAG (paper Listings 5-12)."""

    def __init__(self, default_exec: ExecutionKind = ExecutionKind.Gpu,
                 name: str = "graph"):
        self.default_exec = default_exec
        self.name = name
        self.levels: list[list[Node]] = []
        self.condition: Optional[Callable] = None  # state -> bool tensor

    def _current_level(self) -> list[Node]:
        if not self.levels:
            self.levels.append([])
        return self.levels[-1]

    def _new_level(self) -> list[Node]:
        if not self.levels or self.levels[-1]:
            self.levels.append([])
        return self.levels[-1]

    def _exec(self, kind: Optional[ExecutionKind]) -> ExecutionKind:
        return kind if kind is not None else self.default_exec

    @staticmethod
    def _hint_args(args: tuple, layout: Optional[Layout]) -> tuple:
        """Apply a node-level ``layout=`` preference to record tensor args
        that don't already carry their own hint."""
        if layout is None:
            return args
        out = []
        for a in args:
            if isinstance(a, TensorArg) and a.layout is None \
                    and a.tensor.is_record:
                a = TensorArg(a.tensor, a.mode, layout)
            elif isinstance(a, DistTensor) and a.is_record:
                a = TensorArg(a, AccessMode.DEFAULT, layout)
            out.append(a)
        return tuple(out)

    def _add(self, level: list[Node], item, exec_kind, **kw) -> None:
        if isinstance(item, Graph):
            level.append(Node(kind="loop" if item.condition else "subgraph",
                              subgraph=item,
                              exec_kind=self._exec(exec_kind)))
        else:
            level.append(Node(fn=item, exec_kind=self._exec(exec_kind), **kw))

    # -- paper API -----------------------------------------------------------
    def emplace(self, *items, exec_kind: Optional[ExecutionKind] = None,
                layout: Optional[Layout] = None, **kw) -> "Graph":
        """Add node(s)/subgraph(s) to the *current* level (parallel)."""
        if "args" in kw:
            kw["args"] = self._hint_args(tuple(kw["args"]), layout)
        level = self._current_level()
        for item in items:
            self._add(level, item, exec_kind, kind="op", **kw)
        return self

    def then(self, *items, exec_kind: Optional[ExecutionKind] = None,
             layout: Optional[Layout] = None, **kw) -> "Graph":
        """Add node(s)/subgraph(s) on a *new* level (sequential dep)."""
        if "args" in kw:
            kw["args"] = self._hint_args(tuple(kw["args"]), layout)
        level = self._new_level()
        for item in items:
            self._add(level, item, exec_kind, kind="op", **kw)
        return self

    def split(self, fn: Callable, *args: NodeArg,
              writes: Optional[Sequence[int]] = None,
              exec_kind: Optional[ExecutionKind] = None,
              overlap: bool = False,
              layout: Optional[Layout] = None) -> "Graph":
        """Tensor op on the current level (paper §5.3.3).  ``overlap=True``
        asks for the interior/boundary lowering of a partitioned stencil;
        without partitioned axes it lowers synchronously, as in the
        reference."""
        self._current_level().append(
            Node(kind="split", fn=fn, args=self._hint_args(args, layout),
                 writes=None if writes is None else tuple(writes),
                 exec_kind=self._exec(exec_kind), overlap=overlap))
        return self

    def then_split(self, fn: Callable, *args: NodeArg,
                   writes: Optional[Sequence[int]] = None,
                   exec_kind: Optional[ExecutionKind] = None,
                   overlap: bool = False,
                   layout: Optional[Layout] = None) -> "Graph":
        """:meth:`split` on a *new* level."""
        self._new_level()
        return self.split(fn, *args, writes=writes, exec_kind=exec_kind,
                          overlap=overlap, layout=layout)

    def reduce(self, tensor: DistTensor, result: ReductionResult,
               reducer: Reducer, field: Optional[str] = None) -> "Graph":
        """Reduce ``tensor`` (or one record ``field`` of it) into the
        ``result`` slot on the current level (paper Listing 8).

        Example::

            total = make_reduction_result("total")
            g.then_reduce(t, total, SumReducer())   # state["total"]
        """
        self._current_level().append(
            Node(kind="reduce", args=(tensor, field), reducer=reducer,
                 result=result, exec_kind=ExecutionKind.Gpu))
        return self

    def then_reduce(self, tensor: DistTensor, result: ReductionResult,
                    reducer: Reducer, field: Optional[str] = None) -> "Graph":
        """:meth:`reduce` on a *new* level."""
        self._new_level()
        return self.reduce(tensor, result, reducer, field)

    def sync(self, fn: Optional[Callable] = None) -> "Graph":
        """Full barrier: pending device work completes, then ``fn`` runs on
        the host (paper §5.3.4)."""
        self._new_level().append(Node(kind="sync", fn=fn,
                                      exec_kind=ExecutionKind.Cpu))
        self._new_level()
        return self

    def conditional(self, pred: Callable) -> "Graph":
        """Execute this graph while ``pred(state)`` is true (paper §5.3.6)."""
        self.condition = pred
        return self

    # -- introspection ---------------------------------------------------------
    def nodes(self):
        """Every node in builder (program) order, levels flattened."""
        for level in self.levels:
            yield from level

    def all_tensors(self) -> dict[str, DistTensor]:
        """Every :class:`DistTensor` the graph touches, by name (subgraphs
        included); two accesses of one name must agree on storage."""
        out: dict[str, DistTensor] = {}
        for node in self.nodes():
            if node.subgraph is not None:
                out.update(node.subgraph.all_tensors())
                continue
            for _, t, _ in node.tensor_args():
                prev = out.get(t.name)
                if prev is not None and prev.storage_key() != t.storage_key():
                    raise ValueError(
                        f"tensor name {t.name!r} bound to two different "
                        f"storages (halo/boundary may differ per access; "
                        f"space/layout/partition may not)")
                out[t.name] = t
        return out

    def all_results(self) -> dict[str, ReductionResult]:
        """Every reduction-result slot the graph writes, by name."""
        out: dict[str, ReductionResult] = {}
        for node in self.nodes():
            if node.subgraph is not None:
                out.update(node.subgraph.all_results())
            if node.result is not None:
                out[node.result.name] = node.result
        return out

    def is_device_only(self) -> bool:
        """True when no node needs the host (no ``sync()``, no Cpu nodes)."""
        for node in self.nodes():
            if node.kind == "sync":
                return False
            if node.subgraph is not None and not node.subgraph.is_device_only():
                return False
            if node.exec_kind is ExecutionKind.Cpu and node.kind != "subgraph":
                return False
        return True

    def summary(self) -> str:
        """One line per node: level, kind, and the tensors it touches."""
        lines = [f"Graph {self.name!r} ({len(self.levels)} levels)"]
        for i, level in enumerate(self.levels):
            for n in level:
                desc = n.kind
                if n.subgraph is not None:
                    desc += f"[{n.subgraph.name}]"
                ts = ",".join(t.name for _, t, _ in n.tensor_args())
                lines.append(f"  L{i}: {n.name} {desc} ({ts})")
        if self.condition is not None:
            lines.append("  while <condition>")
        return "\n".join(lines)
