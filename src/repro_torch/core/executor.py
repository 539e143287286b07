"""Graph executor (paper §6) — runs a Ripple Graph on one GPU, eagerly.

The single-process counterpart of the JAX package's ``Executor``:

* graph nodes are scheduled from their real data dependencies
  (``core/schedule.py``): with ``schedule="dag"`` (default) antichains of
  independent device nodes share a wave and consecutive waves one segment;
  ``schedule="sequential"`` is the program-order lowering.  Both give the
  same state;
* a **layout solver** assigns each record tensor a storage layout per
  segment (user pin > node preference > halo clamp > declared layout) and
  the executor converts state at segment boundaries where producer and
  consumer disagree (``plan.relayouts``).  Outside a call every state dict
  is in the plan's *initial* layouts;
* padded (halo) accesses get their halo cells from the tensor's boundary
  policy (``core/halo.py``) before the node runs;
* host (Cpu) nodes and ``sync()`` wait for the device, then run their
  callback.

Every segment runs eagerly: node functions are called in wave order, each
wave against a snapshot of the state, so the result is the reference's
per-segment dispatch semantics (its ``regions=False`` path, which its
README states is bitwise-identical to region dispatch).  Node functions
return new tensors and never write a state buffer in place, so a caller's
state dict is never modified and there is nothing to donate: the
reference's ``donate=`` has no counterpart here.

A conditional subgraph (paper §5.3.6) is a ``loop`` segment, or a
``host_loop`` when its body holds a host node; both run with while
semantics through a sub-executor built once per segment.  On the GPU each
check of the predicate is one device-to-host read.

The **measured autotuner** (``tune="auto"`` / ``"load"``,
``repro_torch.tuning.search``) times candidate layouts and kernel tiles as
real runs of fresh executors, commits the fastest and persists it in the
tuning cache keyed by the heuristic plan's :func:`plan_signature` (the
structural identity of a plan: graph structure, node function code and
closures, shapes, dtypes, layouts, schedule, device type, overrides,
tiles), so a second process over an identical graph loads the decision
with zero measurements.

Not in this executor yet, each raising ``NotImplementedError`` that names
its ROADMAP item: ``mesh=`` and partitioned tensors (item 8), region
compile (``regions=True``, item 7(b)) and async region dispatch
(``async_regions=True``, item 7(c)).

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when no GPU is present.  Pass ``device="cpu"`` to run the kernels' plain
PyTorch versions on the CPU.
"""

from __future__ import annotations

import enum as enum_lib
import functools
import hashlib
import sys
import types
from contextlib import contextmanager
from dataclasses import dataclass, field as dfield
from typing import Any, Optional

import numpy as np
import torch

from ..tuning.tiles import tile_scope
from . import halo as halo_lib
from . import schedule as schedule_lib
from .device import resolve_device
from .graph import AccessMode, Graph, Node, TensorArg
from .layout import (Layout, RecordArray, _as_tensor, relayout,
                     storage_candidates)
from .schedule import ScheduleDag
from .tensor import DistTensor, ReductionResult

__all__ = ["Executor", "execute", "LayoutPlan", "RelayoutStep",
           "layout_candidates", "plan_signature", "solve_layouts"]

_ITEM_MESH = ("ROADMAP item 8 (halo exchange and the multi-process "
              "executor)")
_ITEM_REGIONS = "ROADMAP item 7(b) (region compile)"
_ITEM_ASYNC = "ROADMAP item 7(c) (async regions)"


def _apply_halo(data: torch.Tensor, t: DistTensor) -> torch.Tensor:
    """Extend ``data`` by all of ``t``'s halos, filled from its boundary
    policy, corners included."""
    axes = [halo_lib.HaloAxis(t.storage_axis(d), w)
            for d, w in enumerate(t.halo) if w]
    if not axes:
        return data
    return halo_lib.exchange_multi(data, axes, boundary=t.boundary,
                                   constant=t.boundary_constant)


@dataclass(frozen=True)
class RelayoutStep:
    """An explicit layout conversion the executor inserts at a segment
    boundary: ``tensor`` is converted ``src -> dst`` before ``segment``."""

    segment: int
    tensor: str
    src: Layout
    dst: Layout


@dataclass
class LayoutPlan:
    """Solver output: ``initial`` is what :meth:`Executor.init_state`
    materializes (the first consuming segment's choice), ``per_segment``
    the layout of every record tensor each segment touches, ``relayouts``
    the boundary conversions of one pass, ``dag`` the dependency DAG
    with its segment placement, ``signature`` the 12-hex digest of the
    :func:`plan_signature` and ``tuning`` the measured autotuner's
    :class:`~repro_torch.tuning.search.TuningDecision` when the Executor
    was constructed with ``tune="load"``/``"auto"`` (None when tuning is
    off)."""

    per_segment: list[dict[str, Layout]] = dfield(default_factory=list)
    initial: dict[str, Layout] = dfield(default_factory=dict)
    relayouts: list[RelayoutStep] = dfield(default_factory=list)
    dag: Optional[ScheduleDag] = None
    signature: str = ""
    tuning: Optional[Any] = None

    def describe_dag(self) -> str:
        """Render the dependency DAG with its segment/wave placement and
        the relayout steps at each segment entry."""
        if self.dag is None:
            return "(no dependency DAG recorded)"
        return self.dag.describe(plan=self)

    def describe_tuning(self) -> str:
        """Render the measured autotuner's decision for this plan: the
        baseline-vs-tuned steady-state times, every candidate measured
        (layout per state key, tile per kernel) and which won.  With
        tuning off, says so and how to turn it on."""
        if self.tuning is None:
            return ("(no measured tuning: heuristic layout solver and "
                    "default kernel tiles — construct the Executor with "
                    "tune=\"auto\" to measure)")
        return self.tuning.describe()


def _segment_nodes(kind: str, payload):
    """All nodes a segment executes (loop bodies recursively)."""
    if kind == "device":
        for level in payload:
            yield from level
    elif kind in ("loop", "host_loop"):
        yield from _graph_nodes(payload)
    elif kind == "host":
        yield payload


def _graph_nodes(g: Graph):
    for node in g.nodes():
        if node.subgraph is not None:
            yield from _graph_nodes(node.subgraph)
        else:
            yield node


def _clamp_layout(t: DistTensor, lay: Layout) -> Layout:
    """AoSoA cannot carry halo/partition on the tiled (last) dim; fall back
    to SoA when it would."""
    if lay is not Layout.AOSOA or not t.is_record:
        return lay
    if lay not in storage_candidates(t.space, t.halo, t.partition):
        return Layout.SOA
    return lay


def solve_layouts(
    segments,
    tensors: dict[str, DistTensor],
    overrides: Optional[dict[str, Layout]] = None,
    segment_overrides: Optional[dict[int, dict[str, Layout]]] = None,
) -> LayoutPlan:
    """Choose a storage layout per record tensor per segment.

    Decision order per tensor (first match wins): ``segment_overrides``
    (segment index -> key -> layout), ``overrides`` (plan-uniform), the
    user's ``pin_layout``, the first node-level preference in node order
    (clamped by halo/partition feasibility), the declared layout (clamped
    the same way).
    """
    overrides = overrides or {}
    segment_overrides = segment_overrides or {}

    def choose(seg_idx, nodes) -> dict[str, Layout]:
        seg_over = segment_overrides.get(seg_idx, {})
        hints: dict[str, Layout] = {}
        seen: set[str] = set()
        no_aosoa: set[str] = set()
        for node in nodes:
            for a in node.args:
                if isinstance(a, TensorArg):
                    t, hint = a.tensor, a.layout
                elif isinstance(a, DistTensor):
                    t, hint = a, None
                else:
                    continue
                if not t.is_record:
                    continue
                seen.add(t.name)
                # feasibility is per ACCESS handle: any haloed access
                # vetoes AoSoA for the shared storage
                if _clamp_layout(t, Layout.AOSOA) is not Layout.AOSOA:
                    no_aosoa.add(t.name)
                if hint is not None and t.name not in hints:
                    hints[t.name] = hint
        out: dict[str, Layout] = {}
        for name in seen:
            t = tensors[name]
            if name in seg_over:
                out[name] = seg_over[name]
            elif name in overrides:
                out[name] = overrides[name]
            elif t.pin_layout:
                if t.layout is Layout.AOSOA and (
                        name in no_aosoa
                        or _clamp_layout(t, Layout.AOSOA)
                        is not Layout.AOSOA):
                    raise ValueError(
                        f"{name}: pinned AOSOA layout is infeasible — the "
                        f"tensor carries a halo or partition on the tiled "
                        f"(last) space dim")
                out[name] = t.layout
            else:
                lay = _clamp_layout(t, hints.get(name, t.layout))
                if lay is Layout.AOSOA and name in no_aosoa:
                    lay = Layout.SOA
                out[name] = lay
        return out

    per_segment = [choose(i, list(_segment_nodes(k, p)))
                   for i, (k, p) in enumerate(segments)]

    plan = LayoutPlan(per_segment=per_segment)
    current: dict[str, Layout] = {}
    for i, seg in enumerate(per_segment):
        for name, lay in seg.items():
            cur = current.get(name)
            if cur is None:
                plan.initial[name] = lay
            elif cur is not lay:
                plan.relayouts.append(RelayoutStep(i, name, cur, lay))
            current[name] = lay
    for name, t in tensors.items():
        if t.is_record and name not in plan.initial:
            plan.initial[name] = t.layout
    return plan


# -- plan signature (structural identity of a plan) ----------------------------
#
# The tuning cache (and item 7(b)'s executable cache after it) must never
# alias two plans that could compute different values, and should alias
# plans from *re-instantiated* executors over an identical graph (the
# serving pattern).  Node names are excluded (they come from a global
# counter and differ per build); node *functions* are keyed by
# module/qualname + code object + closure/default values, so a rebuilt
# graph using the same function definitions matches.  Anything the
# signature cannot prove equal falls back to ``id(...)``: a conservative
# miss, never a wrong hit.

_SIG_DEPTH = 6


def _module_singleton(fn) -> bool:
    """True if ``fn`` IS the attribute its module/qualname (or its
    module/name) names — a stable process-wide singleton (e.g.
    ``torch.amax``, whose qualname is ``_VariableFunctionsClass.amax``)."""
    mod = sys.modules.get(getattr(fn, "__module__", None) or "")
    if mod is None:
        return False
    if getattr(mod, getattr(fn, "__name__", None) or "", None) is fn:
        return True
    obj = mod
    try:
        for part in fn.__qualname__.split("."):
            obj = getattr(obj, part)
    except AttributeError:
        return False
    return obj is fn


def _code_sig(code: types.CodeType):
    consts = tuple(_code_sig(c) if isinstance(c, types.CodeType) else repr(c)
                   for c in code.co_consts)
    return (code.co_name, code.co_argcount, code.co_code, consts,
            code.co_names)


def _all_code_names(code: types.CodeType) -> set:
    """Every global name referenced by ``code`` or its nested code
    objects (inner lambdas/defs share the enclosing fn's globals)."""
    names = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names |= _all_code_names(c)
    return names


def _globals_sig(fn, code: types.CodeType, depth: int):
    """Key the VALUES of the module globals a function reads — a node fn
    like ``def f(x): return x * SCALE`` must miss when SCALE changed
    between Executor builds (co_names alone keys the name, not the
    value).  Module-valued names are keyed by module name (cheap)."""
    g = getattr(fn, "__globals__", None)
    if g is None:
        return ()
    out = []
    for name in sorted(_all_code_names(code)):
        if name in g:
            v = g[name]
            if isinstance(v, types.ModuleType):
                out.append((name, ("module", v.__name__)))
            else:
                out.append((name, _sig_value(v, depth)))
    return tuple(out)


def _fn_sig(fn, depth: int = 0):
    if depth > _SIG_DEPTH:
        return ("deep-fn", id(fn))
    if isinstance(fn, functools.partial):
        return ("partial", _fn_sig(fn.func, depth + 1),
                _sig_value(fn.args, depth + 1),
                _sig_value(fn.keywords, depth + 1))
    # a bound method proxies __code__/__closure__ from the underlying
    # function — the receiver carries state, so it must be keyed too
    self_obj = getattr(fn, "__self__", None)
    if self_obj is not None:
        func = getattr(fn, "__func__", None)
        return ("bound", _sig_value(self_obj, depth + 1),
                _fn_sig(func, depth + 1) if func is not None else None)
    code = getattr(fn, "__code__", None)
    if code is None:
        mod = getattr(fn, "__module__", None)
        qn = getattr(fn, "__qualname__", None) or getattr(fn, "__name__", None)
        if qn is not None and _module_singleton(fn):
            return ("singleton", mod, qn)
        return ("callable", mod, qn, id(fn))
    cells = []
    for c in (fn.__closure__ or ()):
        try:
            cells.append(_sig_value(c.cell_contents, depth + 1))
        except ValueError:          # empty cell
            cells.append(("empty-cell",))
    # globals are keyed by VALUE one level deep (the node fn itself and
    # its closure-level callees); deeper library internals would explode
    # the walk and are keyed by code identity alone
    globs = _globals_sig(fn, code, depth + 1) if depth < 2 else ()
    return ("fn", fn.__module__, fn.__qualname__, _code_sig(code),
            tuple(cells), _sig_value(fn.__defaults__ or (), depth + 1),
            _sig_value(fn.__kwdefaults__ or {}, depth + 1), globs)


def _tensor_sig(t: DistTensor):
    spec = (None if t.spec is None
            else tuple((f.name, f.size) for f in t.spec.fields))
    return ("dt", t.name, t.space, str(t.dtype), spec, t.layout.name,
            t.pin_layout, t.partition, t.halo, t.boundary.name,
            t.boundary_constant, t.subblocks)


def _sig_value(v, depth: int = 0):
    if depth > _SIG_DEPTH:
        return ("deep", id(v))
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, enum_lib.Enum):
        return ("enum", type(v).__name__, v.name)
    if isinstance(v, (torch.dtype, torch.device)):
        return (type(v).__name__, str(v))
    if isinstance(v, (tuple, list)):
        return ("seq", tuple(_sig_value(x, depth + 1) for x in v))
    if isinstance(v, dict):
        return ("map", tuple(sorted(
            (str(k), _sig_value(x, depth + 1)) for k, x in v.items())))
    if isinstance(v, DistTensor):
        return _tensor_sig(v)
    if isinstance(v, ReductionResult):
        return ("res", v.name, str(v.dtype), v.init)
    if isinstance(v, np.ndarray):
        if v.size > 1024:
            return ("bigarr", tuple(v.shape), str(v.dtype), id(v))
        return ("arr", v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, torch.Tensor):
        # shape and dtype are metadata; only small tensors are copied to
        # the host for value-keying
        if v.numel() > 1024:
            return ("bigarr", tuple(v.shape), str(v.dtype), id(v))
        raw = v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        return ("arr", tuple(v.shape), str(v.dtype), raw.numpy().tobytes())
    if callable(v):
        return _fn_sig(v, depth + 1)
    return ("obj", type(v).__module__, type(v).__qualname__, id(v))


def _node_sig(node: Node):
    args = []
    for a in node.args:
        if isinstance(a, TensorArg):
            args.append(("targ", _tensor_sig(a.tensor), a.mode.name,
                         None if a.layout is None else a.layout.name))
        elif isinstance(a, DistTensor):
            args.append(("t", _tensor_sig(a)))
        elif isinstance(a, ReductionResult):
            args.append(("r", a.name, str(a.dtype), a.init))
        else:
            args.append(("v", _sig_value(a)))
    red = (None if node.reducer is None else
           (node.reducer.name, node.reducer.combine,
            _fn_sig(node.reducer.local)))
    res = (None if node.result is None else
           (node.result.name, str(node.result.dtype), node.result.init))
    sub = None if node.subgraph is None else _graph_sig(node.subgraph)
    return (node.kind, node.exec_kind.name, node.overlap, node.writes,
            tuple(args), None if node.fn is None else _fn_sig(node.fn),
            red, res, sub)


def _graph_sig(g: Graph):
    levels = tuple(tuple(_node_sig(n) for n in level) for level in g.levels)
    cond = None if g.condition is None else _fn_sig(g.condition)
    return ("graph", levels, cond)


def _segments_sig(segments):
    out = []
    for kind, payload in segments:
        if kind == "device":
            out.append(("device", tuple(
                tuple(_node_sig(n) for n in wave) for wave in payload)))
        elif kind == "host":
            out.append(("host", _node_sig(payload)))
        else:  # loop / host_loop: payload is the subgraph
            out.append((kind, _graph_sig(payload)))
    return tuple(out)


def plan_signature(executor: "Executor") -> tuple:
    """Structural identity of a plan: graph structure (node kinds, args,
    function code + closures — NOT auto-generated node names), tensor
    shapes/dtypes/layouts, schedule mode, device type, per-segment layout
    decisions, forced per-segment overrides and kernel tile overrides.
    Two executors with equal signatures compute identical values for
    identical inputs.  Tile overrides are part of the key because they
    change the kernels' launches (the autotuner's candidates never alias).
    The JAX package's signature also keys donation and the mesh, which
    the port has not."""
    plan = executor.plan
    return ("ripple-torch-plan-v3", executor.schedule,
            executor.device.type, _segments_sig(executor._segments),
            tuple(tuple(sorted((n, l.name) for n, l in seg.items()))
                  for seg in plan.per_segment),
            tuple(sorted((n, l.name) for n, l in plan.initial.items())),
            tuple(sorted(
                (si, n, l.name)
                for si, d in executor._segment_overrides.items()
                for n, l in d.items())),
            tuple(sorted((str(k), _sig_value(v))
                         for k, v in executor._tile_config.items())))


def layout_candidates(executor: "Executor") -> dict[str, tuple[Layout, ...]]:
    """The measured autotuner's layout search space
    (``repro_torch.tuning``).

    For every record state key that is neither user-pinned nor already
    forced by a layout override: the halo-feasible storage layouts
    (``core/layout.py``'s :func:`storage_candidates`, additionally
    clamped by every *access* of the key — any haloed access vetoes
    AoSoA for the shared storage, the solver's rule).  Keys with a single
    feasible layout are omitted: there is nothing to search."""
    no_aosoa: set[str] = set()
    seen: set[str] = set()
    for kind, payload in executor._segments:
        for node in _segment_nodes(kind, payload):
            for a in node.args:
                t = a.tensor if isinstance(a, TensorArg) else a
                if not isinstance(t, DistTensor) or not t.is_record:
                    continue
                seen.add(t.name)
                if _clamp_layout(t, Layout.AOSOA) is not Layout.AOSOA:
                    no_aosoa.add(t.name)
    out: dict[str, tuple[Layout, ...]] = {}
    for name in sorted(seen):
        t = executor.tensors[name]
        if t.pin_layout or name in executor._layout_overrides:
            continue
        cands = tuple(lay for lay in storage_candidates(t.space, t.halo,
                                                        t.partition)
                      if not (lay is Layout.AOSOA and name in no_aosoa))
        if len(cands) > 1:
            out[name] = cands
    return out


class Executor:
    """Run a Graph on one device.

    ``schedule`` is ``"dag"`` (dependency-DAG waves, default) or
    ``"sequential"`` (program order); both give the same state.
    ``layout_overrides`` forces a layout per record tensor for the whole
    plan, ``segment_layout_overrides`` per segment (segment index -> key ->
    layout), and ``tile_overrides`` forces kernel tiles (kernel name ->
    tile) while the nodes run.

    ``tune`` is ``"off"`` (the heuristics), ``"load"`` (apply a cached
    decision, heuristics on a miss, never measure) or ``"auto"`` (measure
    on a miss and persist): ``tune_budget`` bounds the search (a
    :class:`~repro_torch.tuning.search.TuneBudget` or a dict of its
    fields) and ``tune_inputs`` are the ``init_state`` overrides every
    candidate is timed on.

    Example::

        ex = Executor(graph)                  # on the GPU
        state = ex.run(ex.init_state(), steps=100)
        ex_cpu = Executor(graph, device="cpu")   # plain PyTorch versions
        ex = Executor(graph, tune="auto")     # measures once, persists
        print(ex.describe_tuning())           # what won, and why
    """

    def __init__(self, graph: Graph, device: Any = None, *,
                 layout_overrides: Optional[dict[str, Layout]] = None,
                 schedule: str = "dag",
                 segment_layout_overrides: Optional[
                     dict[int, dict[str, Layout]]] = None,
                 tile_overrides: Optional[dict[str, Any]] = None,
                 mesh: Any = None, tune: str = "off",
                 tune_budget: Optional[Any] = None,
                 tune_inputs: Optional[dict[str, Any]] = None,
                 regions: bool = False, async_regions: bool = False):
        if schedule not in ("dag", "sequential"):
            raise ValueError(
                f"schedule must be 'dag' or 'sequential', got {schedule!r}")
        if tune not in ("off", "load", "auto"):
            raise ValueError(
                f"tune must be 'off', 'load' or 'auto', got {tune!r}")
        if mesh is not None:
            raise NotImplementedError(f"mesh= is {_ITEM_MESH}")
        if regions:
            raise NotImplementedError(f"regions=True is {_ITEM_REGIONS}")
        if async_regions:
            raise NotImplementedError(
                f"async_regions=True is {_ITEM_ASYNC}")
        self.graph = graph
        self.device = resolve_device(device)
        self.schedule = schedule
        self.tensors = graph.all_tensors()
        self.results = graph.all_results()
        for t in self.tensors.values():
            if t.is_partitioned:
                raise NotImplementedError(
                    f"{t.name}: partitioned axis {t.partition} on a "
                    f"single-process executor — {_ITEM_MESH}")
        self.dag = schedule_lib.build_dag(graph)
        if schedule == "dag":
            self._segments = schedule_lib.dag_segments(self.dag)
        else:
            self._segments = schedule_lib.sequential_segments(graph)
            schedule_lib.place_units(self.dag, self._segments)
        self._layout_overrides = dict(layout_overrides or {})
        self._segment_overrides = {
            int(i): dict(v)
            for i, v in (segment_layout_overrides or {}).items()}
        self._tile_config = dict(tile_overrides or {})
        self._tune_inputs = dict(tune_inputs or {})
        self._build_plan()
        if tune != "off":
            from ..tuning.search import resolve_tuning

            decision = resolve_tuning(self, tune, budget=tune_budget)
            if decision.applied:
                # rebuild the plan under the measured-best configuration
                # (relayout steps and signature follow the tuned layouts
                # and tiles, per-segment assignments included)
                self._layout_overrides.update(decision.layouts)
                for si, d in decision.segment_layouts.items():
                    self._segment_overrides.setdefault(
                        int(si), {}).update(d)
                self._tile_config.update(decision.tiles)
                self._build_plan()
            self.plan.tuning = decision

    def _build_plan(self) -> None:
        """Solve layouts under the current overrides and derive what
        depends on them: the plan signature and the loop sub-executors.
        Run once at construction, and a second time when the autotuner
        commits a configuration that differs from the heuristics."""
        self.plan = solve_layouts(self._segments, self.tensors,
                                  overrides=self._layout_overrides,
                                  segment_overrides=self._segment_overrides)
        self.plan.dag = self.dag
        # physical layout of each record tensor's state entry right now
        self._state_layouts: dict[str, Layout] = dict(self.plan.initial)
        self._plan_sig = plan_signature(self)
        self.plan.signature = hashlib.sha1(
            repr(self._plan_sig).encode()).hexdigest()[:12]
        # conversions made at segment boundaries, loop bodies' included
        self.eager_relayouts = 0
        self._sub_execs: dict[int, Executor] = {}   # loop segment -> body

    # -- layout plumbing ---------------------------------------------------
    def _eff_in(self, t: DistTensor, layouts: dict[str, Layout]) -> DistTensor:
        """The tensor handle under an explicit layout assignment."""
        if not t.is_record:
            return t
        lay = layouts.get(t.name, t.layout)
        return t if lay is t.layout else t.with_(layout=lay)

    def _eff(self, t: DistTensor) -> DistTensor:
        """The tensor handle in its *current physical* layout."""
        return self._eff_in(t, self._state_layouts)

    def _apply_segment_layouts(self, state: dict, seg: int) -> dict:
        """Convert every tensor whose physical layout disagrees with the
        layout segment ``seg`` was solved for."""
        return self._convert_layouts(state, self.plan.per_segment[seg])

    def _restore_initial_layouts(self, state: dict) -> dict:
        """Undo trailing conversions so that outside a call every state
        dict is in the plan's initial layouts."""
        return self._convert_layouts(state, self.plan.initial)

    def _convert_layouts(self, state: dict,
                         targets: dict[str, Layout]) -> dict:
        for name, lay in targets.items():
            t = self.tensors[name]
            cur = self._state_layouts.get(name, t.layout)
            if cur is lay:
                continue
            state[name] = relayout(RecordArray(state[name], t.spec, cur),
                                   lay).data
            self._state_layouts[name] = lay
            self.eager_relayouts += 1
        return state

    # -- state management ------------------------------------------------
    def init_state(self, **overrides) -> dict[str, Any]:
        """Allocate all tensors/results on the executor's device (zeros
        unless overridden).  Record tensors are materialized in the layout
        the solver chose for their first consuming segment; an override in
        another layout is relayouted on the way in."""
        self._state_layouts = dict(self.plan.initial)
        state: dict[str, Any] = {}
        for name, t in self.tensors.items():
            eff = self._eff(t)
            if name in overrides:
                v = overrides[name]
                if isinstance(v, RecordArray):
                    data = relayout(v, eff.layout).data
                elif t.is_record:
                    v = _as_tensor(v)
                    src = self._infer_override_layout(t, v.shape)
                    data = relayout(RecordArray(v, t.spec, src),
                                    eff.layout).data
                else:
                    data = _as_tensor(v)
                state[name] = data.to(self.device)
            else:
                v = eff.init(self.device)
                state[name] = v.data if isinstance(v, RecordArray) else v
        for name, r in self.results.items():
            state[name] = torch.tensor(r.init, dtype=r.dtype,
                                       device=self.device)
        return state

    def _infer_override_layout(self, t: DistTensor, shape) -> Layout:
        """Which layout a raw (non-RecordArray) record override is stored
        in, by matching its shape against each layout's storage shape; an
        ambiguous match raises instead of guessing."""
        def fits(lay):
            return tuple(shape) == RecordArray.storage_shape(
                t.spec, t.space, lay)

        preferred = list(dict.fromkeys(
            [self.plan.initial.get(t.name, t.layout), t.layout]))
        matches = [lay for lay in preferred if fits(lay)]
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            raise ValueError(
                f"{t.name}: override shape {tuple(shape)} is ambiguous "
                f"between layouts {[m.name for m in matches]} for space "
                f"{t.space} — pass a RecordArray to make it explicit")
        others = [lay for lay in Layout
                  if lay not in preferred and fits(lay)]
        if len(others) == 1:
            return others[0]
        if others:
            raise ValueError(
                f"{t.name}: override shape {tuple(shape)} is ambiguous "
                f"between layouts {[m.name for m in others]} for space "
                f"{t.space} — pass a RecordArray to make it explicit")
        raise ValueError(
            f"{t.name}: override shape {tuple(shape)} matches no layout's "
            f"storage shape for space {t.space} "
            f"(pass a RecordArray to make the layout explicit)")

    def read(self, state: dict, t: DistTensor):
        """Wrap a state entry back into its RecordArray view (in the
        tensor's current physical layout)."""
        return self._eff(t).wrap(state[t.name])

    def describe_dag(self) -> str:
        """Render the dependency DAG, its segment/wave placement under the
        active schedule and the relayouts at each segment entry."""
        return self.plan.describe_dag()

    def describe_tuning(self) -> str:
        """Render the measured autotuner's decision for this plan
        (``plan.describe_tuning()``): baseline vs tuned steady-state
        times, every measured candidate, and what was committed."""
        return self.plan.describe_tuning()

    # -- node lowering -----------------------------------------------------
    def _resolve_args(self, node: Node, state: dict,
                      layouts: dict[str, Layout]):
        """The Python args passed to a node fn; haloed where needed."""
        vals = []
        for a in node.args:
            if isinstance(a, ReductionResult):
                vals.append(state[a.name])
                continue
            t = None
            mode = AccessMode.DEFAULT
            if isinstance(a, TensorArg):
                t, mode = a.tensor, a.mode
            elif isinstance(a, DistTensor):
                t = a
            if t is None:
                vals.append(a)
                continue
            t = self._eff_in(t, layouts)
            data = state[t.name]
            if mode.padded:
                data = _apply_halo(data, t)
            vals.append(t.wrap(data) if t.is_record else data)
        return vals

    @staticmethod
    def _write_tensors(node: Node) -> list[DistTensor]:
        return [node.args[i].tensor if isinstance(node.args[i], TensorArg)
                else node.args[i] for i in node.default_writes()]

    def _lower_split(self, node: Node, state: dict,
                     layouts: dict[str, Layout]) -> None:
        vals = self._resolve_args(node, state, layouts)
        out = node.fn(*vals)
        self._store_writes(node, state, self._write_tensors(node), out,
                           layouts)

    def _store_writes(self, node, state, write_tensors, out, layouts) -> None:
        if not write_tensors:
            return
        if len(write_tensors) == 1:
            out = (out,)
        if len(out) != len(write_tensors):
            raise ValueError(
                f"{node.name}: fn returned {len(out)} values for "
                f"{len(write_tensors)} writes")
        for t, v in zip(write_tensors, out):
            state[t.name] = self._coerce_write(t, v, layouts)

    def _coerce_write(self, t, v, layouts: dict[str, Layout]):
        """Raw storage for one written value: a RecordArray output in
        another layout than the segment's layout for ``t`` is converted."""
        if isinstance(v, RecordArray):
            if t.is_record:
                want = layouts.get(t.name, t.layout)
                if v.layout is not want:
                    v = relayout(v, want)
            return v.data
        return torch.as_tensor(v)

    def _lower_reduce(self, node: Node, state: dict,
                      layouts: dict[str, Layout]) -> None:
        t, field = node.args
        data = state[t.name]
        if t.is_record and field is not None:
            data = self._eff_in(t, layouts).wrap(data).field(field)
        local = torch.as_tensor(node.reducer.local(data))
        state[node.result.name] = local.to(device=self.device,
                                           dtype=node.result.dtype)

    def _lower_levels(self, levels, state: dict,
                      layouts: dict[str, Layout]) -> dict:
        state = dict(state)
        for level in levels:
            # paper: nodes on a level are independent -> run all against
            # the same input snapshot, then merge
            snapshot = dict(state)
            for node in level:
                if node.kind == "split":
                    tmp = dict(snapshot)
                    self._lower_split(node, tmp, layouts)
                    for k, v in tmp.items():
                        if k not in snapshot or v is not snapshot[k]:
                            state[k] = v
                elif node.kind == "reduce":
                    tmp = dict(snapshot)
                    self._lower_reduce(node, tmp, layouts)
                    state[node.result.name] = tmp[node.result.name]
                elif node.kind == "op":
                    tmp = dict(snapshot)
                    vals = self._resolve_args(node, tmp, layouts)
                    wt = self._write_tensors(node)
                    out = node.fn(*vals) if node.fn is not None else None
                    if wt:
                        self._store_writes(node, tmp, wt, out, layouts)
                        for t in wt:
                            state[t.name] = tmp[t.name]
                else:
                    raise ValueError(f"unexpected node kind {node.kind}")
        return state

    # -- conditional loops -------------------------------------------------
    def _sub_executor(self, i: int) -> "Executor":
        """The executor of loop segment ``i``'s body, built once per
        segment with the layouts the enclosing plan solved for it."""
        sub = self._sub_execs.get(i)
        if sub is None:
            sub = self._sub_execs[i] = Executor(
                self._segments[i][1], self.device,
                layout_overrides=self.plan.per_segment[i],
                schedule=self.schedule, tile_overrides=self._tile_config)
        return sub

    # -- execution -----------------------------------------------------------
    def _call_segments(self, state: dict) -> dict:
        """One pass: per segment, the boundary relayouts, then its waves
        (device), its callback after the device is idle (host), or its
        body while the predicate holds (loop, host_loop)."""
        for i, (kind, payload) in enumerate(self._segments):
            state = self._apply_segment_layouts(state, i)
            if kind == "device":
                with tile_scope(self._tile_config):
                    state = self._lower_levels(payload, state,
                                               dict(self._state_layouts))
            elif kind == "host":
                node: Node = payload
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                if node.fn is not None:
                    vals = self._resolve_args(
                        node, state, self._state_layouts) \
                        if node.args else []
                    node.fn(*vals)
            else:   # loop / host_loop: while semantics, the predicate
                # gates the first iteration too; bool() of a CUDA tensor
                # is one device-to-host read per check
                sub = self._sub_executor(i)
                before = sub.eager_relayouts
                while bool(payload.condition(state)):
                    state = sub(state)
                self.eager_relayouts += sub.eager_relayouts - before
        return state

    @contextmanager
    def _layout_epoch(self):
        """Incoming states are in the plan's initial layouts, and whatever
        happens inside (an exception included), the bookkeeping ends at
        initial again."""
        self._state_layouts = dict(self.plan.initial)
        try:
            yield
        finally:
            self._state_layouts = dict(self.plan.initial)

    def __call__(self, state: dict) -> dict:
        """Execute the graph once; returns the new state dict."""
        with self._layout_epoch():
            state = self._call_segments(dict(state))
            return self._restore_initial_layouts(dict(state))

    def run(self, state: dict, steps: int) -> dict:
        """Execute the whole graph ``steps`` times (graphs are built once,
        executed many — paper §5.3)."""
        if steps <= 0:
            return state
        with self._layout_epoch():
            state = dict(state)
            for _ in range(steps):
                state = self._call_segments(state)
            return self._restore_initial_layouts(dict(state))


def execute(graph: Graph, device: Any = None, steps: int = 1,
            **state_overrides) -> dict:
    """One-shot convenience: init state, run ``steps`` times, return the
    final state."""
    ex = Executor(graph, device)
    return ex.run(ex.init_state(**state_overrides), steps)
