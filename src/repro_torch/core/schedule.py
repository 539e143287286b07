"""Dependency-aware DAG scheduling of Ripple graphs (paper §5.3/§6).

Pure Python over the port's ``Graph``; the scheduling logic is the JAX
package's, so both packages give the same units, edges and waves for the
same graph.  The single-process executor runs each device segment eagerly,
wave by wave; the region functions below group segments for the fused
executables that ROADMAP item 7(b) brings to the port.

The paper's central claim is that a simple graph description lets the
runtime schedule work and transfers from *real data dependencies* rather
than program order.  The :class:`~repro_torch.core.graph.Graph` builder
records a level structure (program order); this module recovers the true
dependency DAG from each node's access footprint and re-schedules it:

* :func:`build_dag` flattens a graph (inlining non-conditional
  subgraphs, keeping conditional subgraphs as single ``loop`` vertices)
  into :class:`DagUnit` s and derives :class:`DagEdge` s from the
  read/write state-key sets — RAW (true dependency), WAW (output
  ordering) and WAR (anti-dependency, because the executor updates state
  buffers in place).  Nodes on the same builder level are independent by
  the paper's contract (they execute against a shared snapshot), so no
  edges are created between them.
* :func:`dag_segments` list-schedules the DAG into executor segments:
  every *antichain* of ready device units becomes one wave, consecutive
  waves fuse into a single device segment, and host / sync / loop
  vertices are emitted only where a dependency path actually forces a
  break.  Relayout steps and halo-transfer blocks attach at segment
  entry, so fusing two program levels into one segment hoists a
  consumer's conversions and transfers to the earliest point its
  producer is ready.
* :func:`sequential_segments` is the legacy program-order segmentation
  (every level boundary is a barrier, every host node splits the chain)
  — the ``schedule="sequential"`` escape hatch and the reference
  semantics the property tests compare against.

Conservative footprints keep the schedule sound where the graph cannot
be introspected:

* a ``conditional`` subgraph's predicate is an opaque callable over the
  state dict, so loop vertices read *everything* (:data:`READS_ANY`);
* ``sync()`` is a full barrier by contract;
* a host node without tensor args has an invisible footprint and is
  pinned as a barrier too;
* host vertices keep their relative program order (side effects).
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

from .graph import ExecutionKind, Graph, Node, TensorArg
from .tensor import DistTensor, ReductionResult

__all__ = [
    "READS_ANY",
    "DagUnit",
    "DagEdge",
    "Region",
    "RegionEdge",
    "ScheduleDag",
    "node_access",
    "graph_access",
    "build_dag",
    "dag_segments",
    "group_regions",
    "region_access",
    "region_dag",
    "region_waves",
    "sequential_segments",
    "place_units",
]

# Sentinel state key: the unit may read ANY state entry (opaque predicate
# or callback); it conflicts with every writer.
READS_ANY = "<any>"


def node_access(node: Node) -> tuple[frozenset, frozenset]:
    """The (reads, writes) state-key footprint of one non-subgraph node.

    Reads are every tensor / reduction-result argument (a written tensor
    is also passed to the node fn, so it counts as read — conservative
    and correct for pure-output args).  Writes are the ``writes``
    argument indices for device op/split nodes and the result slot for
    reduce nodes.  Host nodes never store writes (the executor calls
    their fn for its side effects only), so their write set is empty.
    """
    if node.kind == "reduce":
        t, _field = node.args
        return frozenset({t.name}), frozenset({node.result.name})
    reads = set()
    for a in node.args:
        if isinstance(a, TensorArg):
            reads.add(a.tensor.name)
        elif isinstance(a, DistTensor):
            reads.add(a.name)
        elif isinstance(a, ReductionResult):
            reads.add(a.name)
    writes = set()
    host = node.exec_kind is ExecutionKind.Cpu or node.kind == "sync"
    if not host and node.fn is not None:
        for i in node.default_writes():
            a = node.args[i]
            t = a.tensor if isinstance(a, TensorArg) else a
            if isinstance(t, DistTensor):
                writes.add(t.name)
    return frozenset(reads), frozenset(writes)


def graph_access(g: Graph) -> tuple[frozenset, frozenset]:
    """Union footprint of every node in ``g`` (subgraphs included)."""
    reads, writes = set(), set()
    for node in g.nodes():
        if node.subgraph is not None:
            r, w = graph_access(node.subgraph)
        else:
            r, w = node_access(node)
        reads |= r
        writes |= w
    return frozenset(reads), frozenset(writes)


@dataclass
class DagUnit:
    """One schedulable vertex: a device node, a host/sync node, or a
    whole conditional subgraph (``loop`` / ``host_loop``).

    ``level`` is the flattened builder level — units sharing it execute
    against a common snapshot (the paper's same-level parallelism), so
    they never get edges between each other.  ``segment`` / ``wave`` are
    filled in by the scheduler (or :func:`place_units` for the
    sequential schedule) for introspection.
    """

    uid: int
    kind: str                    # 'device' | 'host' | 'sync' | 'loop' | 'host_loop'
    level: int
    reads: frozenset
    writes: frozenset
    node: Optional[Node] = None
    subgraph: Optional[Graph] = None
    barrier: bool = False        # orders against *everything* (sync, opaque host)
    segment: int = -1
    wave: int = -1

    @property
    def label(self) -> str:
        if self.node is not None:
            return f"{self.node.name}[{self.node.kind}]"
        return f"{self.subgraph.name}[{self.kind}]"

    def _fmt_keys(self, keys) -> str:
        return ",".join(sorted(k if k is not READS_ANY else "*"
                               for k in keys)) or "-"

    def describe(self) -> str:
        return (f"{self.label} reads({self._fmt_keys(self.reads)}) "
                f"writes({self._fmt_keys(self.writes)})")


@dataclass(frozen=True)
class DagEdge:
    """A scheduling constraint ``src -> dst`` (uids, program order).

    ``reason`` is 'raw' (dst reads what src wrote), 'waw', 'war' (dst
    overwrites what src reads — state updates are in place), 'barrier'
    (sync / opaque host node) or 'host-order' (host side effects keep
    program order).  ``key`` names the state entry that carries the
    dependency where one exists.
    """

    src: int
    dst: int
    reason: str
    key: Optional[str] = None


def _conflict(u: DagUnit, v: DagUnit) -> Optional[tuple[str, Optional[str]]]:
    """Data conflict between ``u`` (earlier) and ``v`` (later), if any."""
    def hit(ws, rs):
        if not ws:
            return None
        if READS_ANY in rs:
            return next(iter(sorted(ws)))
        inter = ws & rs
        return next(iter(sorted(inter))) if inter else None

    k = hit(u.writes, v.reads)
    if k is not None:
        return ("raw", k)
    inter = u.writes & v.writes
    if inter:
        return ("waw", next(iter(sorted(inter))))
    k = hit(v.writes, u.reads)
    if k is not None:
        return ("war", k)
    return None


class ScheduleDag:
    """The dependency DAG of one graph plus its (mode-dependent)
    placement into executor segments.

    ``units`` are in program order; ``edges`` always point forward.
    After :func:`dag_segments` or :func:`place_units` each unit carries
    its ``(segment, wave)`` placement and ``segment_kinds`` names each
    segment's kind, which :meth:`describe` renders.
    """

    def __init__(self, graph: Graph, units: list[DagUnit],
                 edges: list[DagEdge]):
        self.graph = graph
        self.units = units
        self.edges = edges
        self.preds: dict[int, set[int]] = {u.uid: set() for u in units}
        self.succs: dict[int, set[int]] = {u.uid: set() for u in units}
        for e in edges:
            self.preds[e.dst].add(e.src)
            self.succs[e.src].add(e.dst)
        self.segment_kinds: list[str] = []

    @property
    def device_only(self) -> bool:
        """True iff every vertex is a device node (no host, sync or loop
        vertex breaks the graph)."""
        return all(u.kind == "device" for u in self.units)

    def antichains(self) -> list[list[DagUnit]]:
        """The scheduled waves (unit groups that share a segment+wave),
        in execution order."""
        by_pos: dict[tuple[int, int], list[DagUnit]] = defaultdict(list)
        for u in self.units:
            by_pos[(u.segment, u.wave)].append(u)
        return [sorted(by_pos[k], key=lambda u: u.uid)
                for k in sorted(by_pos)]

    def fused_antichains(self) -> list[list[DagUnit]]:
        """Waves holding >= 2 independent nodes — the fusion the DAG
        schedule found that program order would have serialized (or, for
        same-level nodes, kept but in separate segments)."""
        return [w for w in self.antichains() if len(w) >= 2]

    # -- rendering ---------------------------------------------------------
    def describe(self, plan=None) -> str:
        """Human-readable schedule: segments -> waves -> units, then the
        dependency edges, then (given a LayoutPlan) the relayout steps
        and halo-transfer blocks hoisted to each segment's entry."""
        nseg = len(self.segment_kinds)
        lines = [f"DAG schedule for graph {self.graph.name!r}: "
                 f"{len(self.units)} units, {len(self.edges)} edges, "
                 f"{nseg} segments"]
        by_seg: dict[int, dict[int, list[DagUnit]]] = defaultdict(
            lambda: defaultdict(list))
        for u in self.units:
            by_seg[u.segment][u.wave].append(u)
        for si in sorted(by_seg):
            kind = (self.segment_kinds[si]
                    if 0 <= si < nseg else "?")
            lines.append(f"segment {si} ({kind}):")
            for wi in sorted(by_seg[si]):
                wave = sorted(by_seg[si][wi], key=lambda u: u.uid)
                tag = f"  wave {wi}"
                if len(wave) >= 2:
                    tag += f" [antichain x{len(wave)}]"
                lines.append(tag + ":")
                lines.extend(f"    {u.describe()}" for u in wave)
        if self.edges:
            lines.append("edges:")
            by_uid = {u.uid: u for u in self.units}
            for e in self.edges:
                via = f" via {e.key}" if e.key else ""
                lines.append(f"  {by_uid[e.src].label} -> "
                             f"{by_uid[e.dst].label} ({e.reason}{via})")
        if plan is not None:
            for st in plan.relayouts:
                lines.append(f"relayout before seg{st.segment}: "
                             f"{st.tensor} {st.src.name}->{st.dst.name}")
            by_ht: dict[tuple[int, str], list] = defaultdict(list)
            for h in getattr(plan, "halo_transfers", ()):
                by_ht[(h.segment, h.tensor)].append(h)
            for (si, tensor), hs in sorted(by_ht.items()):
                sends = sum(1 for h in hs if h.mesh_axis)
                nbytes = sum(h.nbytes for h in hs)
                mode = ("overlapped" if any(h.overlapped for h in hs)
                        else "sync")
                lines.append(
                    f"seg{si} transfers: {tensor} {len(hs)} blocks "
                    f"({sends} copies, {nbytes} bytes, {mode}) "
                    f"hoisted to segment entry")
            if getattr(plan, "regions", None):
                graphs = getattr(plan, "region_graphs", None)
                lines.append("regions (captured graphs):" if graphs
                             is not None else "regions (regions=False: "
                             "each segment dispatched eagerly):")
                lines.extend("  " + r.describe((graphs or {}).get(r.index))
                             for r in plan.regions)
            if getattr(plan, "signature", ""):
                cache = getattr(plan, "cache", None)
                line = f"plan signature {plan.signature}"
                if cache is not None:
                    line += (f" — executable cache: "
                             f"{len(cache.executables)} executables, "
                             f"{cache.builds} builds, {cache.hits} reuse "
                             f"hits, {cache.trace_events} captures")
                lines.append(line)
        return "\n".join(lines)


def build_dag(graph: Graph) -> ScheduleDag:
    """Flatten ``graph`` into units and derive every dependency edge.

    Mirrors the sequential walk's flattening: non-conditional subgraphs
    are inlined (their levels become fresh levels — same-level snapshot
    semantics never spans a subgraph boundary), conditional subgraphs
    become single ``loop`` / ``host_loop`` vertices.
    """
    units: list[DagUnit] = []
    level_counter = itertools.count()

    def walk(g: Graph) -> None:
        for level in g.levels:
            lid = next(level_counter)
            for node in level:
                if node.kind == "subgraph":
                    walk(node.subgraph)
                    lid = next(level_counter)
                elif node.kind == "loop":
                    r, w = graph_access(node.subgraph)
                    kind = ("loop" if node.subgraph.is_device_only()
                            else "host_loop")
                    # the while predicate is an opaque callable over the
                    # full state dict: conservatively reads everything
                    units.append(DagUnit(
                        len(units), kind, next(level_counter),
                        reads=frozenset(r | {READS_ANY}), writes=w,
                        subgraph=node.subgraph))
                    lid = next(level_counter)
                else:
                    r, w = node_access(node)
                    if node.kind == "sync":
                        units.append(DagUnit(
                            len(units), "sync", lid, reads=r, writes=w,
                            node=node, barrier=True))
                    elif node.exec_kind is ExecutionKind.Cpu:
                        # a host callback with no tensor args has an
                        # invisible footprint: keep it where it is
                        units.append(DagUnit(
                            len(units), "host", lid, reads=r, writes=w,
                            node=node, barrier=not r))
                    else:
                        units.append(DagUnit(
                            len(units), "device", lid, reads=r, writes=w,
                            node=node))

    walk(graph)

    edges: list[DagEdge] = []
    for j, v in enumerate(units):
        for i in range(j):
            u = units[i]
            same_level = u.level == v.level
            both_device = u.kind == "device" and v.kind == "device"
            if same_level and both_device:
                # paper contract: same-level device nodes execute against
                # a shared snapshot — grouped into one wave, never edged
                continue
            c = _conflict(u, v)
            if c is not None:
                edges.append(DagEdge(u.uid, v.uid, c[0], c[1]))
            elif u.barrier or v.barrier:
                edges.append(DagEdge(u.uid, v.uid, "barrier"))
    # host side effects (checkpoint callbacks, prints) keep program order
    hosts = [u for u in units if u.kind in ("host", "sync", "host_loop")]
    edged = {(e.src, e.dst) for e in edges}
    for a, b in zip(hosts, hosts[1:]):
        if (a.uid, b.uid) not in edged:
            edges.append(DagEdge(a.uid, b.uid, "host-order"))
    edges.sort(key=lambda e: (e.src, e.dst))
    return ScheduleDag(graph, units, edges)


def dag_segments(dag: ScheduleDag) -> list[tuple]:
    """List-schedule the DAG into executor segments.

    Greedy maximal-antichain packing: while any device unit is ready,
    all ready device units form one wave and the segment keeps growing
    (cross-level fusion — one segment instead of one per level);
    only when no device unit is ready does a host / loop vertex run,
    breaking the segment exactly where a dependency path demands it.

    Same-level device units with conflicting footprints are pre-grouped
    so they always land in one wave: the executor lowers a wave against
    a shared snapshot, which is the semantics their level promised.
    """
    units = dag.units
    parent = list(range(len(units)))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    by_level: dict[int, list[DagUnit]] = defaultdict(list)
    for u in units:
        if u.kind == "device":
            by_level[u.level].append(u)
    for level_units in by_level.values():
        for a, b in itertools.combinations(level_units, 2):
            if _conflict(a, b) is not None:
                parent[find(a.uid)] = find(b.uid)

    groups: dict[int, list[DagUnit]] = defaultdict(list)
    for u in units:
        groups[find(u.uid)].append(u)
    gid_of = {u.uid: find(u.uid) for u in units}
    gpreds: dict[int, set[int]] = {g: set() for g in groups}
    for e in dag.edges:
        gs, gd = gid_of[e.src], gid_of[e.dst]
        if gs != gd:
            gpreds[gd].add(gs)

    segments: list[tuple] = []
    kinds: list[str] = []
    waves: list[list[DagUnit]] = []
    pending = set(groups)

    def flush() -> None:
        nonlocal waves
        if not waves:
            return
        si = len(segments)
        for wi, wave in enumerate(waves):
            for u in wave:
                u.segment, u.wave = si, wi
        segments.append(("device", [[u.node for u in wave]
                                    for wave in waves]))
        kinds.append("device")
        waves = []

    while pending:
        ready = [g for g in pending
                 if all(p not in pending for p in gpreds[g])]
        dev = [g for g in ready if groups[g][0].kind == "device"]
        if dev:
            wave = sorted((u for g in dev for u in groups[g]),
                          key=lambda u: u.uid)
            waves.append(wave)
            pending -= set(dev)
            continue
        flush()
        g = min(ready, key=lambda g: groups[g][0].uid)
        u = groups[g][0]
        u.segment, u.wave = len(segments), 0
        if u.kind in ("host", "sync"):
            segments.append(("host", u.node))
        elif u.kind == "loop":
            segments.append(("loop", u.subgraph))
        else:
            segments.append(("host_loop", u.subgraph))
        kinds.append(u.kind if u.kind != "sync" else "host")
        pending.discard(g)
    flush()
    dag.segment_kinds = kinds
    return segments


@dataclass(frozen=True)
class Region:
    """A maximal run of consecutive segments the region compiler fuses
    into ONE fused executable (``kind == 'device'``: device and device
    ``loop`` segments, with their boundary relayouts and halo glue traced
    inside), or a single host-side segment that must run eagerly between
    executables (``'host'`` — a callback/sync; ``'host_loop'`` — a
    conditional subgraph containing host nodes).

    ``start``/``stop`` are the half-open segment-index span in the
    executor's segment list."""

    index: int
    kind: str            # 'device' | 'host' | 'host_loop'
    start: int
    stop: int

    def __len__(self) -> int:
        return self.stop - self.start

    @property
    def segments(self) -> range:
        return range(self.start, self.stop)

    def describe(self, graphs: Optional[int] = None) -> str:
        """One line; ``graphs`` is how many captured graphs a device
        region runs as (a loop-free run of segments is one, each loop body
        one more)."""
        span = (f"seg{self.start}" if len(self) == 1
                else f"seg{self.start}..seg{self.stop - 1}")
        n = len(self)
        tail = ""
        if self.kind == "device" and graphs is not None:
            tail = f" -> {graphs} graph{'s' if graphs != 1 else ''}"
        return (f"region {self.index} ({self.kind}): {span} "
                f"({n} segment{'s' if n != 1 else ''}{tail})")


def group_regions(segment_kinds: list[str]) -> list[Region]:
    """Group a segment-kind list into maximal fusable regions.

    Consecutive ``device`` / ``loop`` segments form one ``device`` region
    (the region compiler lowers the whole run — segment bodies, boundary
    relayouts, while-loops — to a single program, so repeated
    execution pays one dispatch per region instead of one per segment
    plus eager Python relayout glue).  ``host`` and ``host_loop``
    segments are hard breaks: each is its own region and runs eagerly."""
    regions: list[Region] = []
    i = 0
    while i < len(segment_kinds):
        if segment_kinds[i] in ("device", "loop"):
            j = i
            while j < len(segment_kinds) and \
                    segment_kinds[j] in ("device", "loop"):
                j += 1
            regions.append(Region(len(regions), "device", i, j))
            i = j
        else:
            regions.append(Region(len(regions), segment_kinds[i], i, i + 1))
            i += 1
    return regions


@dataclass(frozen=True)
class RegionEdge:
    """A scheduling constraint between two regions (by region index).

    Lifted from the unit-level :class:`DagEdge` s: a region edge exists
    wherever any unit placed in ``src`` constrains any unit placed in
    ``dst``.  ``reason`` keeps the strongest lifted reason (data reasons
    beat ordering reasons) and ``key`` the state entry carrying it, so
    ``plan.describe()`` can explain WHY the async dispatcher must wait.
    Regions without an edge (direct or transitive) are independent: the
    event-driven runtime may have both in flight at once.
    """

    src: int
    dst: int
    reason: str
    key: Optional[str] = None


# when several unit edges lift onto one region edge, keep the most
# informative reason: true data dependencies beat ordering constraints
_REGION_REASON_RANK = {"raw": 0, "waw": 1, "war": 2,
                       "barrier": 3, "host-order": 4}


def _segment_to_region(regions: list[Region]) -> dict[int, int]:
    return {s: r.index for r in regions for s in r.segments}


def region_access(dag: ScheduleDag,
                  regions: list[Region]) -> dict[int, tuple]:
    """Per-region footprint: ``index -> (reads, writes, barrier)``.

    The union of the member units' footprints (the same sets
    :func:`build_dag` derived), plus whether any member is a barrier —
    a barrier region (``sync()``, opaque host callback) forces the async
    dispatcher to drain every in-flight callback before it runs."""
    seg2r = _segment_to_region(regions)
    acc: dict[int, list] = {r.index: [set(), set(), False] for r in regions}
    for u in dag.units:
        ri = seg2r.get(u.segment)
        if ri is None:
            continue
        acc[ri][0] |= u.reads
        acc[ri][1] |= u.writes
        acc[ri][2] = acc[ri][2] or u.barrier
    return {i: (frozenset(r), frozenset(w), b)
            for i, (r, w, b) in acc.items()}


def region_dag(dag: ScheduleDag,
               regions: list[Region]) -> list[RegionEdge]:
    """Lift the unit-level dependency edges to the region level.

    Every :class:`DagEdge` whose endpoints landed in different regions
    becomes (after dedup) one :class:`RegionEdge` — so the region DAG
    inherits exactly the RAW/WAW/WAR/barrier/host-order analysis that
    :func:`build_dag` already performed, rather than recomputing
    footprints.  Units are placed before this is called (via
    :func:`dag_segments` or :func:`place_units`); edges between units of
    one region vanish (they are honored inside the fused executable)."""
    seg2r = _segment_to_region(regions)
    best: dict[tuple[int, int], RegionEdge] = {}
    for e in dag.edges:
        rs = seg2r.get(dag.units[e.src].segment)
        rd = seg2r.get(dag.units[e.dst].segment)
        if rs is None or rd is None or rs == rd:
            continue
        if rs > rd:          # unit edges point forward; defensive only
            rs, rd = rd, rs
        cur = best.get((rs, rd))
        if cur is None or (_REGION_REASON_RANK[e.reason]
                           < _REGION_REASON_RANK[cur.reason]):
            best[(rs, rd)] = RegionEdge(rs, rd, e.reason, e.key)
    return [best[k] for k in sorted(best)]


def region_waves(regions: list[Region],
                 edges: list[RegionEdge]) -> list[list[int]]:
    """Kahn layering of the region DAG into ready waves.

    Wave ``k`` holds every region whose predecessors all sit in earlier
    waves — the ready-set order the async dispatcher walks, and the
    "ready waves of regions" view ``plan.describe()`` renders.  Two
    regions sharing a wave have no dependency path between them: the
    runtime may overlap them (e.g. a host callback runs on the pool
    while the next device region is already dispatched)."""
    preds: dict[int, set[int]] = {r.index: set() for r in regions}
    for e in edges:
        preds[e.dst].add(e.src)
    done: set[int] = set()
    pending = [r.index for r in regions]
    waves: list[list[int]] = []
    while pending:
        ready = [i for i in pending if preds[i] <= done]
        if not ready:        # unreachable (edges point forward); safety
            ready = [pending[0]]
        waves.append(ready)
        done.update(ready)
        pending = [i for i in pending if i not in done]
    return waves


def sequential_segments(graph: Graph) -> list[tuple]:
    """Legacy program-order segmentation (the ``schedule="sequential"``
    escape hatch): every builder level is a wave in program order,
    consecutive device levels fuse, host / sync / loop nodes break the
    chain wherever they appear."""
    segments: list[tuple] = []
    device_levels: list[list[Node]] = []

    def flush() -> None:
        nonlocal device_levels
        if device_levels:
            segments.append(("device", device_levels))
            device_levels = []

    def walk(g: Graph) -> None:
        nonlocal device_levels
        for level in g.levels:
            dev_nodes: list[Node] = []
            for node in level:
                if node.kind == "subgraph":
                    if dev_nodes:
                        device_levels.append(dev_nodes)
                        dev_nodes = []
                    walk(node.subgraph)
                elif node.kind == "loop":
                    if dev_nodes:
                        device_levels.append(dev_nodes)
                        dev_nodes = []
                    flush()
                    segments.append((
                        "loop" if node.subgraph.is_device_only()
                        else "host_loop", node.subgraph))
                elif (node.kind == "sync"
                        or node.exec_kind is ExecutionKind.Cpu):
                    if dev_nodes:
                        device_levels.append(dev_nodes)
                        dev_nodes = []
                    flush()
                    segments.append(("host", node))
                else:
                    dev_nodes.append(node)
            if dev_nodes:
                device_levels.append(dev_nodes)

    walk(graph)
    flush()
    return segments


def place_units(dag: ScheduleDag, segments: list[tuple]) -> None:
    """Record each unit's (segment, wave) placement for a segmentation
    produced outside :func:`dag_segments` (the sequential path), so
    :meth:`ScheduleDag.describe` renders either schedule.

    Placements are matched FIFO per object identity: the same subgraph
    object may legally appear several times in one graph, and both the
    unit list and the segment list are in program order."""
    pos: dict[int, list[tuple[int, int]]] = {}
    kinds: list[str] = []
    for si, (kind, payload) in enumerate(segments):
        kinds.append(kind)
        if kind == "device":
            for wi, wave in enumerate(payload):
                for n in wave:
                    pos.setdefault(id(n), []).append((si, wi))
        else:  # host: payload is the node; loop/host_loop: the subgraph
            pos.setdefault(id(payload), []).append((si, 0))
    for u in dag.units:
        key = id(u.node if u.node is not None else u.subgraph)
        slots = pos.get(key)
        u.segment, u.wave = slots.pop(0) if slots else (-1, -1)
    dag.segment_kinds = kinds
