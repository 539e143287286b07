"""Graph executor (paper §6) — runs a Ripple Graph on one GPU.

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
* padded (halo) accesses get their halo cells before the node runs: from
  the tensor's boundary policy, and on a mesh from the neighbour shards
  (``core/halo.py``'s transfer schedule; below);
* host (Cpu) nodes and ``sync()`` wait for the device, then run their
  callback — on the host pool by default (below).

The defaults are the reference's: ``regions=True`` and ``donate=True``.
With ``regions=False`` (the escape hatch) every segment runs eagerly: node
functions are called in wave order, each wave against a snapshot of the
state — the reference's per-segment dispatch (its ``regions=False``
path).  Node functions return new tensors and never write a state buffer
in place, so a caller's state dict is never modified.

**Region compile** (``regions=True``, the default).  The plan's segments
are grouped into regions (``schedule.group_regions``): runs of
``device`` and ``loop`` segments, and each ``host`` / ``host_loop``
segment alone.  The reference lowers a device region to ONE executable
with its loops as ``lax.while_loop``; CUDA graphs have no data-dependent
loop, so here a device region is k pieces, which ``describe_dag()``
prints: each maximal loop-free run of segments (with the boundary
relayouts and halo fills between them) is one graph, and each loop body
is one graph, replayed while the host predicate holds (one
device-to-host read per check, as eagerly).  On the card a piece's first
run executes its segments eagerly on a side stream (so that ``nvcc``
builds and first-launch set-up happen outside capture; this is that
call's result), then captures them into a ``torch.cuda.CUDAGraph``;
every later run replays it.  On the CPU a piece runs its segments
through the same code and the same buffers, without capture.  Either
way:

* each graph reads from, and writes into, **static buffers** (one per
  state key, storage shape and dtype; a partitioned key has one per
  shard, on the shard's device) that belong to the executable-cache
  entry, shared by every piece of the plan, so that pieces chain without
  copies.  A state value that is not its buffer is copied in before the
  first piece that reads it;
* **outputs in place** (the reference's donation aliasing): a node whose
  function takes ``out=`` gets, as ``out``, the static buffer of each key
  it writes (a record wrapped in the segment's layout; a tuple for
  several keys, None where refused), and K1-K5's wrappers, the KV cache
  writes and the reducers' max/min write there, when (i) no other node of
  its level reads a value that lies in the buffer (a level runs against
  one snapshot), (ii) where the node itself reads the buffer (its own
  arg of the key, not through a padded copy), its function is marked
  :func:`~repro_torch.core.graph.in_place` (K1-K3 and the KV writes read
  each element before they write it) and no other arg of it lies there,
  (iii) no other key's value lies in the buffer (a value a later node,
  piece, host callback or the caller still reads), and (iv) the buffer
  is stored in the layout of the node's record args of its type (a
  kernel writes ``out`` in its input's layout).  On a mesh the
  per-shard programs write their shard's buffer; the overlapped lowering
  stitches its interior and strip outputs into it;
* every other output is a new tensor, copied into its key's buffer at the
  end of the graph (``cache_stats()``'s ``copy_backs`` and
  ``copy_back_bytes``): the copies aliasing forces.  They are ordered by
  their aliasing: an output that IS another key's buffer is copied before
  that buffer is written, and a cycle is broken through a temporary.  The
  main path's graphs copy nothing back; the eikonal body's first node
  copies ``phi`` into ``phi_prev``'s buffer itself, so that the sweep
  writes ``phi``'s buffer;
* **donation**: with ``donate=False`` the caller's tensors are never
  modified and a returned tensor is never overwritten later — a call
  copies in what its graphs read and clones out what they wrote, once a
  call (not per step or loop iteration).  With ``donate=True`` (the
  default) a call returns *aliases* of the static buffers: new tensor
  objects over the buffers' storage, which the entry holds weakly as its
  live state.  The reference's contract holds: (1) the caller's input is
  never written, it is copied in; (2) a returned state passed back (each
  key its own alias) is donated: the call skips its copy-in, and the
  caller must not use it again; (3) a returned state that is not passed
  back keeps its values whatever later calls of this or another executor
  of the same signature do: a call whose input is not the live state
  first moves each live alias out, re-pointing it (``Tensor.set_``) onto
  a clone of its buffer (``cache_stats()["moved_out"]``); an alias nobody
  holds any more costs nothing; (4) an in-place write into a returned
  state before it is passed back lands in the buffers (the batcher's
  admission).  So a steady loop ``state = ex.run(state, n)`` copies
  nothing, and only a switch between states costs one copy.  A view
  taken of a returned tensor (a slice, ``.view()``, ``.numpy()``, a
  record's field) lies in the buffer and cannot be re-pointed: a call
  that would move its state out raises ``RuntimeError`` naming the key
  rather than overwrite what the view shows (clone what you keep).
  Two live executors of one signature called in turn therefore move a
  whole state out and copy one in on every call;
* nothing falls back: a capture that fails (a node that syncs the host,
  ``.item()`` or ``bool()`` of a CUDA tensor, inside a device region)
  raises an error naming the piece and the node.  Host regions run
  between graphs: on the host pool (async regions, below) or, with
  ``async_regions=False``, on the caller after the device is idle.

The **executable cache** is process-wide, keyed by :func:`plan_signature`
and the device (a captured graph belongs to one device): a second
executor with an equal signature reuses the region programs, their
graphs and their buffers with zero captures (``cache_stats()``), under
either ``donate`` (the live state moves out as above).  A captured
graph reads the tensors in its nodes' closures (a model's weights), so
an entry lives while an executor uses it or while every graph it was
built from lives: once no executor holds it and one of those graphs is
collected, the entry goes, with its graphs, buffers and pool; aliases
that outlive it keep their storage, not the entry.  An incoming tensor
that lies in another key's static buffer (a view of a returned tensor)
is cloned when the call starts, before any buffer is written; a live
alias passed under another key is moved out first, so it is copied in
like any tensor.

A conditional subgraph (paper §5.3.6) is a ``loop`` segment, or a
``host_loop`` when its body holds a host node; both run with while
semantics through a sub-executor built once per segment with the
enclosing ``regions`` and ``donate``.

The **measured autotuner** (``tune="auto"`` / ``"load"``,
``repro_torch.tuning.search``) times candidate layouts and kernel tiles as
real runs of fresh executors, commits the fastest and persists it in the
tuning cache keyed by the heuristic plan's :func:`plan_signature` (the
structural identity of a plan: graph structure, node function code and
closures, shapes, dtypes, layouts, schedule, donation, device type,
overrides, tiles), so a second process over an identical graph loads the
decision with zero measurements.

**Async regions** (``async_regions=True``, the default; it applies under
``regions=True`` when the plan has a host region).  Device regions are
issued without waiting for the card, and each non-barrier host region's
callback is queued for a process-wide pool of 4 ``ripple-host`` threads,
where one task at a time runs a call's queue in program order: a
callback runs on a side stream of its thread, which waits, on the card,
for a CUDA event recorded after its arguments on the dispatching stream
(never for the whole device).
Every argument that lies in a static buffer is cloned on the dispatching
stream at submit time, whatever ``donate`` says: the next replay
overwrites the buffer while the callback may still read.  A barrier host
region (``sync()``, a callback without tensor args) and a ``host_loop``
drain the pool first; so does a piece's build on the card (a capture must
not see another thread's device-to-host read).  ``run()`` drains before
it returns and re-raises the first failure in program order, its
successors cancelled.  ``host_timeout`` (seconds) bounds every wait on a
callback: past it the call raises :class:`HostTimeoutError` (transient)
and cancels the callbacks not yet started; a hung thread keeps its pool
slot until it returns, and the executor stays usable.  Results equal
``async_regions=False``'s bit for bit; the flag is not in the plan
signature (both modes replay the same graphs).

**Tracing** (``core/trace.py``).  While a ``torch.profiler`` session
records, the executor records spans where the work happens, each a
user range in the profiler's trace (the device's clock) and a record
that ``trace.session()`` returns: ``ripple.call`` (one
``run()``; its id is the call id every span of the call carries),
``ripple.predicate`` (a loop's check, its device-to-host read included)
and ``ripple.iteration`` (one pass of a loop's body) at every
while-loop, ``ripple.launch`` (a built piece's staging and replay, on the
CPU its eager run; its label and the bytes staged; on the card one
launch in ``trace.EVERY`` gets ``gap_us``, the device's wait for the
host before it, from a timing event after the previous replay and one
before its own),
``ripple.build`` (a piece's eager run and capture), ``ripple.halo`` (a
padded copy's assembly, with its ``bytes`` and the record's ``fields``,
where it runs on the host: in a build, with ``regions=False``, and in
the CPU's launches; a replay's copies are nodes of its graph),
``ripple.submit`` (a
callback's snapshots and event), ``ripple.callback`` (the callback on the
pool thread, with its submit's id) and ``ripple.wait`` (``kind``: the
in-flight ``cap``, a ``drain`` or a ``barrier``).  Off, each site reads
the profiler's flag and allocates nothing; on, a timed launch's ``go``
record and the spans between the predicate's read and the replay lie in
the device's wait that ``gap_us`` measures.  On or off, the results are the
same bit for bit.

**Fault sites and the degradation ladder.**  ``executor.dispatch`` trips
at a callback's submission, ``executor.region`` before each device region
(``region{i}``) or eager device segment (``segment{i}``), and
``executor.host`` before each host callback (``runtime/faults.py``), each
before the call writes a static buffer, so retrying a ``donate=False``
call is safe.  A :class:`TransientError` counts against its site;
``demote_after`` of them at one site move the executor one level down
:attr:`Executor.LADDER` (async regions, then synchronous host regions,
then the sequential schedule, then the heuristic layouts and tiles), and
``promote_after`` clean calls in a row move it one level back up.  Every
move is a :class:`DegradationEvent` in ``plan.degradations``
(``plan.describe()``); a deterministic error moves nothing.  A level's
plan keeps its executable-cache entry leased to this executor, so coming
back to a level captures nothing.

**A mesh** (``mesh=make_mesh(...)``, ``core/mesh.py``).  One executor
drives every device of the mesh, as the reference's single controller
does through ``shard_map``: a tensor that names a mesh axis is a
:class:`~repro_torch.core.mesh.ShardedArray` in the state (one tensor per
mesh coordinate, on its device), and a node that touches one runs once
per shard, each on its shard's device — one program per shard.  Its
padded args are extended through the halo transfer schedule: edge strips
and corner blocks copied from the neighbour shards, the boundary policy
at the global edges.  A reduction folds the shards' local results on the
mesh's first device, where every unpartitioned tensor and every result
lives; a loop's predicate reads that folded value.  ``plan.halo_transfers``
lists the scheduled blocks per segment (fill-only without a mesh) and
``plan.overlap_fallbacks`` every declined ``overlap=True``, with the
reference's reasons (the degraded ones warn once).  An ``overlap=True``
split node over partitioned halos takes the interior/boundary lowering
(paper Fig. 7): every block's copy starts up front, on the CUDA mesh on
a copy stream of its shard's device; the interior program runs on the
compute stream meanwhile, then one boundary program per (axis, side)
waits for the copies and the outputs are stitched.  Under
``regions=True`` on a mesh whose shards share one device (one card, as
``make_mesh(..., devices=["cuda:0"] * 4)``, or the CPU) a piece is one
graph holding every shard's programs and the halo block copies; in the
overlapped lowering the copy stream forks from the capture stream and
joins it through events, so the block copies are branches of the graph
beside the interior programs (blocks are allocated during capture, from
the entry's pool).  ``tune`` measures on a mesh as without one: each
candidate is an executor over the same mesh, its layouts pass
``validate_mesh`` and its tiles tile every shard and strip the kernels
see.  Not on a mesh yet: ``regions=True`` over several cards raises
``NotImplementedError`` naming ROADMAP item 8, 3(c); ``regions=False``
runs such a mesh eagerly.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when no GPU is present.  Pass ``device="cpu"`` to run the kernels' plain
PyTorch versions on the CPU.
"""

from __future__ import annotations

import enum as enum_lib
import functools
import gc
import hashlib
import inspect
import math
import sys
import threading
import time
import types
import warnings
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor, \
    TimeoutError as FuturesTimeout
from contextlib import ExitStack, contextmanager
from dataclasses import dataclass, field as dfield
from typing import Any, Optional

import numpy as np
import torch

from ..runtime.faults import (HostTimeoutError, TransientError,
                              trip as _fault_trip)
from ..tuning.tiles import note_tile_uses, record_tile_use, tile_scope
from . import halo as halo_lib
from . import schedule as schedule_lib
from . import trace
from .device import resolve_device
from .graph import AccessMode, Graph, Node, TensorArg
from .layout import (Layout, RecordArray, _as_tensor, relayout,
                     relayout_data, storage_candidates)
from .mesh import Mesh, Placement, ShardedArray
from .schedule import ScheduleDag
from .tensor import DistTensor, ReductionResult

__all__ = ["Executor", "execute", "DegradationEvent", "ExecutableCacheEntry",
           "HaloTransfer", "HostTimeoutError", "LayoutPlan",
           "OverlapFallback", "RelayoutStep",
           "clear_executable_cache", "drop_executables",
           "executable_cache_stats", "layout_candidates", "plan_signature",
           "solve_layouts"]

_ITEM_CARDS = ("ROADMAP item 8, 3(c) (multi-card runs: region compile "
               "over the shards of several cards)")


@dataclass
class _HaloEntry:
    dim: int
    storage_axis: int
    width: int
    mesh_axis: Optional[str]  # None -> boundary fill only


def _halo_plan(t: DistTensor, mesh: Optional[Mesh]) -> list[_HaloEntry]:
    plan = []
    for d, w in enumerate(t.halo):
        if w == 0:
            continue
        ax = t.partition[d]
        if mesh is None or ax is None or mesh.shape[ax] == 1:
            plan.append(_HaloEntry(d, t.storage_axis(d), w, None))
        else:
            plan.append(_HaloEntry(d, t.storage_axis(d), w, ax))
    return plan


def _halo_axes(entries: list[_HaloEntry]) -> list[halo_lib.HaloAxis]:
    return [halo_lib.HaloAxis(e.storage_axis, e.width, e.mesh_axis)
            for e in entries]


def _tensor_arg(a) -> tuple[Optional[DistTensor], AccessMode]:
    """A node arg's tensor handle and access mode (``None`` for a value)."""
    if isinstance(a, TensorArg):
        return a.tensor, a.mode
    if isinstance(a, DistTensor):
        return a, AccessMode.DEFAULT
    return None, AccessMode.DEFAULT


def _outputs(node: Node, write_tensors: list, out) -> tuple:
    """A node fn's result as one value per written tensor."""
    if len(write_tensors) == 1:
        out = (out,)
    if len(out) != len(write_tensors):
        raise ValueError(f"{node.name}: fn returned {len(out)} values for "
                         f"{len(write_tensors)} writes")
    return out


def _shard_storage_shape(t: DistTensor,
                         mesh: Optional[Mesh]) -> tuple[int, ...]:
    """Per-shard storage shape of ``t``'s state entry (for transfer-block
    byte accounting)."""
    space = t.space if mesh is None else t.shard_space(mesh)
    if not t.is_record:
        return space
    return RecordArray.storage_shape(t.spec, space, t.layout)


# -- copy streams of the overlapped lowering ---------------------------------

_COPY_STREAMS: dict = {}


def _copy_stream(device: torch.device):
    """The process-wide copy stream of ``device`` (halo block copies)."""
    stream = _COPY_STREAMS.get(device)
    if stream is None:
        stream = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return stream


@contextmanager
def _on_copy_streams(devices):
    """Run the work inside on each CUDA device's copy stream, after all
    that the devices' compute streams have queued (the shards a block is
    cut from); yields ``{device: compute stream}``, or None on the CPU,
    where everything runs in order."""
    devs = list(dict.fromkeys(devices))
    if devs[0].type != "cuda":
        yield None
        return
    compute = {d: torch.cuda.current_stream(d) for d in devs}
    with ExitStack() as stack:
        for d in devs:
            cs = _copy_stream(d)
            for c in compute.values():   # a corner hop reads other devices
                cs.wait_stream(c)
            stack.enter_context(torch.cuda.stream(cs))
        yield compute


# -- event-driven async region runtime ----------------------------------------

class _HostTaskCancelled(Exception):
    """The outcome of a queued callback that never ran: one before it
    failed, or its call gave up on it.  The drain skips it."""


_HOST_POOL: Optional[ThreadPoolExecutor] = None
_HOST_POOL_LOCK = threading.Lock()


def _host_pool() -> ThreadPoolExecutor:
    """The process-wide pool of host callbacks, made on first use (one
    pool for every executor, so many executors never leak threads).  No
    deadlock: a pool task runs one call's callbacks and waits on nothing
    but the card."""
    global _HOST_POOL
    with _HOST_POOL_LOCK:
        if _HOST_POOL is None:
            _HOST_POOL = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="ripple-host")
        return _HOST_POOL


def _tensor_of(v):
    data = v.data if isinstance(v, RecordArray) else v
    return data if isinstance(data, torch.Tensor) else None


def _snapshot_for_host(v, storages: set):
    """One resolved host argument as its callback reads it, and the bytes
    cloned for it: a tensor that lies in a static buffer is cloned on the
    dispatching stream (the next replay overwrites the buffer while the
    callback may still read it, whatever ``donate`` says); any other value
    is passed as it is (nothing writes it)."""
    data = _tensor_of(v)
    if data is None or _storage(data) not in storages:
        return v, 0
    copy = data.clone()
    nbytes = copy.numel() * copy.element_size()
    if isinstance(v, RecordArray):
        return RecordArray(copy, v.spec, v.layout), nbytes
    return copy, nbytes


class _AsyncRun:
    """The in-flight host callbacks of ONE ``run()`` (the event-driven
    dispatcher's state).

    Each non-barrier host region is queued instead of blocking the
    dispatcher, with a future the dispatcher holds.  One pool task at a
    time runs the queue in order (program order of side effects), so
    consecutive callbacks run on one thread without a hand-off between
    threads; it is submitted when a callback is queued and none runs, and
    ends when the queue is empty.  The call has one side stream, which a
    pool task makes current (and so its device) when it starts.  A
    callback runs after that stream was made to wait, on the card, for a
    CUDA event recorded after its arguments' snapshots on the dispatching
    stream (its only data dependency: never ``torch.cuda.synchronize``,
    which would wait for every step dispatched behind it); the host does
    not wait for the event, so the callback's first device read does.
    The wait is queued just before the callback, never at submit, where
    it would put the callback's reads behind every later step's event.
    Whatever else a callback needs is done by the dispatcher at submit,
    which has time to spare while the callbacks are the slower side: the
    pool thread does as little as it can between two callbacks.  After a
    failure the callbacks queued behind it are cancelled.
    ``max_inflight`` bounds the pipeline's depth; a dispatcher at the cap
    waits until half of it has drained.

    ``host_timeout`` (seconds, None: no watchdog) bounds every wait on a
    callback — the in-flight cap, a drain: past it the wait raises
    :class:`HostTimeoutError` (transient) and every callback not yet
    started is cancelled.  A Python thread cannot be killed, so a hung
    callback keeps its pool slot until it returns (its own callback is
    skipped if it was still waiting to start), but the dispatcher and the
    executor stay live.  ``stats`` is the executor's ``async_stats``,
    which this adds to."""

    max_inflight = 32

    def __init__(self, device: torch.device, host_timeout: Optional[float],
                 storages, stats: dict):
        self.device = device
        self.host_timeout = host_timeout
        self._storages = storages      # () -> the static buffers' storages
        self.stats = stats
        self.tasks: deque = deque()    # (region index, Future), in order
        self._queue: deque = deque()   # the callbacks not started yet
        self._lock = threading.Lock()  # guards _queue and _running
        self._running = False          # a pool task is running the queue
        self._failed = False           # a callback failed: cancel the rest
        self._cancelled = threading.Event()
        self._hung: set = set()        # futures the watchdog gave up on
        self._side = None              # the call's side stream (CUDA)

    def submit(self, region_index: int, fn, vals) -> None:
        self.check()
        _fault_trip("executor.dispatch", detail=f"region{region_index}")
        if len(self.tasks) >= self.max_inflight:
            # at the cap, wait for half the pipeline: the dispatcher then
            # issues steps in bursts while the callbacks run alone, not one
            # step per finished callback, which starts exactly when the
            # next callback starts and takes the interpreter lock from it
            self._wait_until(len(self.tasks) - self.max_inflight // 2)
        # the span ends before the enqueue: the callback's queue time
        # starts where it ends
        with trace.span("ripple.submit") as origin:
            storages = self._storages()
            snapped = []
            for v in vals:
                v, nbytes = _snapshot_for_host(v, storages)
                snapped.append(v)
                self.stats["snapshot_bytes"] += nbytes
            event = None
            if self.device.type == "cuda":
                if self._side is None:
                    self._side = torch.cuda.Stream(self.device)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
                for v in snapped:
                    data = _tensor_of(v)
                    if data is not None and data.is_cuda:
                        # the allocator must not reuse the block before
                        # the side stream's reads of it are done
                        data.record_stream(self._side)
        fut: Future = Future()
        with self._lock:
            self._queue.append((region_index, fn, snapped, event, origin,
                                fut))
            start = not self._running
            self._running = True
        if start:
            _host_pool().submit(self._run_queue)
        self.tasks.append((region_index, fut))
        self.stats["callbacks"] += 1
        self.stats["peak_inflight"] = max(self.stats["peak_inflight"],
                                          len(self.tasks))

    def _run_queue(self) -> None:
        """The pool task: run the queued callbacks in order until none is
        left, with the call's side stream current."""
        if self._side is not None:
            torch.cuda.set_stream(self._side)
        while True:
            with self._lock:
                if not self._queue:
                    self._running = False
                    return
                item = self._queue.popleft()
            self._run_one(*item)

    def _run_one(self, region_index: int, fn, vals, event, origin,
                 fut) -> None:
        """One callback, in a ``ripple.callback`` span beside its submit
        (``origin``: the same parent and call), which ends before the
        future does, and so before the call."""
        try:
            with trace.span("ripple.callback",
                            None if origin is None else origin.up) as sp:
                if sp is not None and origin is not None:
                    sp.attrs["submit"] = origin.id
                if self._failed or self._cancelled.is_set():
                    raise _HostTaskCancelled()
                _fault_trip("executor.host", detail=f"region{region_index}")
                if self._cancelled.is_set():   # the watchdog gave up
                    raise _HostTaskCancelled()
                if event is not None:
                    self._side.wait_event(event)
                if fn is not None:
                    fn(*vals)
        except BaseException as exc:
            if not isinstance(exc, _HostTaskCancelled):
                self._failed = True
            fut.set_exception(exc)
        else:
            fut.set_result(None)

    def _cancel_queued(self) -> None:
        """Every callback not started yet ends as cancelled."""
        self._cancelled.set()
        with self._lock:
            queued = list(self._queue)
            self._queue.clear()
        for *_, fut in queued:
            fut.set_exception(_HostTaskCancelled())

    def _give_up(self, region_index: int, fut) -> None:
        """The watchdog's end of a wait: cancel every callback not yet
        started and raise :class:`HostTimeoutError` for ``fut``."""
        self._hung.add(fut)
        self._cancel_queued()
        err = HostTimeoutError(
            f"host callback of region {region_index} still running "
            f"after {self.host_timeout}s — cancelling its successors")
        err.site = "executor.host"
        raise err from None

    def _timed_result(self, region_index: int, fut):
        """``fut.result`` under the watchdog; a timeout cancels every
        callback not yet started and raises :class:`HostTimeoutError`."""
        try:
            return fut.result(timeout=self.host_timeout)
        except FuturesTimeout:
            self._give_up(region_index, fut)

    def _wait_until(self, n: int) -> None:
        """Wait until the ``n`` oldest callbacks have ended, take them off
        and re-raise the first failure among them.  They end in order, so
        the dispatcher sleeps on the n-th alone: one wake-up for ``n``
        callbacks, where a wake-up as each ended took the interpreter lock
        from the pool thread just as it started the next.  The watchdog
        still bounds each callback: a wait in which the oldest unfinished
        one does not end within ``host_timeout`` raises for it."""
        t0 = time.perf_counter()
        with trace.span("ripple.wait") as sp:
            if sp is not None:
                sp.attrs["kind"] = "cap"
            try:
                last = self.tasks[n - 1][1]
                while not last.done():
                    region_index, fut = next(
                        t for t in self.tasks if not t[1].done())
                    try:
                        last.exception(timeout=self.host_timeout)
                    except FuturesTimeout:
                        if not fut.done():
                            self._give_up(region_index, fut)
            finally:
                self.stats["wait_s"] += time.perf_counter() - t0
        for _ in range(n):
            exc = self.tasks[0][1].exception()
            if exc is not None and not isinstance(exc, _HostTaskCancelled):
                raise exc
            self.tasks.popleft()

    def check(self) -> None:
        """Raise the failure of a callback that already failed, without
        waiting on the rest: the dispatcher calls this before each region,
        so a failure stops new work promptly.  Callbacks finish in
        dispatch order, so the finished ones lead: they are taken off
        here, and the first unfinished ends the scan."""
        while self.tasks and self.tasks[0][1].done():
            _, fut = self.tasks.popleft()
            exc = fut.exception()
            if exc is not None and not isinstance(exc, _HostTaskCancelled):
                raise exc

    def drain(self, barrier: bool = False) -> None:
        """Wait for every in-flight callback and re-raise the FIRST failure
        in dispatch order (cancelled successors are skipped): the error a
        synchronous run would have raised.  ``barrier`` counts the drain
        as a wait inside the call (a barrier, a host loop, a build) when a
        callback is still running."""
        if barrier and any(not fut.done() for _, fut in self.tasks):
            self.stats["barrier_drains"] += 1
        first = None
        t0 = time.perf_counter()
        with trace.span("ripple.wait") as sp:
            if sp is not None:
                sp.attrs["kind"] = "barrier" if barrier else "drain"
            for region_index, fut in self.tasks:
                try:
                    self._timed_result(region_index, fut)
                except _HostTaskCancelled:
                    pass
                except BaseException as exc:
                    if first is None:
                        first = exc
        self.stats["wait_s"] += time.perf_counter() - t0
        self.tasks.clear()
        if first is not None:
            raise first

    def abort(self) -> None:
        """Clean-up on an exception: cancel what has not started and wait
        out the rest, swallowing their errors (another one is already on
        its way).  A callback the watchdog gave up on is left to the pool
        instead of being waited for again."""
        self._cancel_queued()
        for _, fut in self.tasks:
            if fut in self._hung:
                continue
            try:
                fut.result(timeout=self.host_timeout)
            except BaseException:
                pass
        self.tasks.clear()


@dataclass(frozen=True)
class RelayoutStep:
    """An explicit layout conversion the executor inserts at a segment
    boundary: ``tensor`` is converted ``src -> dst`` before ``segment``."""

    segment: int
    tensor: str
    src: Layout
    dst: Layout


@dataclass(frozen=True)
class HaloTransfer:
    """One scheduled halo block of a segment's exchange (plan introspection).

    ``block`` names which sides of which space dims the block extends —
    ``((1, 'low'),)`` is an edge strip, ``((0, 'low'), (1, 'high'))`` a
    corner.  ``mesh_axis`` is the axis the block's final hop crosses, a
    copy from the neighbour shard (``None`` — a local boundary fill, no
    transfer); ``phase`` is when the copy starts (1 = up-front edge
    strips, 2+ = extended-edge corner hops); ``overlapped`` marks blocks
    whose flight is hidden behind the node's interior program."""

    segment: int
    node: str
    tensor: str
    phase: int
    block: tuple[tuple[int, str], ...]   # ((space_dim, 'low'|'high'), ...)
    mesh_axis: Optional[str]
    width: int
    overlapped: bool
    nbytes: int = 0                      # per-shard block payload size

    def describe(self) -> str:
        """One line: where the block lies, how it arrives, when."""
        where = "+".join(f"{'-' if s == 'low' else '+'}d{d}"
                         for d, s in self.block)
        via = f"copy[{self.mesh_axis}]" if self.mesh_axis else "fill"
        mode = "overlapped" if self.overlapped else "sync"
        return (f"seg{self.segment} {self.node}: {self.tensor} {where} "
                f"w={self.width} via {via} phase{self.phase} ({mode})")


@dataclass(frozen=True)
class OverlapFallback:
    """A node that asked for ``overlap=True`` but was lowered through the
    synchronous halo path, and why."""

    segment: int
    node: str
    reason: str


@dataclass(frozen=True)
class DegradationEvent:
    """One move of the executor's degradation ladder (rendered by
    ``plan.describe()``).  ``action`` is ``"demote"`` or ``"promote"``;
    ``frm``/``to`` are level names of :attr:`Executor.LADDER`; ``site``
    names the fault site whose failures drove a demotion (``""`` for a
    promotion); ``passes`` is the executor's count of clean calls at the
    move."""

    passes: int
    action: str
    frm: str
    to: str
    site: str
    reason: str

    def describe(self) -> str:
        """One line: what moved, which way, and why."""
        return (f"pass {self.passes}: {self.action} {self.frm} -> "
                f"{self.to} — {self.reason}")


@dataclass
class LayoutPlan:
    """Solver output: ``initial`` is what :meth:`Executor.init_state`
    materializes (the first consuming segment's choice), ``per_segment``
    the layout of every record tensor each segment touches, ``relayouts``
    the boundary conversions of one pass, ``dag`` the dependency DAG
    with its segment placement, ``regions`` the segments grouped into
    regions (``schedule.group_regions``), ``region_graphs`` the graphs
    each device region runs as under ``regions=True`` (filled as its
    programs are built, and by :meth:`Executor.describe_dag`),
    ``signature`` the 12-hex digest of
    the :func:`plan_signature`, ``cache`` the executable-cache entry once
    a region ran (None with ``regions=False``), ``tuning`` the
    measured autotuner's
    :class:`~repro_torch.tuning.search.TuningDecision` when the Executor
    was constructed with ``tune="load"``/``"auto"`` (None when tuning is
    off) and ``degradations`` the executor's ladder moves
    (:class:`DegradationEvent`, kept across the plans a move rebuilds).
    ``halo_transfers`` lists every scheduled halo block per segment
    (:meth:`transfers_for_segment`), ``overlap_fallbacks`` every declined
    overlap request with its reason, and ``region_edges`` the region-level
    dependency DAG (:meth:`region_waves`).  :meth:`describe` renders all
    of it."""

    per_segment: list[dict[str, Layout]] = dfield(default_factory=list)
    initial: dict[str, Layout] = dfield(default_factory=dict)
    relayouts: list[RelayoutStep] = dfield(default_factory=list)
    halo_transfers: list[HaloTransfer] = dfield(default_factory=list)
    overlap_fallbacks: list[OverlapFallback] = dfield(default_factory=list)
    dag: Optional[ScheduleDag] = None
    regions: list = dfield(default_factory=list)
    region_edges: list = dfield(default_factory=list)
    region_graphs: Optional[dict[int, int]] = None
    signature: str = ""
    cache: Optional["ExecutableCacheEntry"] = None
    tuning: Optional[Any] = None
    degradations: list[DegradationEvent] = dfield(default_factory=list)

    def transfers_for_segment(self, segment: int) -> list[HaloTransfer]:
        """The scheduled halo blocks entering one segment (see
        :class:`HaloTransfer`)."""
        return [h for h in self.halo_transfers if h.segment == segment]

    def region_waves(self) -> list[list[int]]:
        """Ready waves of region indices under the region-level DAG:
        regions sharing a wave have no dependency path between them."""
        return schedule_lib.region_waves(self.regions, self.region_edges)

    def describe_dag(self) -> str:
        """Render the dependency DAG with its segment/wave placement, the
        relayout steps and halo blocks at each segment entry, the region
        grouping and the executable-cache counters."""
        if self.dag is None:
            return "(no dependency DAG recorded)"
        return self.dag.describe(plan=self)

    def describe_transfers(self) -> str:
        """One line per scheduled halo block plus every declined overlap
        request with its reason."""
        if not self.halo_transfers:
            return "(no scheduled halo transfers)"
        lines = [h.describe() for h in self.halo_transfers]
        lines += [f"seg{f.segment} {f.node}: overlap fallback — {f.reason}"
                  for f in self.overlap_fallbacks]
        return "\n".join(lines)

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

    def describe_degradations(self) -> str:
        """One line per ladder move (a demotion with its site and reason,
        a promotion after clean calls); says so when there was none."""
        if not self.degradations:
            return "(no degradation-ladder transitions)"
        return "\n".join("ladder " + d.describe() for d in self.degradations)

    def describe(self) -> str:
        """The whole plan: the DAG, regions and cache
        (:meth:`describe_dag`), the ladder's moves
        (:meth:`describe_degradations`), then the tuning
        (:meth:`describe_tuning`)."""
        return (f"{self.describe_dag()}\n{self.describe_degradations()}\n"
                f"{self.describe_tuning()}")


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
# The tuning cache and the executable cache must never alias two plans that could compute different values, and should alias
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


def _mesh_sig(mesh: Optional[Mesh]):
    if mesh is None:
        return None
    return (tuple(mesh.shape.items()), tuple(str(d) for d in mesh.devices))


def plan_signature(executor: "Executor") -> tuple:
    """Structural identity of a plan: graph structure (node kinds, args,
    function code + closures — NOT auto-generated node names), tensor
    shapes/dtypes/layouts, mesh, schedule mode, donation, device type,
    per-segment layout decisions, forced per-segment overrides and kernel
    tile overrides.  Two executors with equal signatures compute
    identical values for identical inputs, so their region programs are
    interchangeable.  Tile overrides are part of the key because they
    change the kernels' launches (the autotuner's candidates never
    alias); the executable cache adds the device index."""
    plan = executor.plan
    return ("ripple-torch-plan-v3", executor.schedule, executor.donate,
            executor.device.type, _mesh_sig(executor.mesh),
            _segments_sig(executor._segments),
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
    AoSoA for the shared storage, the solver's rule — and validated
    against the mesh).  Keys with a single feasible layout are omitted:
    there is nothing to search."""
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
        cands = []
        for lay in storage_candidates(t.space, t.halo, t.partition):
            if lay is Layout.AOSOA and name in no_aosoa:
                continue
            if executor.mesh is not None:
                try:
                    t.with_(layout=lay).validate_mesh(executor.mesh)
                except ValueError:
                    continue
            cands.append(lay)
        if len(cands) > 1:
            out[name] = tuple(cands)
    return out


# -- process-wide executable cache (region compile) ---------------------------

@dataclass(eq=False)
class ExecutableCacheEntry:
    """The region programs of one plan signature on one device, and the
    static buffers their graphs read and write.

    ``executables`` maps ``('region', index, entry layouts)`` keys to
    region programs.  ``builds`` counts programs constructed, ``hits``
    fetches that found a program some other fetch built (the
    re-instantiated-executor path), and ``trace_events`` the pieces
    built: a capture of a CUDA graph on the card, the first run of a
    piece's function on the CPU.  A steady-state ``run()`` moves none of
    them.

    ``buffers`` holds the static buffers, one per (state key, storage
    shape, dtype, mesh coordinate of a partitioned key), ``shard_sets``
    a partitioned key's buffers as one ShardedArray; ``owners`` and
    ``storages`` give each buffer's key by its ``id`` (a ShardedArray's
    too) and by its storage; ``pool`` is the memory pool the
    entry's graphs share (a graph's intermediates are dead outside its
    replay, and replays never overlap).  ``graphs`` are weak references
    to the graphs whose closures the programs read (a large tensor is
    keyed by ``id`` in the signature, so it must outlive every graph that
    reads it), ``pins`` those graphs held while ``users`` (live executors
    that fetched the entry) is above 0.  ``live`` is the state the last
    ``donate=True`` call returned: per buffer (by ``id``) a weak
    reference to its alias, the buffer and its key; ``moved_out`` counts
    the aliases moved onto clones (and ``moved_out_bytes`` their bytes).
    ``lock`` is held by a call for as long as it uses the buffers: two
    executors that share the entry on two threads take turns."""

    key: tuple
    executables: dict = dfield(default_factory=dict)
    builds: int = 0
    hits: int = 0
    trace_events: int = 0
    buffers: dict = dfield(default_factory=dict)
    shard_sets: dict = dfield(default_factory=dict)
    owners: dict = dfield(default_factory=dict)
    storages: dict = dfield(default_factory=dict)
    pool: Any = None
    graphs: list = dfield(default_factory=list)
    pins: list = dfield(default_factory=list)
    users: int = 0
    live: dict = dfield(default_factory=dict)
    moved_out: int = 0
    moved_out_bytes: int = 0
    lock: Any = dfield(default_factory=threading.RLock)

    def buffer(self, name: str, shape, dtype: torch.dtype,
               device: torch.device, shard: Optional[int] = None
               ) -> torch.Tensor:
        """The static buffer of ``name`` (of mesh coordinate ``shard`` for
        a partitioned key) in a storage ``shape`` and ``dtype``, allocated
        on ``device`` on first use."""
        key = (name, tuple(shape), dtype, shard)
        buf = self.buffers.get(key)
        if buf is None:
            buf = self.buffers[key] = torch.empty(shape, dtype=dtype,
                                                  device=device)
            self.owners[id(buf)] = self.storages[_storage(buf)] = name
        return buf

    def sharded(self, name: str, placement: Placement, shape,
                dtype: torch.dtype) -> ShardedArray:
        """The static buffers of a partitioned key, one per shard on its
        device, as one :class:`ShardedArray` (the same object every
        time, so that a state that holds it skips the copy-in)."""
        key = (name, placement.spec, tuple(shape), dtype)
        sa = self.shard_sets.get(key)
        if sa is None:
            mesh = placement.mesh
            each = placement.shard_shape(shape)
            sa = self.shard_sets[key] = ShardedArray(
                [self.buffer(name, each, dtype, dev, shard=c)
                 for c, dev in enumerate(mesh.devices)], placement, shape)
            self.owners[id(sa)] = name
        return sa

    def like(self, name: str, value):
        """The static buffer(s) of ``name`` shaped as ``value``: a tensor,
        or a ShardedArray of one buffer per shard."""
        if isinstance(value, ShardedArray):
            return self.sharded(name, value.placement, value.shape,
                                value.dtype)
        return self.buffer(name, value.shape, value.dtype, value.device)

    def alias(self, buf):
        """The live alias of ``buf`` (a buffer or a ShardedArray of
        buffers): the one the last call returned while someone holds it,
        else a new one.  The references to each buffer's storage are
        counted as it is handed out, so that :meth:`take_back` can tell
        a view the caller took since."""
        held = self.live.get(id(buf))
        alias = held[0]() if held is not None else None
        if alias is None:
            alias = _alias(buf)
        self.live[id(buf)] = (weakref.ref(alias), buf, self.owners[id(buf)],
                              tuple(_uses(t) for t in _tensors(buf)))
        return alias

    def take_back(self, state: dict) -> set:
        """Start of a call on this entry: each live alias that ``state``
        holds under its own key is donated (replaced by its buffer, whose
        ``id`` is returned); every other live alias still held is moved out
        onto a clone, so that it keeps its values.  A returned state that
        is not passed back but is still seen through a view of its
        storage (a slice, ``.view()``, ``.numpy()``, a field of a record),
        which no move can re-point, raises before any alias moves."""
        donated, moves = set(), []
        for bid, (ref, buf, name, counted) in list(self.live.items()):
            alias = ref()
            if alias is not None and state.get(name) is alias:
                state[name] = buf
                donated.add(bid)
                continue
            _refuse_views(name, buf, alias, counted, state)
            moves.append((bid, alias, buf))
        for bid, alias, buf in moves:
            del self.live[bid]
            if alias is not None:
                for a, b in zip(_tensors(alias), _tensors(buf)):
                    a.set_(b.clone())
                    self.moved_out += 1
                    self.moved_out_bytes += b.numel() * b.element_size()
        return donated

    def pin(self, graph: Graph) -> None:
        """Keep ``graph`` alive while the entry has users, and drop the
        entry once it has none and ``graph`` is collected."""
        if any(r() is graph for r in self.graphs):
            return
        self.graphs.append(weakref.ref(graph, functools.partial(
            _graph_collected, weakref.ref(self))))
        self.pins.append(graph)

    def acquire(self, executor: "Executor") -> weakref.finalize:
        """Count ``executor`` as a user until it is collected or calls the
        returned finalizer."""
        self.users += 1
        self.pins = [g for g in (r() for r in self.graphs) if g is not None]
        release = weakref.finalize(executor, _release_entry, self)
        release.atexit = False
        return release


def _uses(t: torch.Tensor) -> int:
    """The references to ``t``'s storage: every tensor and view over it,
    every array exported from it, and the handle this count takes."""
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata)


def _refuse_views(name: str, buf, alias, counted: tuple,
                  state: dict) -> None:
    """Raise when the storage of ``name``'s buffer ``buf`` has more
    references than when its alias was handed out (``counted``; one
    fewer once the alias is gone), other than the tensors ``state``
    passes in (a view passed as an input is cloned before any buffer is
    written): a view the caller kept, which would show the next call's
    values."""
    gone = alias is None
    mine = set() if gone else {id(t) for t in _tensors(alias)}
    for t, n in zip(_tensors(buf), counted):
        store = _storage(t)
        passed = {id(x) for v in state.values() for x in _tensors(v)
                  if id(x) not in mine and _storage(x) == store}
        if _uses(t) - len(passed) > n - gone:
            gc.collect()            # a view in a dead reference cycle
            if _uses(t) - len(passed) > n - gone:
                raise RuntimeError(
                    f"the returned state's {name!r} is still seen through "
                    f"a view of its storage (a slice, .view(), .numpy(), "
                    f"a field of a record), and this call would overwrite "
                    f"what it shows: clone what you keep, pass the state "
                    f"back, or build the executor with donate=False")


def _alias(buf):
    """A new tensor object over ``buf``'s storage (for a ShardedArray,
    shard by shard), which :meth:`ExecutableCacheEntry.take_back` can
    re-point without touching the buffer."""
    if isinstance(buf, ShardedArray):
        return ShardedArray([_alias(t) for t in buf.shards], buf.placement,
                            buf.shape)
    return torch.empty(0, dtype=buf.dtype, device=buf.device).set_(buf)


# (plan signature, device type, device index) -> entry.  An entry outlives
# its executors while the graphs it was built from live (that is the
# reuse); clear_executable_cache() drops them all.
_EXECUTABLE_CACHE: dict[tuple, ExecutableCacheEntry] = {}


def _evict(entry: ExecutableCacheEntry) -> None:
    if _EXECUTABLE_CACHE.get(entry.key) is entry:
        del _EXECUTABLE_CACHE[entry.key]


def _release_entry(entry: ExecutableCacheEntry) -> None:
    """An executor stopped using ``entry``: unpin its graphs when it was
    the last user (a graph collected then drops the entry)."""
    entry.users -= 1
    if entry.users == 0:
        entry.pins = []
        if not entry.graphs:      # nothing built: nothing to reuse
            _evict(entry)


def _graph_collected(entry_ref, _graph_ref) -> None:
    entry = entry_ref()
    if entry is not None and entry.users == 0:
        _evict(entry)


def clear_executable_cache() -> None:
    """Drop every cached region program and its graphs and buffers."""
    _EXECUTABLE_CACHE.clear()


def drop_executables(signature: tuple) -> None:
    """Drop the entries of one plan signature on every device (the tuner
    drops its losing candidates' graphs this way)."""
    for key in [k for k in _EXECUTABLE_CACHE if k[0] == signature]:
        del _EXECUTABLE_CACHE[key]


def executable_cache_stats() -> dict:
    """Counters summed over the process-wide executable cache."""
    entries = list(_EXECUTABLE_CACHE.values())
    return {
        "plans": len(_EXECUTABLE_CACHE),
        "entries": len(entries),
        "executables": sum(len(e.executables) for e in entries),
        "builds": sum(e.builds for e in entries),
        "hits": sum(e.hits for e in entries),
        "trace_events": sum(e.trace_events for e in entries),
    }


class _CallState:
    """One ``__call__``/``run`` under ``regions=True``.  ``state`` maps
    every key to its current value — a static buffer once a piece has
    read or written it; ``origin`` the value a key held when it was
    copied into its buffer; ``written`` the keys a piece wrote;
    ``buffers`` the ids of the static buffers handed out; ``ctx`` the
    async dispatcher of the regions running now (None: synchronous)."""

    __slots__ = ("state", "origin", "written", "buffers", "ctx")

    def __init__(self, state: dict, ctx: Optional[_AsyncRun] = None):
        self.state = dict(state)
        self.origin: dict = {}
        self.written: set = set()
        self.buffers: set = set()
        self.ctx = ctx


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _tensors(v) -> tuple:
    """The tensors of a state value: a tensor, a ShardedArray's shards."""
    if isinstance(v, ShardedArray):
        return v.shards
    return (v,) if isinstance(v, torch.Tensor) else ()


def _storages(v) -> set:
    return {_storage(t) for t in _tensors(v)}


def _clone(v):
    if isinstance(v, ShardedArray):
        return v.map(torch.clone, v.placement, v.shape)
    return v.clone()


def _is_buffer(v, buf) -> bool:
    """``v`` is ``buf`` (for a ShardedArray: shard for shard)."""
    if v is buf:
        return True
    if isinstance(v, ShardedArray) and isinstance(buf, ShardedArray):
        return len(v.shards) == len(buf.shards) and all(
            a is b for a, b in zip(v.shards, buf.shards))
    return False


def _flat(values: dict) -> dict:
    """A ShardedArray value as one entry per shard, keyed ``(key, c)``."""
    out = {}
    for k, v in values.items():
        if isinstance(v, ShardedArray):
            for c, t in enumerate(v.shards):
                out[(k, c)] = t
        else:
            out[k] = v
    return out


def _copy_back(outs: dict, dsts: dict) -> tuple[int, int]:
    """Copy each key's value into its static buffer (a piece's outputs
    that were not written in place, after its segments; its inputs
    before them), reading every value before any buffer that it aliases
    is written: a value that lies in another key's buffer is copied
    first, one that is a view of its own buffer, or that closes a cycle,
    goes through a temporary.  A partitioned key copies shard by shard.
    Returns the copies made (temporaries included) and their bytes."""
    outs, dsts = _flat(outs), _flat(dsts)
    owner = {_storage(b): k for k, b in dsts.items()}
    copies = nbytes = 0

    def clone(t):
        nonlocal copies, nbytes
        copies += 1
        nbytes += t.numel() * t.element_size()
        return t.clone()

    todo = {}
    for k, src in outs.items():
        todo[k] = clone(src) if owner.get(_storage(src)) == k else src
    while todo:
        blocked = {owner.get(_storage(src)) for k, src in todo.items()}
        ready = [k for k in todo if k not in blocked]
        if not ready:
            k = next(iter(todo))
            todo[k] = clone(todo[k])
            continue
        for k in ready:
            src = todo.pop(k)
            dsts[k].copy_(src)
            copies += 1
            nbytes += src.numel() * src.element_size()
    return copies, nbytes


def _segment_reads(nodes) -> set:
    """The state keys ``nodes`` may read: every tensor or result among
    their args (a written arg too: its function receives it)."""
    reads = set()
    for node in nodes:
        for a in node.args:
            if isinstance(a, TensorArg):
                reads.add(a.tensor.name)
            elif isinstance(a, (DistTensor, ReductionResult)):
                reads.add(a.name)
    return reads


def _takes_out(fn) -> bool:
    """True when ``fn`` takes an ``out=`` keyword (keyword-only, or with a
    default: a positional ``out`` without one is an ordinary arg)."""
    try:
        p = inspect.signature(fn).parameters.get("out")
    except (TypeError, ValueError):
        return False
    if p is None:
        return False
    return p.kind is p.KEYWORD_ONLY or (
        p.kind is p.POSITIONAL_OR_KEYWORD and p.default is not p.empty)


class _InPlace:
    """What a piece's lowering may write in place: the entry whose static
    buffers a node may take as ``out=``, the keys whose output landed in
    their buffer (``wrote``), its reductions by route (``routes``: a
    hand-written kernel's, then torch's; ``Reducer.route``) and the
    bytes its halo assembly wrote (``halo``)."""

    __slots__ = ("entry", "wrote", "routes", "halo")

    def __init__(self, entry: ExecutableCacheEntry):
        self.entry = entry
        self.wrote: set = set()
        self.routes = [0, 0]
        self.halo = 0


class _Piece:
    """One graph of a device region: a run of loop-free segments of one
    executor, each after its boundary relayouts (``chain``: (segment
    index or None for relayouts alone, conversions, layouts)), lowered
    against the entry's static buffers.  The first run builds it (see
    the module docstring); ``in_bufs``/``out_bufs`` are then the buffers
    it reads and writes, ``copies`` the copies (and their bytes) that
    its end makes into ``out_bufs`` for outputs not written in place,
    ``routes`` its reductions that launched a hand-written kernel and
    those that ran torch ops, ``halo`` the bytes its halo assembly
    writes."""

    def __init__(self, label: str, chain: list, reads: tuple):
        self.label = label
        self.chain = chain
        self.reads = reads
        self.in_bufs: Optional[dict] = None
        self.out_bufs: Optional[dict] = None
        self.copies = (0, 0)
        self.routes = (0, 0)
        self.halo = 0
        self.graph = None
        self.tile_uses: dict = {}

    def run(self, ex: "Executor", entry: ExecutableCacheEntry,
            st: _CallState) -> None:
        if self.in_bufs is None:
            if st.ctx is not None and ex.device.type == "cuda":
                # a capture fails on another thread's device-to-host
                # read: no callback of this call runs while it builds
                st.ctx.drain(barrier=True)
            with trace.span("ripple.build") as sp:
                if sp is not None:
                    sp.attrs["label"] = self.label
                self._build(ex, entry, st)
        else:
            with trace.span("ripple.launch") as sp:
                staged = self._stage(entry, st, self.in_bufs)
                if self.graph is None:
                    self._execute(ex, entry, dict(st.state))
                elif sp is None:
                    self.graph.replay()
                else:
                    sp.replay(self.graph, ex.device)
            if sp is not None:   # after the span: not in its time
                sp.attrs.update(label=self.label, staged_bytes=staged)
            if self.graph is not None and self.tile_uses:
                note_tile_uses(self.tile_uses)
        for k, buf in self.out_bufs.items():
            st.state[k] = buf
            st.buffers.add(id(buf))
        st.written.update(self.out_bufs)

    def _stage(self, entry, st: _CallState, bufs) -> int:
        """Copy every key this piece reads into its static buffer, unless
        the state already holds that buffer; every value is read before
        any buffer it lies in is written.  Returns the bytes copied."""
        srcs, dsts = {}, {}
        for name in self.reads:
            x = st.state[name]
            buf = entry.like(name, x) if bufs is None else bufs[name]
            if x is buf:
                continue
            have, want = _tensors(x), _tensors(buf)
            if isinstance(x, ShardedArray) != isinstance(buf, ShardedArray) \
                    or len(have) != len(want) or any(
                        a.shape != b.shape or a.dtype != b.dtype
                        or a.device != b.device
                        for a, b in zip(have, want)):
                raise ValueError(
                    f"{self.label}: state[{name!r}] is "
                    f"{_describe(x)}, but the region was built for "
                    f"{_describe(buf)}")
            if id(x) not in st.buffers:
                st.origin[name] = x
            srcs[name], dsts[name] = x, buf
        nbytes = _copy_back(srcs, dsts)[1]
        for name, buf in dsts.items():
            st.state[name] = buf
            st.buffers.add(id(buf))
        return nbytes

    def _body(self, ex: "Executor", state: dict) -> dict:
        for si, conv, layouts in self.chain:
            for name, src, dst in conv:
                state[name] = ex._relayout_value(state[name], name, src,
                                                 dst)
            if si is not None:
                with tile_scope(ex._tile_config):
                    state = ex._lower_levels(ex._segments[si][1], state,
                                             layouts)
        return state

    def _execute(self, ex: "Executor", entry: ExecutableCacheEntry,
                 bufstate: dict) -> dict:
        """The segments on the buffers (a node that takes ``out=`` writes
        its key's buffer where the executor allows it), then the copies
        of the other outputs into their buffers; returns the written
        keys' buffers (allocated on the first run)."""
        ip = ex._inplace = _InPlace(entry)
        try:
            out = self._body(ex, dict(bufstate))
        finally:
            ex._inplace = None
        written = {k for k, v in out.items() if v is not bufstate[k]}
        written |= ip.wrote
        dsts = self.out_bufs
        if dsts is None:
            dsts = {k: entry.like(k, out[k]) for k in written}
        elif written != dsts.keys():
            raise RuntimeError(
                f"{self.label}: wrote {sorted(written)} in this run and "
                f"{sorted(dsts)} when it was built")
        self.copies = _copy_back(
            {k: out[k] for k in written if not _is_buffer(out[k], dsts[k])},
            dsts)
        self.routes = tuple(ip.routes)
        self.halo = ip.halo
        return dsts

    def _build(self, ex, entry, st: _CallState) -> None:
        """The first run: stage the reads into (new) buffers, then run the
        segments — on the card eagerly on a side stream, then once more
        under capture."""
        self._stage(entry, st, None)
        in_bufs = {n: st.state[n] for n in self.reads}
        bufstate = dict(st.state)
        if ex.device.type != "cuda":
            self.out_bufs = self._execute(ex, entry, bufstate)
            self.in_bufs = in_bufs
            entry.trace_events += 1
            return
        dev = ex.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        # the eager warm-up: builds the kernels and makes this call's
        # result; the capture below records without running
        with torch.cuda.stream(side), record_tile_use() as used:
            self.out_bufs = self._execute(ex, entry, bufstate)
        cur.wait_stream(side)
        for buf in self.out_bufs.values():
            for t in _tensors(buf):
                t.record_stream(cur)      # allocated on the side stream
        if entry.pool is None:
            entry.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        ex._running = None
        try:
            with torch.cuda.graph(graph, pool=entry.pool):
                self._execute(ex, entry, bufstate)
        except Exception as exc:
            torch.cuda.set_stream(cur)
            raise RuntimeError(
                f"{self.label}: capture failed in node {ex._running!r} "
                f"(a device region's nodes must not sync the host): "
                f"{exc}") from exc
        self.graph = graph
        self.tile_uses = used
        self.in_bufs = in_bufs
        entry.trace_events += 1


def _describe(v) -> str:
    if isinstance(v, ShardedArray):
        s = v.shards[0]
        return (f"{len(v.shards)} shards of {tuple(s.shape)} {s.dtype} on "
                f"{s.device}")
    return f"{tuple(v.shape)} {v.dtype} on {v.device}"


class _Loop:
    """A ``loop`` segment of a device region: its body's pieces (built
    from the loop's sub-executor, over the same buffers) replayed while
    the predicate holds."""

    def __init__(self, segment: int, body: list):
        self.segment = segment
        self.body = body

    def run(self, ex: "Executor", entry: ExecutableCacheEntry,
            st: _CallState) -> None:
        sub = ex._sub_executor(self.segment)
        condition = ex._segments[self.segment][1].condition

        def body():
            for step in self.body:
                step.run(sub, entry, st)

        _while(lambda: bool(condition(st.state)), body)


def _while(predicate, body) -> None:
    """``while predicate(): body()``, a loop segment's while semantics:
    the predicate gates the first iteration too (``bool()`` of a CUDA
    tensor is one device-to-host read per check).  Each check is a
    ``ripple.predicate`` span and each pass a ``ripple.iteration``."""
    while True:
        with trace.span("ripple.predicate"):
            go = predicate()
        if not go:
            return
        with trace.span("ripple.iteration"):
            body()


def _pieces(steps):
    """Every piece of a region program's steps, loop bodies included."""
    for s in steps:
        if isinstance(s, _Loop):
            yield from _pieces(s.body)
        else:
            yield s


def _count_graphs(steps) -> int:
    return sum(_count_graphs(s.body) if isinstance(s, _Loop) else 1
               for s in steps)


@dataclass
class _RegionProgram:
    """A device region at one set of entry layouts: its pieces and loops
    in order, and the layouts it leaves the state in."""

    steps: list
    exit_layouts: dict


# -- overlap decision (paper Fig. 7 generalized) -----------------------------

# (node name, reason) pairs already warned about — "warn once" holds across
# the sub-executors a loop segment creates for the same node
_warned_overlap: set[tuple[str, str]] = set()


@dataclass(frozen=True)
class _OverlapDecision:
    """Whether an ``overlap=True`` split node gets the interior/boundary
    lowering: ``strips`` = ((space_dim, max halo width), ...) ascending,
    or None with a ``reason`` (``warn`` when real transfers are degraded
    to the synchronous path rather than there being nothing to hide)."""

    strips: Optional[tuple[tuple[int, int], ...]]
    reason: Optional[str] = None
    warn: bool = False


def _decide_overlap(node: Node, mesh: Optional[Mesh], eff) -> _OverlapDecision:
    if mesh is None:
        return _OverlapDecision(
            None, "graph has no mesh — nothing to overlap", False)
    padded = [eff(t) for _, t, mode in node.tensor_args() if mode.padded]
    if not padded:
        return _OverlapDecision(
            None, "no padded-access tensor arg to overlap", True)
    strips: dict[int, int] = {}
    for t in padded:
        for e in _halo_plan(t, mesh):
            if e.mesh_axis is not None:
                strips[e.dim] = max(strips.get(e.dim, 0), e.width)
    if not strips:
        return _OverlapDecision(
            None, "no mesh-partitioned halo axis (single shard along every "
            "haloed dim)", False)
    ref = padded[0]
    tensors = [eff(t) for _, t, _ in node.tensor_args()]
    for d in sorted(strips):
        w = strips[d]
        ax_name = ref.partition[d]
        for t in tensors:
            if len(t.space) <= d or t.space[d] != ref.space[d] \
                    or t.partition[d] != ax_name:
                return _OverlapDecision(
                    None, f"arg {t.name!r} does not align with "
                    f"partitioned halo dim {d} of {ref.name!r}", True)
            try:
                t.storage_axis(d)
            except ValueError as exc:
                return _OverlapDecision(None, str(exc), True)
        m = ref.space[d] // mesh.shape[ax_name]
        if m <= 2 * w:
            return _OverlapDecision(
                None, f"shard extent {m} along dim {d} leaves no interior "
                f"behind boundary strips of width {w}", True)
    return _OverlapDecision(tuple(sorted(strips.items())))


#: the cross-shard fold of each reducer's ``combine`` (max/min propagate a
#: NaN across shards, as the reference's pmax/pmin do)
_COMBINE = {
    "add": torch.add,
    "mul": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "and": torch.bitwise_and,
    "or": torch.bitwise_or,
    "xor": torch.bitwise_xor,
}


class Executor:
    """Run a Graph on one device, or on every device of a mesh.

    ``schedule`` is ``"dag"`` (dependency-DAG waves, default) or
    ``"sequential"`` (program order); both give the same state.
    ``layout_overrides`` forces a layout per record tensor for the whole
    plan, ``segment_layout_overrides`` per segment (segment index -> key ->
    layout), and ``tile_overrides`` forces kernel tiles (kernel name ->
    tile) while the nodes run.

    ``mesh`` (a :class:`~repro_torch.core.mesh.Mesh` from ``make_mesh``)
    runs partitioned tensors as shards, one program per shard, with halo
    exchange and the overlapped interior/boundary lowering (see the
    module docstring); the executor's device is then the mesh's first.

    ``regions=True`` (the default, as the reference's) runs each device
    region as captured CUDA graphs over static buffers (on the CPU: the
    same code without capture), which nodes that take ``out=`` write in
    place; ``donate=True`` (the default) returns aliases of those buffers
    under the reference's contract for a returned state (see the module
    docstring); on a mesh too, when its shards share one device; every
    result equals ``regions=False``'s (the per-segment escape hatch) bit
    for bit.

    ``tune`` is ``"off"`` (the heuristics), ``"load"`` (apply a cached
    decision, heuristics on a miss, never measure) or ``"auto"`` (measure
    on a miss and persist; on a mesh too, each candidate over the same
    mesh): ``tune_budget`` bounds the search (a
    :class:`~repro_torch.tuning.search.TuneBudget` or a dict of its
    fields) and ``tune_inputs`` are the ``init_state`` overrides every
    candidate is timed on.

    ``async_regions`` (default True) runs host regions on the host pool
    under ``regions=True`` (False: on the calling thread, after the
    device is idle); ``host_timeout`` bounds each wait on a pooled
    callback; ``degrade``, ``demote_after`` and ``promote_after`` drive
    the degradation ladder (see the module docstring; ``ladder_level``,
    ``plan.degradations``).  ``async_stats`` counts, over the executor's
    life, the callbacks submitted, the bytes their snapshots cloned, the
    drains inside a call (barriers, host loops, builds), the most
    callbacks in flight at once and the seconds the dispatcher waited on
    callbacks (``wait_s``: the in-flight cap and the drains).

    Example::

        ex = Executor(graph)          # on the GPU: captured CUDA graphs
        state = ex.run(ex.init_state(), steps=100)
        state = ex.run(state, steps=100)      # donated: no copy
        print(ex.describe_dag(), ex.cache_stats())
        eager = Executor(graph, regions=False)   # per-segment dispatch
        ex_cpu = Executor(graph, device="cpu")   # plain PyTorch versions
        mesh = make_mesh((2, 2), ("gx", "gy"), devices=["cuda:0"] * 4)
        ex = Executor(graph, mesh=mesh)       # four shards, one graph
        ex = Executor(graph, tune="auto")     # measures once, persists
        ex = Executor(graph, mesh=mesh, tune="auto")   # ... on the mesh
        print(ex.describe_tuning())           # what won, and why
        print(ex.plan.describe())             # DAG, regions, ladder, tuning
    """

    #: Ladder levels, fastest first: the configured operating point, then
    #: synchronous host regions, then the sequential schedule, then the
    #: heuristic (untuned) layouts and tiles.  ``demote_after`` transient
    #: failures at one site move one level down, ``promote_after`` clean
    #: calls in a row one level up; each move is a DegradationEvent in
    #: ``plan.degradations``.
    LADDER = ("async_regions", "sync", "sequential", "heuristic")

    def __init__(self, graph: Graph, device: Any = None, *,
                 layout_overrides: Optional[dict[str, Layout]] = None,
                 schedule: str = "dag",
                 segment_layout_overrides: Optional[
                     dict[int, dict[str, Layout]]] = None,
                 tile_overrides: Optional[dict[str, Any]] = None,
                 mesh: Any = None, tune: str = "off",
                 tune_budget: Optional[Any] = None,
                 tune_inputs: Optional[dict[str, Any]] = None,
                 regions: bool = True, donate: bool = True,
                 async_regions: bool = True,
                 host_timeout: Optional[float] = None,
                 degrade: bool = True, demote_after: int = 2,
                 promote_after: int = 8):
        if schedule not in ("dag", "sequential"):
            raise ValueError(
                f"schedule must be 'dag' or 'sequential', got {schedule!r}")
        if tune not in ("off", "load", "auto"):
            raise ValueError(
                f"tune must be 'off', 'load' or 'auto', got {tune!r}")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh= takes a Mesh (make_mesh), got "
                                f"{type(mesh).__name__}")
            if regions and len(set(mesh.devices)) > 1:
                raise NotImplementedError(
                    f"regions=True (the default) on a mesh over several "
                    f"devices is {_ITEM_CARDS}; regions=False runs it "
                    f"eagerly")
            if device is not None and \
                    resolve_device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"first device {mesh.devices[0]}")
            device = mesh.devices[0]
        self.graph = graph
        self.mesh = mesh
        self.device = resolve_device(device)
        self.regions = bool(regions)
        self.donate = bool(donate)
        # not in the plan signature: both modes replay the same graphs
        self.async_regions = bool(async_regions)
        self.host_timeout = host_timeout
        self.degrade = bool(degrade)
        self.demote_after = int(demote_after)
        self.promote_after = int(promote_after)
        self.async_stats = {"callbacks": 0, "snapshot_bytes": 0,
                            "barrier_drains": 0, "peak_inflight": 0,
                            "wait_s": 0.0}
        self._cache: Optional[ExecutableCacheEntry] = None
        # cache key -> (entry, finalizer): every plan this executor ran,
        # each entry leased until the executor goes (a ladder move back
        # finds its entry, graphs and buffers again)
        self._leases: dict = {}
        self._running: Optional[str] = None    # the node being lowered
        # inside a piece's lowering: where nodes may write in place
        self._inplace: Optional[_InPlace] = None
        self._out_fns: dict = {}      # node name -> its fn takes out=
        self.tensors = graph.all_tensors()
        self.results = graph.all_results()
        # a partitioned tensor without a mesh is one whole tensor (the
        # reference's unsharded lowering)
        self._sharded = any(t.is_sharded(mesh)
                            for t in self.tensors.values())
        self.dag = schedule_lib.build_dag(graph)
        # the configured operating point: level 0 of the ladder
        self._cfg_schedule = schedule
        self._cfg_async = self.async_regions
        self._user_layout_overrides = dict(layout_overrides or {})
        self._user_segment_overrides = {
            int(i): dict(v)
            for i, v in (segment_layout_overrides or {}).items()}
        self._user_tile_config = dict(tile_overrides or {})
        self._tuned: Optional[tuple] = None   # what level 3 set aside
        self.ladder_level = 0
        self._site_failures: dict[str, int] = {}
        self._clean_passes = 0
        self._pass_counter = 0
        self._degradations: list[DegradationEvent] = []
        self._apply_schedule(schedule)
        self._layout_overrides = dict(self._user_layout_overrides)
        self._segment_overrides = {
            i: dict(v) for i, v in self._user_segment_overrides.items()}
        self._tile_config = dict(self._user_tile_config)
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

    def _apply_schedule(self, schedule: str) -> None:
        """(Re)build the segment schedule: at construction, and when the
        ladder moves to or from ``"sequential"``."""
        self.schedule = schedule
        if schedule == "dag":
            self._segments = schedule_lib.dag_segments(self.dag)
        else:
            self._segments = schedule_lib.sequential_segments(self.graph)
            schedule_lib.place_units(self.dag, self._segments)

    def _apply_ladder_level(self, level: int) -> None:
        """Configure the executor for one ladder level.  Level 0 is the
        configured operating point; deeper levels stack: 1 runs host
        regions synchronously, 2 also takes the sequential schedule, 3
        also sets the tuned layouts and tiles aside for the heuristics
        (a promotion to 2 restores them).  A rebuilt plan keys the
        executable cache by its own signature, and the executor keeps its
        lease on every entry it ran, so a level visited before captures
        nothing."""
        self.ladder_level = level
        self.async_regions = self._cfg_async and level < 1
        schedule = self._cfg_schedule if level < 2 else "sequential"
        layouts = self._layout_overrides
        tiles = self._tile_config
        segs = self._segment_overrides
        if level >= 3 and self._tuned is None:
            self._tuned = (layouts, tiles, segs)
            layouts = dict(self._user_layout_overrides)
            tiles = dict(self._user_tile_config)
            segs = {i: dict(v)
                    for i, v in self._user_segment_overrides.items()}
        elif level < 3 and self._tuned is not None:
            layouts, tiles, segs = self._tuned
            self._tuned = None
        if (schedule, layouts, tiles, segs) == (
                self.schedule, self._layout_overrides, self._tile_config,
                self._segment_overrides):
            return
        tuning = self.plan.tuning
        self._apply_schedule(schedule)
        self._layout_overrides = layouts
        self._tile_config = tiles
        self._segment_overrides = segs
        self._build_plan()
        self.plan.tuning = tuning

    def record_failure(self, exc: BaseException, site: str = "") -> bool:
        """The ladder's account of one failed call: a
        :class:`TransientError` (an injected fault, the watchdog's
        timeout) counts against ``site`` (default: the error's own), and
        the ``demote_after``-th at one site moves the executor one level
        down.  Any other error moves nothing.  Returns True on a
        demotion.  ``run()`` calls it; a driver that catches failures
        itself may too."""
        if not self.degrade or not isinstance(exc, TransientError):
            return False
        site = site or getattr(exc, "site", "") or "executor"
        self._clean_passes = 0
        n = self._site_failures.get(site, 0) + 1
        self._site_failures[site] = n
        if n < self.demote_after \
                or self.ladder_level >= len(self.LADDER) - 1:
            return False
        frm = self.LADDER[self.ladder_level]
        self._apply_ladder_level(self.ladder_level + 1)
        self._site_failures[site] = 0
        self._degradations.append(DegradationEvent(
            self._pass_counter, "demote", frm,
            self.LADDER[self.ladder_level], site,
            f"{n} transient failures at {site} ({exc})"))
        return True

    def _note_clean_pass(self) -> None:
        """One call that succeeded: after ``promote_after`` in a row at a
        degraded level, move one level back up."""
        self._pass_counter += 1
        if self.ladder_level == 0:
            return
        self._clean_passes += 1
        if self._clean_passes < self.promote_after:
            return
        frm = self.LADDER[self.ladder_level]
        self._apply_ladder_level(self.ladder_level - 1)
        self._clean_passes = 0
        self._site_failures.clear()
        self._degradations.append(DegradationEvent(
            self._pass_counter, "promote", frm,
            self.LADDER[self.ladder_level], "",
            f"{self.promote_after} clean passes"))

    def _build_plan(self) -> None:
        """Solve layouts under the current overrides and derive what
        depends on them: the regions and their footprints, the plan
        signature and the loop sub-executors.  Run once at construction,
        again when the autotuner commits a configuration that differs
        from the heuristics, and at each ladder move that changes the
        schedule or the overrides."""
        self.plan = solve_layouts(self._segments, self.tensors,
                                  overrides=self._layout_overrides,
                                  segment_overrides=self._segment_overrides)
        self.plan.dag = self.dag
        if self.mesh is not None:
            for name, t in self.tensors.items():
                lays = {self.plan.initial.get(name, t.layout)}
                lays.update(seg[name] for seg in self.plan.per_segment
                            if name in seg)
                for lay in lays:
                    (t.with_(layout=lay) if t.is_record
                     else t).validate_mesh(self.mesh)
        self._overlap_decisions: dict[str, _OverlapDecision] = {}
        self._collect_halo_schedule()
        self.plan.regions = schedule_lib.group_regions(
            [k for k, _ in self._segments])
        # filled as region programs are built (and by describe_dag)
        self.plan.region_graphs = {} if self.regions else None
        self.plan.region_edges = schedule_lib.region_dag(self.dag,
                                                         self.plan.regions)
        # the barrier bit per region: a barrier host region drains the pool
        self._region_access = schedule_lib.region_access(self.dag,
                                                         self.plan.regions)
        # the ladder's log outlives the plans its moves rebuild
        self.plan.degradations = self._degradations
        # the layouts a state is in outside a call: the configured plan's
        # initial layouts, kept while the ladder runs another plan (whose
        # first piece or segment converts from them, and whose exit
        # converts back)
        if self.ladder_level == 0:
            self._io_layouts = dict(self.plan.initial)
        # physical layout of each record tensor's state entry right now
        self._state_layouts: dict[str, Layout] = dict(self._io_layouts)
        self._layout_keys = tuple(sorted(self.plan.initial))
        self._plan_sig = plan_signature(self)
        self.plan.signature = hashlib.sha1(
            repr(self._plan_sig).encode()).hexdigest()[:12]
        # conversions made eagerly: at segment boundaries (loop bodies'
        # included), and under regions=True at host regions and on exit
        self.eager_relayouts = 0
        self._sub_execs: dict[int, Executor] = {}   # loop segment -> body
        self._cache = None
        self._fetched: set = set()

    def _collect_halo_schedule(self) -> None:
        """Static pass: record every scheduled halo block per segment in
        ``plan.halo_transfers``, decide overlap per node, and list every
        declined ``overlap=True`` in ``plan.overlap_fallbacks`` (warning
        once where the fallback degrades real transfers)."""
        mesh = self.mesh
        for si, (kind, payload) in enumerate(self._segments):
            seg_layouts = self.plan.per_segment[si]

            def eff(t, _lays=seg_layouts):
                if t.is_record:
                    lay = _lays.get(t.name, t.layout)
                    if lay is not t.layout:
                        return t.with_(layout=lay)
                return t

            for node in _segment_nodes(kind, payload):
                if node.kind not in ("split", "op"):
                    continue
                dec = None
                if node.kind == "split" and node.overlap:
                    dec = _decide_overlap(node, mesh, eff)
                    self._overlap_decisions[node.name] = dec
                    if dec.strips is None:
                        self.plan.overlap_fallbacks.append(
                            OverlapFallback(si, node.name, dec.reason))
                        key = (node.name, dec.reason)
                        if dec.warn and key not in _warned_overlap:
                            _warned_overlap.add(key)
                            warnings.warn(
                                f"node {node.name!r}: overlap=True falls "
                                f"back to synchronous halo exchange — "
                                f"{dec.reason}", RuntimeWarning,
                                stacklevel=4)
                overlapped = dec is not None and dec.strips is not None
                for _, t, mode in node.tensor_args():
                    if not mode.padded:
                        continue
                    eff_t = eff(t)
                    entries = _halo_plan(eff_t, mesh)
                    if not entries:
                        continue
                    axes = _halo_axes(entries)
                    shard = _shard_storage_shape(eff_t, mesh)
                    itemsize = torch.empty((), dtype=eff_t.dtype) \
                        .element_size()
                    for phase, bkey, shape in halo_lib.schedule_blocks(
                            shard, axes):
                        last, _side = bkey[-1]
                        self.plan.halo_transfers.append(HaloTransfer(
                            si, node.name, t.name, phase,
                            tuple((entries[j].dim, s) for j, s in bkey),
                            entries[last].mesh_axis, entries[last].width,
                            overlapped,
                            nbytes=math.prod(shape) * itemsize))

    # -- executable cache --------------------------------------------------
    def _cache_key(self) -> tuple:
        index = self.device.index
        if index is None and self.device.type == "cuda":
            index = torch.cuda.current_device()
        return (self._plan_sig, self.device.type, index)

    def _entry(self) -> ExecutableCacheEntry:
        """This plan's executable-cache entry, fetched on first use and
        leased to this executor until it is collected; every live
        executor of the signature shares it."""
        if self._cache is not None:
            return self._cache
        key = self._cache_key()
        lease = self._leases.get(key)
        if lease is None:
            entry = _EXECUTABLE_CACHE.get(key)
            if entry is None:
                entry = _EXECUTABLE_CACHE[key] = ExecutableCacheEntry(key)
            lease = self._leases[key] = (entry, entry.acquire(self))
        self._cache = self.plan.cache = lease[0]
        return self._cache

    def _entries(self):
        """The entries whose buffers a call may write: this plan's, and
        those of its ``host_loop`` bodies (a ``loop`` body runs on its
        enclosing plan's entry)."""
        yield self._entry()
        for i, (kind, _) in enumerate(self._segments):
            if kind == "host_loop":
                yield from self._sub_executor(i)._entries()

    def _take_in(self, state: dict) -> tuple[dict, set]:
        """The state a call starts from: each live alias passed back under
        its own key replaced by its buffer (donated; their ``id``s are
        returned), every other live alias moved out onto a clone
        (:meth:`ExecutableCacheEntry.take_back`), then every tensor that
        lies in another key's static buffer (a view of a returned tensor)
        cloned, so that no buffer is written before every key that holds
        it has been read.  Tensors are looked up by storage; a
        ShardedArray shard by shard."""
        out = dict(state)
        donated: set = set()
        storages: dict = {}
        for e in self._entries():
            donated |= e.take_back(out)
            storages.update(e.storages)
        if not storages:
            return out, donated
        for k, x in list(out.items()):
            if any(storages.get(_storage(t), k) != k for t in _tensors(x)):
                out[k] = _clone(x)
        return out, donated

    def cache_stats(self) -> dict:
        """Live executable-cache counters of this plan (``regions=True``).

        ``trace_events`` counts the pieces built (graph captures on the
        card); a steady-state ``run()`` leaves it unchanged.  ``hits``
        counts programs this or another executor fetched without building
        them — the re-instantiated-executor reuse path.  ``copy_backs``
        and ``copy_back_bytes`` count the copies that the built pieces
        make at their ends into the static buffers, each piece run once
        (one step of a device-only graph; one iteration of a loop body):
        the outputs not written in place, which aliasing forces.  A
        capture replays its build's copies.  ``reduce_kernel`` and
        ``reduce_torch`` count the built pieces' local reductions the same
        way, by route (``Reducer.route``): those that launched a
        hand-written kernel (the NaN-ignoring max/min's,
        ``kernels/reduce``) and those that ran torch ops (another reducer,
        or a tensor the kernel does not take: on the CPU, every one).
        ``halo_bytes`` counts the same way the bytes that the built
        pieces' halo assembly writes: every padded copy a node reads,
        each cell once (the interior's placement and the halo cells'
        fills), the overlapped lowering's blocks left out (its transfers
        are ``plan.halo_transfers``).  ``moved_out`` and
        ``moved_out_bytes`` count, over the entry's life, the returned
        aliases moved onto clones because a call did not take them back
        (``donate=True``: a switch between states)."""
        c = self._entry()
        pieces = [p for e in self._entries() for prog in e.executables.values()
                  for p in _pieces(prog.steps) if p.out_bufs is not None]
        return {"signature": self.plan.signature,
                "executables": len(c.executables), "builds": c.builds,
                "hits": c.hits, "trace_events": c.trace_events,
                "copy_backs": sum(p.copies[0] for p in pieces),
                "copy_back_bytes": sum(p.copies[1] for p in pieces),
                "reduce_kernel": sum(p.routes[0] for p in pieces),
                "reduce_torch": sum(p.routes[1] for p in pieces),
                "halo_bytes": sum(p.halo for p in pieces),
                "moved_out": c.moved_out,
                "moved_out_bytes": c.moved_out_bytes}

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
        dict is in the configured plan's initial layouts."""
        return self._convert_layouts(state, self._io_layouts)

    def _convert_layouts(self, state: dict,
                         targets: dict[str, Layout]) -> dict:
        for name, lay in targets.items():
            t = self.tensors[name]
            cur = self._state_layouts.get(name, t.layout)
            if cur is lay:
                continue
            v = state[name]
            if isinstance(v, ShardedArray):
                # the component axis is never split and AoSoA's tiled dim
                # is whole in every shard, so each shard converts alone
                dst = t.with_(layout=lay)
                state[name] = v.map(
                    lambda x: relayout(RecordArray(x, t.spec, cur),
                                       lay).data,
                    dst.placement(self.mesh), dst.storage_shape)
            else:
                state[name] = relayout(RecordArray(v, t.spec, cur),
                                       lay).data
            self._state_layouts[name] = lay
            self.eager_relayouts += 1
        return state

    # -- state management ------------------------------------------------
    def init_state(self, **overrides) -> dict[str, Any]:
        """Allocate all tensors/results on the executor's device (zeros
        unless overridden).  Record tensors are materialized in the layout
        the solver chose for their first consuming segment (of the
        configured plan, whatever the ladder runs); an override in another
        layout is relayouted on the way in.  On a mesh a partitioned
        tensor's override is a global array, scattered into shards (a
        :class:`~repro_torch.core.mesh.ShardedArray` is gathered first)."""
        self._state_layouts = dict(self._io_layouts)
        state: dict[str, Any] = {}
        for name, t in self.tensors.items():
            eff = self._eff(t)
            if name in overrides:
                v = overrides[name]
                if isinstance(v, ShardedArray):
                    v = v.to_global()
                if isinstance(v, RecordArray):
                    data = relayout(v, eff.layout).data
                elif t.is_record:
                    v = _as_tensor(v)
                    src = self._infer_override_layout(t, v.shape)
                    data = relayout(RecordArray(v, t.spec, src),
                                    eff.layout).data
                else:
                    data = _as_tensor(v)
                if eff.is_sharded(self.mesh):
                    state[name] = ShardedArray.from_global(data, self.mesh,
                                                           eff)
                else:
                    state[name] = data.to(self.device)
            else:
                v = eff.init(self.device, mesh=self.mesh)
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
            [self._io_layouts.get(t.name, t.layout), t.layout]))
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
        tensor's current physical layout); a sharded entry is gathered
        into one tensor on the mesh's first device."""
        data = state[t.name]
        if isinstance(data, ShardedArray):
            data = data.to_global()
        return self._eff(t).wrap(data)

    def state_shardings(self, state: dict) -> dict:
        """The :class:`~repro_torch.core.mesh.Placement` of every state
        entry on the mesh (``None`` per entry without a mesh); an
        unsplit entry's spec names no mesh axis and it lies on the mesh's
        first device."""
        if self.mesh is None:
            return {k: None for k in state}
        out = {}
        for k in state:
            t = self.tensors.get(k)
            spec = self._eff(t).pspec() if t is not None else ()
            out[k] = Placement(self.mesh, spec)
        return out

    def describe_dag(self) -> str:
        """Render the dependency DAG, its segment/wave placement under the
        active schedule, the relayouts at each segment entry, the regions
        (with ``regions=True``: the graphs each device region runs as) and
        the executable-cache counters."""
        if self.regions:
            self._entry()
            entry = {n: self._io_layouts[n] for n in self._layout_keys}
            self.plan.region_graphs = {
                r.index: _count_graphs(self._plan_steps(
                    r.segments, entry, "")[0])
                for r in self.plan.regions if r.kind == "device"}
        return self.plan.describe_dag()

    def describe_tuning(self) -> str:
        """Render the measured autotuner's decision for this plan
        (``plan.describe_tuning()``): baseline vs tuned steady-state
        times, every measured candidate, and what was committed."""
        return self.plan.describe_tuning()

    # -- node lowering -----------------------------------------------------
    def _resolve_args(self, node: Node, state: dict,
                      layouts: dict[str, Layout]):
        """The Python args passed to a node fn that runs once (on the
        executor's device, or on the host); haloed where needed.  A sharded
        entry is gathered into its global tensor first."""
        vals = []
        for a in node.args:
            if isinstance(a, ReductionResult):
                vals.append(state[a.name])
                continue
            t, mode = _tensor_arg(a)
            if t is None:
                vals.append(a)
                continue
            t = self._eff_in(t, layouts)
            data = state[t.name]
            if isinstance(data, ShardedArray):
                data = data.to_global()
            if mode.padded:
                data = self._padded(data, t)
            vals.append(t.wrap(data) if t.is_record else data)
        return vals

    def _padded(self, data, t: DistTensor, mesh: Optional[Mesh] = None):
        """A segment's halo assembly: ``data`` (a tensor, or on a mesh the
        shards of every mesh coordinate) extended by all of ``t``'s halos
        through the transfer schedule, corners included, each result one
        new contiguous tensor.  Its bytes count towards the piece being
        lowered (``cache_stats()["halo_bytes"]``); a ``ripple.halo`` span
        records it, with its ``bytes`` and the record's ``fields`` (a
        replay, which never comes here, records none)."""
        entries = _halo_plan(t, mesh)
        if not entries:
            return data
        ip = self._inplace
        with trace.span("ripple.halo") as sp:
            out = halo_lib.exchange_multi(
                data, _halo_axes(entries), boundary=t.boundary,
                constant=t.boundary_constant, mesh=mesh)
        if ip is not None or sp is not None:
            nbytes = sum(x.numel() * x.element_size()
                         for x in ((out,) if isinstance(out, torch.Tensor)
                                   else out))
            if ip is not None:
                ip.halo += nbytes
            if sp is not None:   # after the span: not in its time
                sp.attrs.update(bytes=nbytes, fields=t.spec.num_components
                                if t.is_record else 1)
        return out

    def _per_shard(self, node: Node) -> bool:
        """True when ``node`` runs once per shard: on a mesh, one of its
        tensor args names a mesh axis."""
        return self._sharded and any(t.is_sharded(self.mesh)
                                     for _, t, _ in node.tensor_args())

    def _shard_args(self, node: Node, state: dict,
                    layouts: dict[str, Layout]) -> list[list]:
        """Per mesh coordinate, the args of one shard's program: each
        partitioned tensor's shard (extended by the transfer schedule when
        padded), unpartitioned tensors and results moved to the shard's
        device (a no-op on the mesh's first)."""
        devices = self.mesh.devices
        per: list[list] = [[] for _ in devices]
        for a in node.args:
            if isinstance(a, ReductionResult):
                v = state[a.name]
                for c, dev in enumerate(devices):
                    per[c].append(v.to(dev))
                continue
            t, mode = _tensor_arg(a)
            if t is None:
                for vals in per:
                    vals.append(a)
                continue
            t = self._eff_in(t, layouts)
            data = state[t.name]
            if isinstance(data, ShardedArray):
                shards = list(data.shards)
                if mode.padded:
                    shards = self._padded(shards, t, self.mesh)
            else:
                if mode.padded:
                    data = self._padded(data, t)
                shards = [data.to(dev) for dev in devices]
            for vals, x in zip(per, shards):
                vals.append(t.wrap(x) if t.is_record else x)
        return per

    def _store_shards(self, node, state, write_tensors, outs,
                      layouts, bufs=None) -> None:
        """Write one output per shard: a partitioned tensor becomes a
        ShardedArray, an unpartitioned one keeps the first shard's value
        (every shard computed it; the reference's replicated output).
        ``bufs`` are the static buffers the shards were handed as
        ``out=`` (:meth:`_node_outs`)."""
        if not write_tensors:
            return
        rows = [_outputs(node, write_tensors, out) for out in outs]
        for wi, t in enumerate(write_tensors):
            vals = [self._coerce_write(t, row[wi], layouts) for row in rows]
            buf = None if bufs is None else bufs[wi]
            eff = self._eff_in(t, layouts)
            if not eff.is_sharded(self.mesh):
                state[t.name] = self._landed(t.name, vals[0], buf)
                continue
            pl = eff.placement(self.mesh)
            want = pl.shard_shape(eff.storage_shape)
            for v in vals:
                if tuple(v.shape) != want:
                    raise ValueError(
                        f"{node.name}: a shard of {t.name} came out "
                        f"{tuple(v.shape)}, its placement holds {want}")
            state[t.name] = self._landed(
                t.name, ShardedArray(vals, pl, eff.storage_shape), buf)

    def _landed(self, name: str, value, buf):
        """The value to keep for ``name``: its static buffer ``buf`` (noted
        as written in place) when the node wrote there, else ``value``."""
        if buf is not None and _is_buffer(value, buf):
            self._inplace.wrote.add(name)
            return buf
        return value

    @staticmethod
    def _write_tensors(node: Node) -> list[DistTensor]:
        return [node.args[i].tensor if isinstance(node.args[i], TensorArg)
                else node.args[i] for i in node.default_writes()]

    def _lower_split(self, node: Node, state: dict,
                     layouts: dict[str, Layout], bufs=None) -> None:
        write_tensors = self._write_tensors(node)
        if self._per_shard(node):
            dec = self._overlap_decisions.get(node.name)
            if node.overlap and dec is not None and dec.strips is not None:
                self._lower_split_overlapped(node, state, write_tensors,
                                             dec.strips, layouts, bufs)
                return
            outs = [node.fn(*vals, **self._out_kw(bufs, write_tensors, c,
                                                   layouts))
                    for c, vals in enumerate(
                        self._shard_args(node, state, layouts))]
            self._store_shards(node, state, write_tensors, outs, layouts,
                               bufs)
            return
        vals = self._resolve_args(node, state, layouts)
        out = node.fn(*vals, **self._out_kw(bufs, write_tensors, None,
                                            layouts))
        self._store_writes(node, state, write_tensors, out, layouts, bufs)

    # -- outputs written in place (regions) ----------------------------------
    def _node_outs(self, node: Node, level, snapshot: dict, state: dict,
                   layouts: dict[str, Layout]) -> Optional[list]:
        """Inside a piece's lowering (``regions=True``), the static buffer
        each tensor ``node`` writes may take as ``out=`` (None where it
        may not), or None when none may: the node's function takes
        ``out=`` and, per written key, :meth:`_may_write` holds."""
        ip = self._inplace
        if ip is None or node.fn is None:
            return None
        takes = self._out_fns.get(node.name)
        if takes is None:
            takes = self._out_fns[node.name] = _takes_out(node.fn)
        if not takes:
            return None
        overlapped = node.kind == "split" and node.overlap \
            and self._per_shard(node) and getattr(
                self._overlap_decisions.get(node.name), "strips", None)
        bufs = []
        for t in self._write_tensors(node):
            buf = self._out_buffer(ip.entry, t, layouts)
            ok = self._may_write(node, t.name, buf, level, snapshot, state,
                                 layouts, own_reads=not overlapped)
            bufs.append(buf if ok else None)
        return bufs if any(b is not None for b in bufs) else None

    def _out_buffer(self, entry: ExecutableCacheEntry, t: DistTensor,
                    layouts: dict[str, Layout]):
        """The static buffer(s) of written tensor ``t`` in the segment's
        layout: one tensor, or on a mesh one per shard."""
        eff = self._eff_in(t, layouts)
        if eff.is_sharded(self.mesh):
            return entry.sharded(t.name, eff.placement(self.mesh),
                                 eff.storage_shape, t.dtype)
        return entry.buffer(t.name, eff.storage_shape, t.dtype, self.device)

    def _may_write(self, node: Node, name: str, buf, level, snapshot: dict,
                   state: dict, layouts: dict[str, Layout], *,
                   own_reads: bool = True) -> bool:
        """Whether ``node`` may write key ``name`` into its static buffer
        ``buf``: (i) no other node of its level reads a value that lies in
        ``buf`` (a level runs against one snapshot, which an in-place write
        must not reach); (ii) where the node itself reads ``buf`` (its own
        arg of ``name``, not through a padded copy), its function is marked
        :func:`~repro_torch.core.graph.in_place`, and no other arg of it
        lies there; (iii) no other key's value lies in ``buf`` (a value a
        later node, piece, host callback or the caller still reads);
        (iv) ``buf`` is stored in the layout of every record arg of the
        key's record type (a kernel writes ``out`` in its input's layout;
        the output is copied back otherwise).
        ``own_reads=False`` skips (ii) for the overlapped lowering, which
        stitches its outputs after every program of the node has run."""
        written = next((t for t in self._write_tensors(node)
                        if t.name == name), None)
        if written is not None and written.is_record:
            lay = self._eff_in(written, layouts).layout
            for a in node.args:
                t, _ = _tensor_arg(a)
                if t is not None and t.spec == written.spec and \
                        self._eff_in(t, layouts).layout is not lay:
                    return False
        stores = _storages(buf)
        for other in level:
            if other is not node and any(
                    _storages(snapshot.get(r)) & stores
                    for r in _segment_reads([other])):
                return False
        if any(k != name and _storages(v) & stores
               for k, v in state.items()):
            return False
        if not own_reads:
            return True
        for a in node.args:
            t, mode = _tensor_arg(a)
            key = t.name if t is not None else (
                a.name if isinstance(a, ReductionResult) else None)
            if key is None or not _storages(snapshot.get(key)) & stores:
                continue
            if key != name:
                return False
            if t is not None and mode.padded and _halo_plan(
                    self._eff_in(t, layouts),
                    self.mesh if isinstance(snapshot[key], ShardedArray)
                    else None):
                continue            # it reads a padded copy
            if not getattr(node.fn, "in_place", False):
                return False
        return True

    def _out_kw(self, bufs, write_tensors, shard: Optional[int],
                layouts: dict[str, Layout]) -> dict:
        """The ``out=`` keyword of one call of a node's function (of mesh
        coordinate ``shard``, None off the mesh): each written tensor's
        buffer (a record wrapped in the segment's layout) or None; one
        value for one written tensor, a tuple for several."""
        if bufs is None:
            return {}
        vals = []
        for t, buf in zip(write_tensors, bufs):
            if isinstance(buf, ShardedArray):
                buf = buf.shards[shard]
            elif shard:                 # a replicated output: shard 0's
                buf = None
            if buf is not None and t.is_record:
                buf = self._eff_in(t, layouts).wrap(buf)
            vals.append(buf)
        return {"out": vals[0] if len(vals) == 1 else tuple(vals)}

    def _lower_split_overlapped(self, node: Node, state: dict,
                                write_tensors,
                                strips: tuple[tuple[int, int], ...],
                                layouts: dict[str, Layout],
                                bufs=None) -> None:
        """Interior/boundary split over N partitioned halo axes, per shard:
        every halo block's copy starts up front (phase 1 edge strips,
        phase 2+ corner hops; on a CUDA mesh on each device's copy
        stream), the interior programs run on the unextended shards while
        they fly, then one boundary-strip program per (axis, side) and
        shard consumes the blocks and the outputs are stitched (paper
        Fig. 7 over the transfer space of §5.4).

        ``strips`` is ((space_dim, W), ...) ascending; ``fn`` must be a
        shape-polymorphic stencil mapping (m + 2w) -> m cells along every
        haloed dim.  fn sees, per variant, exactly the sub-region of the
        extended shard that its output cells read, so the overlapped
        output equals the synchronous one value for value.  Under regions
        the outputs are stitched into the written tensors' static buffers
        (``bufs``), unless a program's output lies there."""
        mesh = self.mesh
        n = mesh.size
        strip_dims = [d for d, _ in strips]
        w_strip = dict(strips)

        # resolve every arg once: all copies start here, before any
        # program runs.  _decide_overlap held every tensor arg to the
        # partitioned strip dims, so each is a ShardedArray
        preps: list[tuple[str, Any]] = []
        written = {t.name for t in write_tensors}
        interior_reads_fills = False
        with _on_copy_streams(mesh.devices) as compute:
            for a in node.args:
                if isinstance(a, ReductionResult):
                    v = state[a.name]
                    preps.append(("raw", [v.to(d) for d in mesh.devices]))
                    continue
                t, mode = _tensor_arg(a)
                if t is None:
                    preps.append(("raw", [a] * n))
                    continue
                t = self._eff_in(t, layouts)
                shards = state[t.name].shards
                entries = ({e.dim: e for e in _halo_plan(t, mesh)}
                           if mode.padded else {})
                dims = sorted(set(entries) | set(strip_dims))
                axes = [halo_lib.HaloAxis(
                    t.storage_axis(d),
                    entries[d].width if d in entries else 0,
                    entries[d].mesh_axis if d in entries else None)
                    for d in dims]
                if any(ax.width for ax in axes):
                    blocks = halo_lib.exchange_blocks(
                        shards, axes, boundary=t.boundary,
                        constant=t.boundary_constant, mesh=mesh)
                else:
                    blocks = [{(): x} for x in shards]
                # a haloed dim with no strip is filled for the interior too
                interior_reads_fills |= any(
                    ax.width and d not in w_strip
                    for d, ax in zip(dims, axes))
                # an unpadded arg the node writes is its output's shape,
                # passed as a view of the region; any other arg is made
                # contiguous, since a kernel may read it
                dense = mode.padded or t.name not in written
                preps.append(("tensor", (t, dims, axes, blocks, dense)))
            done = None if compute is None else {
                d: _copy_stream(d).record_event() for d in compute}

        def wait_for_copies():
            if compute is None:
                return
            for d, ev in done.items():
                compute[d].wait_event(ev)
            # blocks made on a copy stream are read on the compute stream:
            # their memory must not go back to the copy stream's pool
            # before those reads are done
            for kind, payload in preps:
                if kind == "tensor":
                    for b in payload[3]:
                        for key, blk in b.items():
                            if key:
                                blk.record_stream(compute[blk.device])

        def ranges_for(variant, dims, axes, shard):
            """Per-axis extended-coordinate input range for one variant:
            the full boundary slab along its own dim, the interior along
            every earlier strip dim (peeled off by earlier variants), the
            full extent elsewhere — widened by this arg's own halo."""
            vd = None if variant == "interior" else variant[0]
            out = []
            for d, ax in zip(dims, axes):
                m = shard.shape[ax.axis]
                w, big_w = ax.width, w_strip.get(d, 0)
                if d == vd:
                    out.append((0, big_w + 2 * w) if variant[1] == "low"
                               else (m - big_w, m + 2 * w))
                elif big_w and (vd is None or d < vd):
                    out.append((big_w, m - big_w + 2 * w))
                else:
                    out.append((0, m + 2 * w))
            return out

        def run(variant, c):
            vals = []
            for kind, payload in preps:
                if kind == "raw":
                    vals.append(payload[c])
                    continue
                t, dims, axes, blocks, dense = payload
                b = blocks[c]
                data = halo_lib.assemble_region(
                    b, axes, ranges_for(variant, dims, axes, b[()]))
                if dense:
                    data = data.contiguous()
                vals.append(t.wrap(data) if t.is_record else data)
            out = _outputs(node, write_tensors, node.fn(*vals))
            return [self._coerce_write(wt, v, layouts)
                    for wt, v in zip(write_tensors, out)]

        if interior_reads_fills:
            wait_for_copies()
        interior = [run("interior", c) for c in range(n)]
        if not interior_reads_fills:
            wait_for_copies()
        strip_outs = {
            (k, side): [run((d, side), c) for c in range(n)]
            for k, (d, _) in enumerate(strips) for side in ("low", "high")}

        # stitch: each variant's output copied once into the shard's place
        for wi, wt in enumerate(write_tensors):
            wt_eff = self._eff_in(wt, layouts)
            pl = wt_eff.placement(mesh)
            shape = pl.shard_shape(wt_eff.storage_shape)
            axes = [(wt_eff.storage_axis(d), w) for d, w in strips]

            def place(dst, part, k, side):
                """Cut variant (strip k, side)'s output domain out of
                ``dst`` (k = len(strips): the interior) and fill it."""
                for j, (ax, w) in enumerate(axes):
                    m = dst.shape[ax]
                    if j < k:
                        dst = dst.narrow(ax, w, m - 2 * w)
                    elif j == k:
                        dst = dst.narrow(ax, 0 if side == "low" else m - w,
                                         w)
                dst.copy_(part)

            buf = None if bufs is None else bufs[wi]
            shards = []
            for c in range(n):
                first = interior[c][wi]
                parts = [first] + [outs[c][wi] for outs in strip_outs.values()]
                o = None if buf is None else buf.shards[c]
                if o is None or any(_storage(p) == _storage(o)
                                    for p in parts):
                    o = torch.empty(shape, dtype=first.dtype,
                                    device=first.device)
                place(o, first, len(strips), None)
                for (k, side), outs in strip_outs.items():
                    place(o, outs[c][wi], k, side)
                shards.append(o)
            state[wt.name] = self._landed(
                wt.name, ShardedArray(shards, pl, wt_eff.storage_shape), buf)

    def _store_writes(self, node, state, write_tensors, out, layouts,
                      bufs=None) -> None:
        if not write_tensors:
            return
        for wi, (t, v) in enumerate(zip(write_tensors,
                                        _outputs(node, write_tensors, out))):
            state[t.name] = self._landed(
                t.name, self._coerce_write(t, v, layouts),
                None if bufs is None else bufs[wi])

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
                      layouts: dict[str, Layout], buf=None) -> None:
        """The reducer's local reduction; on a mesh, one per distinct
        shard, folded in mesh order on the mesh's first device (the
        reference's psum/pmax/... over the partitioned axes).  ``buf``
        (the result's static buffer under regions) receives the last step
        when the reducer's local takes ``out=`` or the fold's operation
        can, in the result's dtype."""
        t, field = node.args
        data = state[t.name]
        eff = self._eff_in(t, layouts)
        name = node.result.name
        routes = None if self._inplace is None else self._inplace.routes

        def local(x, dst=None):
            if t.is_record and field is not None:
                x = eff.wrap(x).field(field)
            if routes is not None:   # [kernel, torch]
                routes[node.reducer.route(x) != "kernel"] += 1
            if dst is not None and x.dtype == dst.dtype \
                    and x.device == dst.device:
                return node.reducer.local(x, out=dst)
            return torch.as_tensor(node.reducer.local(x)).to(self.device)

        if buf is not None and not self._out_fns.setdefault(
                ("reduce", node.name), _takes_out(node.reducer.local)):
            buf = None
        if isinstance(data, ShardedArray):
            reps = data.placement.representatives()
            if len(reps) == 1:
                out = local(data.shards[reps[0]], buf)
            else:
                parts = [local(data.shards[i]) for i in reps]
                op = _COMBINE[node.reducer.combine]
                out = functools.reduce(op, parts[:-1])
                if buf is not None and out.dtype == parts[-1].dtype \
                        == buf.dtype:
                    out = op(out, parts[-1], out=buf)
                else:
                    out = op(out, parts[-1])
        else:
            out = local(data, buf)
        if out is not buf:
            out = out.to(dtype=node.result.dtype)
        state[name] = self._landed(name, out, buf)

    def _reduce_out(self, node: Node, level, snapshot: dict,
                    state: dict) -> Optional[torch.Tensor]:
        """Inside a piece's lowering, the result's static buffer when the
        reduction may write it (rules (i) and (iii) of :meth:`_may_write`;
        a reduction never reads its own result)."""
        ip = self._inplace
        if ip is None:
            return None
        r = node.result
        buf = ip.entry.buffer(r.name, (), r.dtype, self.device)
        if self._may_write(node, r.name, buf, level, snapshot, state, {},
                           own_reads=False):
            return buf
        return None

    def _lower_levels(self, levels, state: dict,
                      layouts: dict[str, Layout]) -> dict:
        state = dict(state)
        for level in levels:
            # paper: nodes on a level are independent -> run all against
            # the same input snapshot, then merge
            snapshot = dict(state)
            for node in level:
                self._running = node.name
                if node.kind == "split":
                    tmp = dict(snapshot)
                    self._lower_split(node, tmp, layouts, self._node_outs(
                        node, level, snapshot, state, layouts))
                    for k, v in tmp.items():
                        if k not in snapshot or v is not snapshot[k]:
                            state[k] = v
                elif node.kind == "reduce":
                    tmp = dict(snapshot)
                    self._lower_reduce(node, tmp, layouts, self._reduce_out(
                        node, level, snapshot, state))
                    state[node.result.name] = tmp[node.result.name]
                elif node.kind == "op":
                    tmp = dict(snapshot)
                    wt = self._write_tensors(node)
                    bufs = self._node_outs(node, level, snapshot, state,
                                           layouts)
                    if self._per_shard(node):
                        outs = [node.fn(*vals, **self._out_kw(
                            bufs, wt, c, layouts)) if node.fn is not None
                            else None for c, vals in enumerate(
                                self._shard_args(node, tmp, layouts))]
                        if wt:
                            self._store_shards(node, tmp, wt, outs, layouts,
                                               bufs)
                    else:
                        vals = self._resolve_args(node, tmp, layouts)
                        out = node.fn(*vals, **self._out_kw(
                            bufs, wt, None, layouts)) \
                            if node.fn is not None else None
                        if wt:
                            self._store_writes(node, tmp, wt, out, layouts,
                                               bufs)
                    for t in wt:
                        state[t.name] = tmp[t.name]
                else:
                    raise ValueError(f"unexpected node kind {node.kind}")
        return state

    def _relayout_value(self, v, name: str, src: Layout, dst: Layout):
        """A record key's value converted ``src -> dst`` (a ShardedArray
        shard by shard: the component axis is never split and AoSoA's
        tiled dim is whole in every shard)."""
        t = self.tensors[name]
        if isinstance(v, ShardedArray):
            d = t.with_(layout=dst)
            return v.map(lambda x: relayout_data(x, t.spec, src, dst),
                         d.placement(self.mesh), d.storage_shape)
        return relayout_data(v, t.spec, src, dst)

    # -- conditional loops -------------------------------------------------
    def _sub_executor(self, i: int) -> "Executor":
        """The executor of loop segment ``i``'s body, built once per
        segment with the layouts the enclosing plan solved for it and the
        enclosing ``regions``, ``donate`` and ``host_timeout``.  The
        enclosing executor's ladder governs it: its own is off, and its
        host regions run asynchronously as the enclosing executor's do."""
        sub = self._sub_execs.get(i)
        if sub is None:
            sub = self._sub_execs[i] = Executor(
                self._segments[i][1], self.device, mesh=self.mesh,
                layout_overrides=self.plan.per_segment[i],
                schedule=self.schedule, tile_overrides=self._tile_config,
                regions=self.regions, donate=self.donate,
                async_regions=self.async_regions,
                host_timeout=self.host_timeout, degrade=False)
        return sub

    # -- region compile ------------------------------------------------------
    def _plan_steps(self, seg_indices, entry_layouts: dict[str, Layout],
                    label: str) -> tuple[list, dict[str, Layout]]:
        """The pieces and loops of a run of device/loop segments entered
        in ``entry_layouts``, and the layouts it exits in.  A loop
        segment's entry relayouts close the piece before it; its body is
        planned by its sub-executor, whose layouts are the loop's own."""
        current = dict(entry_layouts)
        steps: list = []
        chain: list = []
        reads: set = set()

        def close():
            if chain:
                steps.append(_Piece(f"{label}graph {len(steps)}",
                                    list(chain), tuple(sorted(reads))))
                chain.clear()
                reads.clear()

        for si in seg_indices:
            targets = self.plan.per_segment[si]
            conv = [(n, current[n], lay) for n, lay in sorted(targets.items())
                    if current.get(n, lay) is not lay]
            current.update(targets)
            reads.update(n for n, _, _ in conv)
            kind, payload = self._segments[si]
            if kind == "device":
                chain.append((si, conv, dict(current)))
                reads.update(_segment_reads(_segment_nodes(kind, payload)))
                continue
            if conv:
                chain.append((None, conv, dict(current)))
            close()
            sub = self._sub_executor(si)
            body, exit_layouts = sub._plan_steps(
                range(len(sub._segments)), current,
                f"{label}loop seg{si} ")
            if exit_layouts != current:
                raise RuntimeError(f"loop segment {si}: its body changes "
                                   f"layouts between iterations")
            steps.append(_Loop(si, body))
        close()
        return steps, current

    def _region_program(self, entry: ExecutableCacheEntry,
                        region) -> _RegionProgram:
        """The program of a device region at the current layouts, from the
        cache (built on a miss)."""
        key = ("region", region.index,
               tuple(self._state_layouts[n] for n in self._layout_keys))
        prog = entry.executables.get(key)
        if prog is None:
            steps, exit_layouts = self._plan_steps(
                region.segments, dict(self._state_layouts),
                f"region {region.index} ")
            prog = entry.executables[key] = _RegionProgram(steps,
                                                           exit_layouts)
            entry.builds += 1
            entry.pin(self.graph)
        elif key not in self._fetched:
            entry.hits += 1
        if key not in self._fetched:
            self._fetched.add(key)
            self.plan.region_graphs.setdefault(region.index,
                                               _count_graphs(prog.steps))
        return prog

    def _async_ctx(self, enabled: Optional[bool] = None) \
            -> Optional[_AsyncRun]:
        """A fresh dispatcher for one call when the async runtime applies
        (``enabled``, default ``async_regions``; ``regions=True``; a host
        region in the plan), else None: the call runs synchronously."""
        if enabled is None:
            enabled = self.async_regions
        if not (enabled and self.regions):
            return None
        if not any(r.kind == "host" for r in self.plan.regions):
            return None

        def storages():
            return {s for e in self._entries() for s in e.storages}

        return _AsyncRun(self.device, self.host_timeout, storages,
                         self.async_stats)

    def _run_regions(self, st: _CallState) -> None:
        """One pass over the regions: each device region's pieces and
        loops on the static buffers; host work between them, eagerly after
        the device is idle or, with a dispatcher (``st.ctx``), submitted
        to the host pool (barriers and host loops drain it first)."""
        entry = self._entry()
        ctx = st.ctx
        for region in self.plan.regions:
            if ctx is not None:
                ctx.check()
            if region.kind == "device":
                # before the region writes any buffer: a retry of a
                # donate=False call starts from the caller's tensors
                _fault_trip("executor.region",
                            detail=f"region{region.index}")
                prog = self._region_program(entry, region)
                for step in prog.steps:
                    step.run(self, entry, st)
                self._state_layouts.update(prog.exit_layouts)
                continue
            i = region.start
            payload = self._segments[i][1]
            self._apply_segment_layouts(st.state, i)
            if region.kind == "host":
                barrier = self._region_access[region.index][2]
                if ctx is not None and not barrier:
                    vals = self._resolve_args(
                        payload, st.state, self._state_layouts) \
                        if payload.args else []
                    ctx.submit(region.index, payload.fn, vals)
                    continue
                if ctx is not None:
                    ctx.drain(barrier=True)   # side effects keep order
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                _fault_trip("executor.host", detail=f"region{region.index}")
                if payload.fn is not None:
                    vals = self._resolve_args(
                        payload, st.state, self._state_layouts) \
                        if payload.args else []
                    payload.fn(*vals)
            else:   # host_loop: the body's regions, on the same call state
                if ctx is not None:
                    ctx.drain(barrier=True)   # the predicate reads state
                sub = self._sub_executor(i)
                before = sub.eager_relayouts

                def body():
                    st.ctx = sub._async_ctx(self.async_regions)
                    try:
                        with sub._layout_epoch():
                            sub._run_regions(st)
                            sub._restore_initial_layouts(st.state)
                        if st.ctx is not None:
                            st.ctx.drain()
                    except BaseException:
                        if st.ctx is not None:
                            st.ctx.abort()
                        raise
                    finally:
                        st.ctx = ctx

                _while(lambda: bool(payload.condition(st.state)), body)
                self.eager_relayouts += sub.eager_relayouts - before

    def _finish(self, st: _CallState) -> dict:
        """The state a call returns: under ``donate=True`` the live alias
        of each static buffer (the entry's returned state from now on);
        otherwise a clone of each buffer a piece wrote, and the value
        staged in for each buffer only read."""
        state = st.state
        entries = list(self._entries()) if self.donate else ()
        for k, v in state.items():
            if id(v) not in st.buffers:
                continue
            if self.donate:
                state[k] = next(e for e in entries
                                if id(v) in e.owners).alias(v)
            else:
                orig = None if k in st.written else st.origin.get(k)
                state[k] = _clone(v) if orig is None else orig
        return state

    # -- execution -----------------------------------------------------------
    def _call_segments(self, state: dict) -> dict:
        """One pass: per segment, the boundary relayouts, then its waves
        (device), its callback after the device is idle (host), or its
        body while the predicate holds (loop, host_loop)."""
        for i, (kind, payload) in enumerate(self._segments):
            state = self._apply_segment_layouts(state, i)
            if kind == "device":
                _fault_trip("executor.region", detail=f"segment{i}")
                with tile_scope(self._tile_config):
                    state = self._lower_levels(payload, state,
                                               dict(self._state_layouts))
            elif kind == "host":
                node: Node = payload
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                _fault_trip("executor.host", detail=f"segment{i}")
                if node.fn is not None:
                    vals = self._resolve_args(
                        node, state, self._state_layouts) \
                        if node.args else []
                    node.fn(*vals)
            else:   # loop / host_loop
                sub = self._sub_executor(i)
                before = sub.eager_relayouts

                def body():
                    nonlocal state
                    state = sub(state)

                _while(lambda: bool(payload.condition(state)), body)
                self.eager_relayouts += sub.eager_relayouts - before
        return state

    @contextmanager
    def _layout_epoch(self):
        """Incoming states are in the configured plan's initial layouts,
        and whatever happens inside (an exception, a ladder move
        included), the bookkeeping ends at them again."""
        self._state_layouts = dict(self._io_layouts)
        try:
            yield
        finally:
            self._state_layouts = dict(self._io_layouts)

    def __call__(self, state: dict) -> dict:
        """Execute the graph once; returns the new state dict."""
        return self.run(state, 1)

    def run(self, state: dict, steps: int) -> dict:
        """Execute the whole graph ``steps`` times (graphs are built once,
        executed many — paper §5.3).  Under ``regions=True`` a device-only
        graph replays its captured step ``steps`` times, copying in once
        and returning aliases of its buffers (``donate=True``) or clones
        (``donate=False``) once; every step count shares that one
        capture.  Pooled host callbacks have all run when
        it returns (the first failure re-raises here).  A failure is
        reported to the ladder (:meth:`record_failure`), a success counts
        as a clean pass."""
        if steps <= 0:
            return state
        with trace.span("ripple.call"), self._layout_epoch():
            ctx = self._async_ctx()
            try:
                if not self.regions:
                    state = dict(state)
                    for _ in range(steps):
                        state = self._call_segments(state)
                    out = self._restore_initial_layouts(dict(state))
                else:
                    with ExitStack() as held:
                        for entry in self._entries():
                            held.enter_context(entry.lock)
                        state, donated = self._take_in(state)
                        st = _CallState(state, ctx)
                        st.buffers |= donated
                        for _ in range(steps):
                            self._run_regions(st)
                        self._restore_initial_layouts(st.state)
                        if ctx is not None:
                            ctx.drain()
                        out = self._finish(st)
            except BaseException as exc:
                if ctx is not None:
                    ctx.abort()
                self.record_failure(exc)
                raise
            self._note_clean_pass()
            return out


def execute(graph: Graph, device: Any = None, steps: int = 1,
            mesh: Optional[Mesh] = None, **state_overrides) -> dict:
    """One-shot convenience: init state, run ``steps`` times, return the
    final state."""
    ex = Executor(graph, device, mesh=mesh)
    return ex.run(ex.init_state(**state_overrides), steps)
