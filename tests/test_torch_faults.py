"""Fault sites, the hung-callback watchdog and the degradation ladder of
the port's executor, on the CPU.

The executor cases of the JAX package's ``tests/test_faults.py`` keep their
names: the chaos matrix (region error, host error, region delay x async,
sync x dag, sequential schedule, here also x ``regions``) recovering bit
for bit under the shared ``RetryPolicy`` with a clean pass after, the
dispatch fault in async mode, both watchdog cases, the ladder demoting
and promoting, and a deterministic fault that moves nothing.  The port's
own cases hold the ladder's moves and the ``FaultPlan`` report against
the JAX executor's for the same plan, and check that a level visited
before captures nothing and that level 3 sets tuned layouts aside and
re-promotion restores them."""

import time

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch.core import (DistTensor, ExecutionKind, Executor, Graph,
                              HostTimeoutError, Layout, RecordSpec)
from repro_torch.runtime import TransientError
from repro_torch.runtime.faults import (Fault, FaultPlan,
                                        InjectedDeterministicFault,
                                        RetryPolicy, fault_scope)

# backoff-free policy: chaos tests retry at once and deterministically
_NOSLEEP = RetryPolicy(max_retries=6, base_delay=0.0, sleep=lambda d: None)


@pytest.fixture(autouse=True)
def _fresh_cache():
    port.clear_executable_cache()
    yield
    port.clear_executable_cache()


class _Sink:
    """A host callback that keeps what it read.  An object, so the plan
    signature keys it by identity: a closure over a list is keyed by the
    list's contents, and every plan a ladder move rebuilds would miss the
    executable cache."""

    def __init__(self):
        self.values = []

    def __call__(self, x):
        self.values.append(float(np.asarray(x)[0]))


def _chain_graph(name="chaos-chain", pkg=port):
    """device split -> host callback -> device split (the async runtime's
    shape: device regions AND a pooled host node to fault)."""
    a = pkg.DistTensor("a", (8,))
    g = pkg.Graph(name=name)
    g.split(lambda x: x + 1.0, a, writes=(0,))
    g.then(_Sink(), exec_kind=pkg.ExecutionKind.Cpu, args=(a,))
    g.then_split(lambda x: x * 2.0, a, writes=(0,))
    return g


def _ex(g, **kw):
    kw.setdefault("regions", True)
    return Executor(g, device="cpu", **kw)


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# -- the chaos matrix: kind x dispatch mode x schedule x regions ---------------

_KINDS = [
    ("region-error", lambda: Fault("executor.region", nth=0)),
    ("host-error", lambda: Fault("executor.host", nth=0)),
    ("region-delay", lambda: Fault("executor.region", nth=0,
                                   kind="delay", delay_s=0.01)),
]


@pytest.mark.parametrize("regions", [True, False],
                         ids=["regions", "eager"])
@pytest.mark.parametrize("schedule", ["dag", "sequential"])
@pytest.mark.parametrize("async_regions", [True, False],
                         ids=["async", "sync"])
@pytest.mark.parametrize("kind,mk", _KINDS, ids=[k for k, _ in _KINDS])
def test_chaos_matrix_bitwise_recovery(kind, mk, async_regions, schedule,
                                       regions):
    """Every fault kind, in every dispatch mode and schedule, recovers to
    a bitwise-identical state under the shared RetryPolicy — and the
    executor stays usable afterwards."""
    g = _chain_graph()
    reference = _ex(g, donate=False, schedule=schedule,
                    async_regions=async_regions, regions=regions)
    s0 = reference.init_state()
    want = reference(dict(s0))

    ex = _ex(g, donate=False, schedule=schedule,
             async_regions=async_regions, regions=regions)
    plan = FaultPlan([mk()])
    with fault_scope(plan):
        got = _NOSLEEP.call(lambda: ex(dict(s0)))
    assert plan.exhausted(), plan.report()
    _assert_state_equal(got, want)
    # the recovered executor completes a later clean pass
    _assert_state_equal(ex(dict(s0)), want)
    detail = plan.fired[0][1]
    assert detail.startswith("region" if regions else "segment")


def test_dispatch_fault_recovers_in_async_mode():
    """A fault at the host pool's submission (async dispatcher only) is
    transient: the pass aborts cleanly and the retry is bitwise-equal."""
    g = _chain_graph()
    ex = _ex(g, donate=False, async_regions=True)
    s0 = ex.init_state()
    want = ex(dict(s0))
    plan = FaultPlan([Fault("executor.dispatch", nth=0)])
    with fault_scope(plan):
        got = _NOSLEEP.call(lambda: ex(dict(s0)))
    assert plan.exhausted(), plan.report()
    assert plan.fired[0][1] == "region1"
    _assert_state_equal(got, want)


# -- hung-callback watchdog ---------------------------------------------------

def test_watchdog_trips_hung_callback_without_deadlock():
    """A host callback that hangs past ``host_timeout`` raises
    HostTimeoutError (transient) instead of deadlocking — and the
    executor (and the shared host pool) stay usable afterwards."""
    g = _chain_graph()
    ex = _ex(g, donate=False, host_timeout=0.3, degrade=False)
    s0 = ex.init_state()
    want = ex(dict(s0))

    plan = FaultPlan([Fault("executor.host", nth=0,
                            kind="delay", delay_s=1.5)])
    t0 = time.perf_counter()
    with fault_scope(plan):
        with pytest.raises(HostTimeoutError) as info:
            ex(dict(s0))
    assert time.perf_counter() - t0 < 1.4, "watchdog waited out the hang"
    assert isinstance(HostTimeoutError("x"), TransientError)
    assert info.value.site == "executor.host"
    # the hung worker still holds its pool slot, but the executor itself
    # completes later clean passes
    _assert_state_equal(ex(dict(s0)), want)


def test_watchdog_cancels_successor_callbacks():
    """When a host callback hangs, its successors on the chain of host
    tasks are cancelled — they never run their side effects."""
    seen = []
    a = DistTensor("a", (8,))
    g = Graph(name="chaos-two-hosts")
    g.split(lambda x: x + 1.0, a, writes=(0,))
    g.then(lambda x: seen.append("first"),
           exec_kind=ExecutionKind.Cpu, args=(a,))
    g.then(lambda x: seen.append("second"),
           exec_kind=ExecutionKind.Cpu, args=(a,))
    ex = _ex(g, donate=False, host_timeout=0.25, degrade=False)
    s0 = ex.init_state()
    ex(dict(s0))
    assert seen == ["first", "second"]

    base = len(seen)
    plan = FaultPlan([Fault("executor.host", nth=0,
                            kind="delay", delay_s=1.0)])
    with fault_scope(plan):
        with pytest.raises(HostTimeoutError):
            ex(dict(s0))
    time.sleep(1.2)   # let the hung worker finish its injected sleep
    assert "second" not in seen[base:], seen[base:]


# -- the graceful-degradation ladder ------------------------------------------

@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("regions", [True, False], ids=["regions", "eager"])
def test_ladder_demotes_then_repromotes(regions, donate):
    """Repeated transient failures at one site walk the executor down
    the ladder one level per ``demote_after`` failures; ``promote_after``
    consecutive clean passes walk it back up.  Results stay bitwise-
    identical at every level, and every transition is introspectable in
    ``plan.degradations`` / ``plan.describe()``."""
    g = _chain_graph()
    ex = _ex(g, donate=donate, demote_after=1, promote_after=2,
             regions=regions)
    s0 = ex.init_state()
    want = {k: v.clone() for k, v in ex(dict(s0)).items()}

    plan = FaultPlan([Fault("executor.region", nth=0, times=2)])
    with fault_scope(plan):
        got = _NOSLEEP.call(lambda: ex(dict(s0)))
    assert plan.exhausted(), plan.report()
    _assert_state_equal(got, want)

    # two failures at executor.region with demote_after=1:
    # async_regions -> sync -> sequential
    assert ex.ladder_level == 2
    assert not ex.async_regions and ex.schedule == "sequential"
    evs = ex.plan.degradations
    assert [(e.action, e.frm, e.to) for e in evs] == [
        ("demote", "async_regions", "sync"),
        ("demote", "sync", "sequential")]
    assert all(e.site == "executor.region" for e in evs)
    text = ex.plan.describe()
    assert "ladder" in text and "demote" in text

    # re-promotion: promote_after=2 clean passes climb one level each
    _assert_state_equal(ex(dict(s0)), want)   # (recovery pass was clean #1)
    assert ex.ladder_level == 1
    for _ in range(2):
        _assert_state_equal(ex(dict(s0)), want)
    assert ex.ladder_level == 0
    assert ex.async_regions and ex.schedule == "dag"
    actions = [e.action for e in ex.plan.degradations]
    assert actions == ["demote", "demote", "promote", "promote"]


def test_deterministic_fault_bypasses_retry_and_ladder():
    """``transient=False`` faults raise InjectedDeterministicFault:
    RetryPolicy re-raises immediately and the ladder does not move."""
    g = _chain_graph()
    ex = _ex(g, donate=False, demote_after=1)
    s0 = ex.init_state()
    ex(dict(s0))
    plan = FaultPlan([Fault("executor.region", nth=0, transient=False)])
    calls = []
    with fault_scope(plan):
        with pytest.raises(InjectedDeterministicFault):
            _NOSLEEP.call(lambda: (calls.append(1), ex(dict(s0))))
    assert len(calls) == 1          # no retry
    assert ex.ladder_level == 0
    assert ex.plan.degradations == []


@pytest.mark.parametrize("donate", [False, True])
def test_a_level_visited_before_captures_nothing(donate):
    """A move rebuilds the plan under another signature; the executor
    keeps its lease on every entry it ran, so promotion back to the dag
    plan finds its pieces (zero builds), and under ``donate=True`` a
    state returned in one level's buffers is copied into another's."""
    g = _chain_graph()
    chained = _ex(g, donate=False)
    s0 = chained.init_state()
    wants = [dict(s0)]
    for _ in range(4):
        wants.append(chained(dict(wants[-1])))
    ex = _ex(g, donate=donate, demote_after=1, promote_after=2)
    ex(dict(s0))
    built = port.executable_cache_stats()["trace_events"]
    dag_sig = ex.plan.signature
    with fault_scope(FaultPlan([Fault("executor.region", nth=0,
                                      times=2)])):
        state = _NOSLEEP.call(lambda: ex(dict(s0)))
    _assert_state_equal(state, wants[1])
    assert ex.schedule == "sequential" and ex.plan.signature != dag_sig
    seq_built = port.executable_cache_stats()["trace_events"] - built
    assert seq_built > 0
    for n, level in ((2, 1), (3, 1), (4, 0)):
        state = ex(state)           # each returned state feeds the next
        _assert_state_equal(state, wants[n])
        assert ex.ladder_level == level
    assert ex.plan.signature == dag_sig
    assert port.executable_cache_stats()["trace_events"] == built + seq_built


def test_level_three_sets_tuned_layouts_aside_and_restores_them(monkeypatch):
    """Level 3 ("heuristic") drops the tuned layouts and tiles for the
    user's own overrides; promotion to level 2 restores them; the state
    is the same bits at every level."""
    from repro_torch.tuning import search

    spec = RecordSpec.create("x", "y")
    r = DistTensor("r", (32,), spec=spec, layout=Layout.AOS)
    seen = []
    g = Graph(name="tuned-ladder")
    g.split(lambda v: v.set_field("y", v.field("x") + 2.0 * v.field("y")),
            r, writes=(0,))
    g.then(lambda v: seen.append(float(v.field("y")[0])),
           exec_kind=ExecutionKind.Cpu, args=(r,))
    g.then_split(lambda v: v.set_field("x", v.field("x") - 1.0), r,
                 writes=(0,))

    def tuned(executor, mode, budget=None):
        return search.TuningDecision(source="measured", cache_key="k",
                                     layouts={"r": Layout.SOA},
                                     baseline_ms=1.0, tuned_ms=0.5)

    monkeypatch.setattr(search, "resolve_tuning", tuned)
    ex = _ex(g, tune="load", donate=False, demote_after=1, promote_after=2)
    assert ex.plan.initial["r"] is Layout.SOA
    s0 = ex.init_state()
    want = ex(dict(s0))
    with fault_scope(FaultPlan([Fault("executor.region", nth=0,
                                      times=3)])):
        got = _NOSLEEP.call(lambda: ex(dict(s0)))
    assert ex.ladder_level == 3
    assert ex._layout_overrides == {} and ex.plan.initial["r"] is Layout.AOS
    _assert_state_equal(got, want)
    # the caller's state stays in the tuned plan's layouts at every level
    assert got["r"].shape == want["r"].shape
    _assert_state_equal(ex(dict(s0)), want)   # clean #2: promote
    assert ex.ladder_level == 2
    assert ex._layout_overrides == {"r": Layout.SOA}
    assert ex.plan.initial["r"] is Layout.SOA
    _assert_state_equal(ex(dict(s0)), want)
    assert ex.plan.tuning is not None
    assert [(e.action, e.frm, e.to) for e in ex.plan.degradations] == [
        ("demote", "async_regions", "sync"),
        ("demote", "sync", "sequential"),
        ("demote", "sequential", "heuristic"),
        ("promote", "heuristic", "sequential")]


# -- against the JAX executor ------------------------------------------------------

def test_ladder_and_report_equal_the_reference():
    """One FaultPlan, demote_after=1 and promote_after=2, through both
    packages: the same (action, from, to, site) moves, and the same
    visited and fired sites in the plans' reports."""
    from repro.runtime import faults as ref_faults
    from repro_torch.runtime import faults as port_faults

    runs = {}
    for name, pkg, faults in (("ref", ref, ref_faults),
                              ("port", port, port_faults)):
        g = _chain_graph(pkg=pkg)
        if pkg is ref:
            ex = ref.Executor(g, donate=False, demote_after=1,
                              promote_after=2)
        else:
            ex = _ex(g, donate=False, demote_after=1, promote_after=2)
        s0 = ex.init_state()
        ex(dict(s0))
        retry = faults.RetryPolicy(max_retries=6, base_delay=0.0,
                                   sleep=lambda d: None)
        plan = faults.FaultPlan([
            faults.Fault("executor.region", nth=0, times=2),
            faults.Fault("executor.host", nth=3)])
        with faults.fault_scope(plan):
            for _ in range(7):
                retry.call(lambda: ex(dict(s0)))
        runs[name] = ([(e.action, e.frm, e.to, e.site)
                       for e in ex.plan.degradations], plan.report(),
                      ex.ladder_level)
    assert runs["port"] == runs["ref"]
    moves, report, _ = runs["port"]
    assert [m[0] for m in moves].count("demote") >= 2
    assert "FIRED error at executor.region[region0]" in report
