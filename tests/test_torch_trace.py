"""The port's own spans (``repro_torch.core.trace``) on the CPU: they
record only under ``torch.profiler``, nest inside their parents within
one call, match the profiler's exported trace, count what the loops, the
pieces and the host callbacks did, keep one session at a time, and leave
every result bit for bit as it was."""

import json
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as port
from repro_torch import workloads
from repro_torch.core import (DistTensor, ExecutionKind, Executor, Graph,
                              trace)
from repro_torch.core import executor as executor_mod

N = 64


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    port.clear_executable_cache()
    monkeypatch.setattr(trace, "_REC", trace._Recorder())
    yield
    port.clear_executable_cache()


def _profiled(fn):
    """``fn()`` under a CPU profiler; returns its result and the
    profiler's exported events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _solve():
    """An eikonal solve at N: the executor, its input, its predicate."""
    g, _, conv = workloads.build_eikonal_graph(N, max_iters=4 * N)
    ex = Executor(g, device="cpu")
    c = torch.arange(N, dtype=torch.float64) + 0.5 - N / 2
    mask = (torch.hypot(c[:, None], c[None, :]) - N / 4).abs() <= 0.5
    phi = torch.where(mask, 0.0, torch.linspace(500, 1000, N * N,
                                                dtype=torch.float32
                                                ).reshape(N, N))
    return ex, ex.init_state(phi=phi, mask=mask), conv


def _within_parents(spans):
    """Every child lies inside its parent's interval, in its call."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is None:
            assert s.call == s.id, s
            continue
        up = by_id[s.parent]
        assert up.start <= s.start <= s.end <= up.end, (s, up)
        assert s.call == up.call, (s, up)


def test_without_a_profiler_a_run_records_nothing():
    ex, inputs, _ = _solve()
    ex.run(inputs, 1)
    s = trace.session()
    assert s.spans == [] and s.counters == {"dropped": 0}


def test_a_profiled_solve_records_its_spans(monkeypatch):
    ex, inputs, conv = _solve()
    ex.run(inputs, 1)                    # builds the pieces
    runs = []
    real = executor_mod._Piece.run

    def counted(self, *a):
        runs.append(self.label)
        return real(self, *a)

    monkeypatch.setattr(executor_mod._Piece, "run", counted)
    _, events = _profiled(lambda: ex.run(inputs, 1))
    s = trace.session()
    names = Counter(sp.name for sp in s.spans)
    assert conv.iterations > 5
    assert names == {"ripple.call": 1,
                     "ripple.predicate": conv.iterations + 1,
                     "ripple.iteration": conv.iterations,
                     "ripple.launch": len(runs),
                     # the CPU has no replay: each launch pads phi on
                     # the host
                     "ripple.halo": len(runs)}
    assert len(runs) == conv.iterations
    _within_parents(s.spans)
    launch = s.named("ripple.launch")
    assert all(sp.attrs["label"] == runs[0] for sp in launch)
    # the input is copied in before the first launch, then never again
    assert launch[0].attrs["staged_bytes"] > 0
    assert {sp.attrs["staged_bytes"] for sp in launch[1:]} == {0}
    # no timing events without a card, so no gaps
    assert not any("gap_us" in sp.attrs for sp in launch)
    marks = Counter(e.name for e in events if e.name.startswith("ripple."))
    assert marks == names


def test_the_exported_trace_holds_the_spans(tmp_path):
    ex, inputs, conv = _solve()
    ex.run(inputs, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.run(inputs, 1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("ripple.")]
    assert Counter(e["name"] for e in marks) == \
        Counter(sp.name for sp in trace.session().spans)
    call = next(e for e in marks if e["name"] == "ripple.call")
    for e in marks:
        assert call["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= call["ts"] + call["dur"]


def _loop_graph(kind: str) -> Graph:
    """Count x up to 4 in a loop; ``host_loop`` puts a host node in the
    body."""
    x = DistTensor("x", (4,))
    body = Graph(name=f"count_{kind}")
    body.split(lambda v: v + 1.0, x, writes=(0,))
    if kind == "host_loop":
        body.sync(lambda: None)
    body.conditional(lambda s: bool(s["x"][0] < 4.0))
    return Graph().emplace(body)


@pytest.mark.parametrize("kind,regions", [("loop", True),
                                          ("host_loop", True),
                                          ("loop", False)])
def test_every_while_loop_has_its_spans(kind, regions):
    ex = Executor(_loop_graph(kind), device="cpu", regions=regions)
    assert [k for k, _ in ex._segments] == [kind]
    ex.run(ex.init_state(), 1)
    out, _ = _profiled(lambda: ex.run(ex.init_state(), 1))
    assert torch.equal(out["x"], torch.full((4,), 4.0))
    s = trace.session()
    names = Counter(sp.name for sp in s.spans)
    assert (names["ripple.predicate"], names["ripple.iteration"]) == (5, 4)
    _within_parents(s.spans)
    assert len({sp.call for sp in s.spans}) == 1
    for it in s.named("ripple.iteration"):
        assert s.spans[0].call == it.call


def _slow_log_graph(seen: list) -> Graph:
    """A step that adds 1 to ``x``, then a slow host callback that logs
    it: the callbacks fall behind and fill the pipeline."""
    x = DistTensor("x", (8,))

    def log(v):
        time.sleep(0.002)
        seen.append(float(v[0]))

    g = Graph(name="slow_log")
    g.split(lambda v: v + 1.0, x, writes=(0,))
    g.then(log, exec_kind=ExecutionKind.Cpu, args=(x,))
    return g


def test_host_callbacks_carry_their_submit():
    seen = []
    ex = Executor(_slow_log_graph(seen), device="cpu")
    ex.run(ex.init_state(), 1)
    steps = 2 * executor_mod._AsyncRun.max_inflight
    _profiled(lambda: ex.run(ex.init_state(), steps))
    assert seen == [1.0] + [float(i) for i in range(1, steps + 1)]
    s = trace.session()
    _within_parents(s.spans)
    (call,) = s.named("ripple.call")
    submits = {sp.id: sp for sp in s.named("ripple.submit")}
    callbacks = s.named("ripple.callback")
    assert len(submits) == len(callbacks) == steps
    for cb in callbacks:
        sub = submits[cb.attrs["submit"]]
        assert cb.call == sub.call == call.id
        assert cb.parent == sub.parent
        assert cb.start >= sub.end
        assert cb.thread != sub.thread
    kinds = Counter(sp.attrs["kind"] for sp in s.named("ripple.wait"))
    assert set(kinds) == {"cap", "drain"} and kinds["drain"] == 1


def test_two_profiled_runs_do_not_add_up():
    ex, inputs, conv = _solve()
    ex.run(inputs, 1)
    _profiled(lambda: ex.run(inputs, 1))
    first = trace.session()
    _profiled(lambda: ex.run(inputs, 1))
    second = trace.session()
    assert first is not second
    assert len(first.spans) == len(second.spans) == 4 * conv.iterations + 2
    assert not {sp.call for sp in first.spans} & \
        {sp.call for sp in second.spans}
    # a run between two sessions that is not profiled ends the first
    with profile(activities=[ProfilerActivity.CPU]):
        ex.run(inputs, 1)
    ex.run(inputs, 1)
    _profiled(lambda: ex.run(inputs, 1))
    assert len({sp.call for sp in trace.session().spans}) == 1


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", 10)
    ex, inputs, conv = _solve()
    ex.run(inputs, 1)
    _profiled(lambda: ex.run(inputs, 1))
    s = trace.session()
    assert len(s.spans) == 10
    assert s.counters["dropped"] == 4 * conv.iterations + 2 - 10


def test_states_are_bit_for_bit_with_the_profiler_on():
    ex, inputs, conv = _solve()
    off = {k: v.clone() for k, v in ex.run(inputs, 1).items()}
    iters = conv.iterations
    on, _ = _profiled(lambda: ex.run(inputs, 1))
    assert conv.iterations == iters
    assert set(on) == set(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k
    seen_off, seen_on = [], []
    ex = Executor(_slow_log_graph(seen_off), device="cpu")
    a = ex.run(ex.init_state(), 5)["x"].clone()
    ex = Executor(_slow_log_graph(seen_on), device="cpu")
    b, _ = _profiled(lambda: ex.run(ex.init_state(), 5))
    assert torch.equal(a, b["x"]) and seen_off == seen_on


class _Stream:
    """A stand-in for a CUDA stream: ``now`` is the device's clock (ms)
    at which the next event is reached, ``reached`` how far the device
    has got."""

    def __init__(self):
        self.now = 0.0
        self.reached = float("inf")


class _Event:
    """A stand-in for a timing event on a :class:`_Stream`."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.stream = self.t = None

    def record(self, stream):
        self.stream, self.t = stream, stream.now

    def query(self):
        return self.t <= self.stream.reached

    def synchronize(self):
        self.stream.reached = max(self.stream.reached, self.t)

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return end.t - self.t


class _Graph:
    """A stand-in for a captured graph: a replay moves the stream's clock
    to where the launch's work ends."""

    def __init__(self, stream):
        self.stream = stream
        self.ends = None

    def replay(self):
        self.stream.now = self.ends


@pytest.mark.parametrize("reached", [float("inf"), -1.0],
                         ids=["at_once", "at_read"])
def test_launch_gaps_of_timed_pairs(monkeypatch, reached):
    """One launch in ``EVERY`` is timed: its ``gap_us`` is the device time
    from the previous launch's ``done`` to its ``go``, if both are of one
    call.  Events whose gaps are known go back to the pool as the device
    passes them, or when the session is read."""
    monkeypatch.setattr(trace.torch.cuda, "Event", _Event)
    monkeypatch.setattr(_Event, "made", 0)
    monkeypatch.setattr(trace, "EVERY", 2)
    stream = _Stream()
    stream.reached = reached
    monkeypatch.setattr(trace.torch.cuda, "current_stream",
                        lambda device: stream)
    graph = _Graph(stream)
    # (call, go, done) in device ms; with EVERY = 2 launches 2, 4 and 6
    # are timed, 4 against a launch of another call
    plan = [(0, 0.0, 1.0), (0, 1.5, 2.0), (0, 2.004, 3.0),
            (1, 3.5, 4.0), (1, 4.25, 5.0), (1, 5.25, 6.0)]

    def run():
        for c in (0, 1):
            with trace.span("ripple.call"):
                for call, go, done in plan:
                    if call == c:
                        with trace.span("ripple.launch") as sp:
                            stream.now, graph.ends = go, done
                            sp.replay(graph, "cuda")

    _profiled(run)
    launches = sorted(trace.session().named("ripple.launch"),
                      key=lambda s: s.start)
    gaps = [sp.attrs.get("gap_us") for sp in launches]
    assert gaps == [None, pytest.approx(500.0), None, None, None,
                    pytest.approx(250.0)]
    assert all(sp.go is None and sp.done is None for sp in launches[:4])
    made = _Event.made
    assert made == (2 if reached > 0 else 4)
    _profiled(run)
    assert len(trace.session().named("ripple.launch")) == len(plan)
    assert _Event.made == made          # the second session reuses them
