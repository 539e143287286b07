"""Async regions in the port (``Executor(regions=True, async_regions=True)``)
on the CPU.

The cases ported from the JAX package's ``tests/test_async_runtime.py``
keep their names and run under ``regions=True`` (the only path where the
async runtime applies): callbacks on the ``ripple-host`` pool, program
order, each step's values under both ``donate`` settings (the port clones
a host argument that lies in a static buffer whatever ``donate`` says),
failures and cancellation, the flag out of the plan signature, async
equal to sync bit for bit on seeded random graphs in AoS, SoA and AoSoA,
and the ``StepStats`` contract.  The port's own cases hold the callbacks'
values and the final states against the JAX executor's on the same
inputs: bit for bit on graphs whose arithmetic the two packages do alike,
within float32 1e-5 on the random graphs (XLA fuses ``c * x + y``), and on
the particle step with a host diagnostic the logged ``(t, vmax)``
bit for bit and the pushed records within float32 1e-5 (the particle
kernel's plain version and the Pallas interpreter round ``x + v dt`` one
ulp apart)."""

import random
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch import workloads
from repro_torch.core import (Boundary, DistTensor, ExecutionKind, Executor,
                              Graph, Layout, MaxReducer, RecordArray,
                              RecordSpec, SumReducer,
                              concurrent_padded_access,
                              make_reduction_result)
from repro_torch.interop import state_from_reference
from repro_torch.runtime.supervisor import StepStats

LAYOUTS = (Layout.AOS, Layout.SOA, Layout.AOSOA)
F32_TOL = 1e-5
N_FLAT = 4096


@pytest.fixture(autouse=True)
def _fresh_cache():
    port.clear_executable_cache()
    yield
    port.clear_executable_cache()


def _ex(g, **kw):
    kw.setdefault("regions", True)
    return Executor(g, device="cpu", **kw)


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _cb_chain_graph(seen, tags=("a", "b"), pkg=port):
    """device(write a) -> host(read a) -> device(write b) -> host(read b):
    the minimal interleaved chain the dispatcher must keep in order."""
    a = pkg.DistTensor("a", (8,))
    b = pkg.DistTensor("b", (8,))
    g = pkg.Graph(name="cbchain")
    g.split(lambda x: x + 1.0, a, writes=(0,))
    g.then((lambda t: lambda x: seen.append((t, float(np.asarray(x)[0]))))(
        tags[0]), exec_kind=pkg.ExecutionKind.Cpu, args=(a,))
    g.then_split(lambda x: x + 2.0, b, writes=(0,))
    g.then((lambda t: lambda x: seen.append((t, float(np.asarray(x)[0]))))(
        tags[1]), exec_kind=pkg.ExecutionKind.Cpu, args=(b,))
    return g


# -- a seeded random graph of the port's, as tests/_graph_gen.py builds the
# JAX package's: the same draws give the same graph in both packages ---------

SPEC = RecordSpec.create("x", "y")
NX, NY = 16, 12
N_SCALARS = 3


def _host_read(x):
    """A real host read without side effects: it can change no value,
    only the scheduling."""
    np.asarray(x.data if isinstance(x, RecordArray) else x)


def _stencil(s, _d):
    return (s[2:, 1:-1] + s[:-2, 1:-1] + s[1:-1, 2:] + s[1:-1, :-2]
            - 3.5 * s[1:-1, 1:-1])


def build_random_graph(seed: int, layout: Layout):
    """``_graph_gen.build_random_graph(seed, layout, host_callbacks=True)``
    in the port: returns ``(graph, overrides(), state keys)``."""
    rng = random.Random(seed)
    scalars = [DistTensor(f"t{i}", (NX, NY), halo=(1, 1),
                          boundary=Boundary.TRANSMISSIVE)
               for i in range(N_SCALARS)]
    rec = DistTensor("r", (NX, NY), spec=SPEC, layout=layout)
    results = []
    g = Graph(name=f"rand{seed}")
    for li in range(rng.randint(2, 4)):
        if li:
            g._new_level()
        if rng.random() < 0.5:
            g.then(_host_read, exec_kind=ExecutionKind.Cpu,
                   args=(scalars[rng.randrange(N_SCALARS)],))
        for _ in range(rng.randint(1, 3)):
            kind = rng.choice(
                ["saxpy", "stencil", "reduce", "rec", "result_add"])
            if kind == "saxpy":
                a, b = rng.sample(range(N_SCALARS), 2)
                c = round(rng.uniform(0.5, 2.0), 3)
                g.split((lambda cc: lambda xs, ys: cc * xs + ys)(c),
                        scalars[a], scalars[b])
            elif kind == "stencil":
                a, b = rng.sample(range(N_SCALARS), 2)
                g.split(_stencil, concurrent_padded_access(scalars[a]),
                        scalars[b])
            elif kind == "reduce":
                i = rng.randrange(N_SCALARS)
                res = make_reduction_result(f"res{len(results)}_{seed}")
                results.append(res)
                g.reduce(scalars[i], res,
                         rng.choice([SumReducer(), MaxReducer()]))
            elif kind == "rec":
                c = round(rng.uniform(0.5, 2.0), 3)
                g.split((lambda cc: lambda r: r.set_field(
                    "y", cc * r.field("x") + r.field("y")))(c),
                    rec, writes=(0,))
            elif results:
                res = rng.choice(results)
                i = rng.randrange(N_SCALARS)
                g.split(lambda xs, rv: xs + 0.125 * rv, scalars[i], res)

    def overrides():
        out = {f"t{i}": torch.from_numpy(
            np.linspace(0.0, 1.0 + i, NX * NY, dtype=np.float32)
            .reshape(NX, NY)) for i in range(N_SCALARS)}
        out["r"] = RecordArray.from_fields(SPEC, {
            "x": torch.from_numpy(np.linspace(-1.0, 1.0, NX * NY,
                                              dtype=np.float32)
                                  .reshape(NX, NY)),
            "y": torch.full((NX, NY), 0.25)}, layout)
        return out

    keys = sorted(g.all_tensors()) + [r.name for r in results]
    return g, overrides, keys


# -- dispatcher behaviour ----------------------------------------------------------

def test_async_host_callbacks_run_on_pool_thread():
    threads = []
    a = DistTensor("a", (8,))
    g = Graph(name="thr")
    g.split(lambda x: x + 1.0, a, writes=(0,))
    g.then(lambda x: threads.append(threading.current_thread().name),
           exec_kind=ExecutionKind.Cpu, args=(a,))
    ex = _ex(g, donate=False, async_regions=True)
    ex(ex.init_state())
    assert threads and all(t.startswith("ripple-host") for t in threads)


def test_sync_escape_hatch_runs_on_main_thread():
    threads = []
    a = DistTensor("a", (8,))
    g = Graph(name="thr2")
    g.split(lambda x: x + 1.0, a, writes=(0,))
    g.then(lambda x: threads.append(threading.current_thread().name),
           exec_kind=ExecutionKind.Cpu, args=(a,))
    ex = _ex(g, donate=False, async_regions=False)
    ex(ex.init_state())
    assert threads == ["MainThread"]


@pytest.mark.parametrize("regions", [False, True])
def test_default_is_async_and_applies_only_under_regions(regions):
    """``async_regions`` defaults to True; the eager path
    (``regions=False``) runs every callback on the calling thread."""
    threads = []
    a = DistTensor("a", (8,))
    g = Graph(name="thr3")
    g.split(lambda x: x + 1.0, a, writes=(0,))
    g.then(lambda x: threads.append(threading.current_thread().name),
           exec_kind=ExecutionKind.Cpu, args=(a,))
    ex = _ex(g, regions=regions)
    assert ex.async_regions
    ex.run(ex.init_state(), 2)
    on_pool = [t.startswith("ripple-host") for t in threads]
    assert on_pool == [regions] * 2


def test_async_host_callbacks_preserve_program_order():
    """Side-effect order is part of the contract: pooled callbacks are
    chained, so two data-independent callbacks still fire in program
    order, across repeated steps."""
    seen = []
    g = _cb_chain_graph(seen)
    ex = _ex(g, donate=False, async_regions=True)
    ex.run(ex.init_state(), 3)
    assert seen == [("a", 1.0), ("b", 2.0), ("a", 2.0), ("b", 4.0),
                    ("a", 3.0), ("b", 6.0)]


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("mode", [False, True], ids=["sync", "async"])
def test_async_values_match_sync_per_step(mode, donate):
    """The callback must observe the value at its program point of the
    CURRENT step even while later steps are already dispatched; in the
    port the next step's pieces write the same static buffer in place
    under either ``donate``."""
    x = DistTensor("x", (8,))
    seen = []
    g = Graph(name="vals")
    g.split(lambda v: v + 1.0, x, writes=(0,))
    g.then(lambda v: seen.append(float(v[0])),
           exec_kind=ExecutionKind.Cpu, args=(x,))
    g.then_split(lambda v: v * 2.0, x, writes=(0,))
    ex = _ex(g, donate=donate, async_regions=mode)
    st = ex.run(ex.init_state(), 3)
    assert seen == [1.0, 3.0, 7.0]
    assert torch.equal(st["x"], torch.full((8,), 14.0))


@pytest.mark.parametrize("donate", [False, True])
def test_async_donation_snapshots_host_args(donate):
    """The next region's graph overwrites the argument's static buffer in
    place: the dispatcher clones host args at submit time, so an
    in-flight callback reads the value from before the overwrite.  The
    first callback holds until the third step's first region ran (on the
    CPU a piece runs its nodes on every call)."""
    x = DistTensor("x", (1 << 16,))
    seen = []
    dispatched = []
    third = threading.Event()

    def bump(v):
        dispatched.append(1)
        if len(dispatched) >= 3:
            third.set()
        return v + 1.0

    def slow_read(v):
        assert third.wait(timeout=10)
        seen.append(float(v[0]))

    g = Graph(name="donated")
    g.split(bump, x, writes=(0,))
    g.then(slow_read, exec_kind=ExecutionKind.Cpu, args=(x,))
    g.then_split(lambda v: v * 2.0, x, writes=(0,))
    ex = _ex(g, donate=donate, async_regions=True)
    ex.run(ex.init_state(), 4)
    assert seen == [1.0, 3.0, 7.0, 15.0]
    # every callback's argument was a static buffer: 4 clones of 256 KiB
    assert ex.async_stats["callbacks"] == 4
    assert ex.async_stats["snapshot_bytes"] == 4 * 4 * (1 << 16)
    assert ex.async_stats["peak_inflight"] >= 2


def test_args_outside_the_static_buffers_are_not_cloned():
    """A host argument that no piece writes (the caller's tensor before
    the first piece stages it) is passed as it is."""
    x = DistTensor("x", (16,))
    y = DistTensor("y", (16,))
    seen = []
    g = Graph(name="noclone")
    g.then(lambda v: seen.append(float(v[0])), exec_kind=ExecutionKind.Cpu,
           args=(y,))
    g.then_split(lambda v: v + 1.0, x, writes=(0,))
    ex = _ex(g, async_regions=True)
    y0 = torch.full((16,), 5.0)
    ex.run(ex.init_state(y=y0), 3)
    assert seen == [5.0] * 3
    assert ex.async_stats["snapshot_bytes"] == 0


def test_barrier_host_region_drains_and_runs_on_the_caller():
    """A callback without tensor args is a barrier: the pool is drained
    (the pooled callback sleeps, so it is still running when the barrier
    is reached) and the callback runs on the calling thread, in program
    order with the pooled ones."""
    seen = []

    def pooled(x):
        time.sleep(0.05)
        seen.append(("pooled", threading.current_thread().name
                     .startswith("ripple-host")))

    a = DistTensor("a", (8,))
    g = Graph(name="barrier")
    g.split(lambda x: x + 1.0, a, writes=(0,))
    g.then(pooled, exec_kind=ExecutionKind.Cpu, args=(a,))
    g.then(lambda: seen.append(("barrier", threading.current_thread().name)),
           exec_kind=ExecutionKind.Cpu)
    g.then_split(lambda x: x * 2.0, a, writes=(0,))
    ex = _ex(g, async_regions=True)
    ex.run(ex.init_state(), 2)
    assert seen == [("pooled", True), ("barrier", "MainThread")] * 2
    assert ex.async_stats["barrier_drains"] == 2


@pytest.mark.parametrize("donate", [False, True])
def test_host_loop_callbacks_run_async_with_their_iteration(donate):
    """A ``host_loop`` body's callbacks go to the pool too, each reading
    its own iteration's value; the loop's predicate reads the state after
    the enclosing callbacks drained."""
    x = DistTensor("x", (8,))
    seen = []
    loop = Graph(name="countdown")
    loop.split(lambda v: v - 1.0, x, writes=(0,))
    loop.then(lambda v: seen.append((threading.current_thread().name
                                     .startswith("ripple-host"),
                                     float(v[0]))),
              exec_kind=ExecutionKind.Cpu, args=(x,))
    loop.conditional(lambda s: s["x"][0] > 0.0)
    g = Graph(name="hl")
    g.split(lambda v: torch.full_like(v, 3.0), x, writes=(0,))
    g.then(loop)
    ex = _ex(g, donate=donate)
    st = ex.run(ex.init_state(), 2)
    assert seen == [(True, 2.0), (True, 1.0), (True, 0.0)] * 2
    assert torch.equal(st["x"], torch.zeros(8))


def test_async_callback_exception_propagates_and_cancels():
    """A failing callback surfaces its ORIGINAL exception from the run,
    later chained callbacks are cancelled (nothing after a failure may
    fire), and nothing deadlocks."""
    a = DistTensor("a", (8,))
    seen = []

    def boom(x):
        raise ValueError("callback failed")

    g = Graph(name="boom")
    g.split(lambda x: x + 1.0, a, writes=(0,))
    g.then(lambda x: seen.append("before"), exec_kind=ExecutionKind.Cpu,
           args=(a,))
    g.then(boom, exec_kind=ExecutionKind.Cpu, args=(a,))
    g.then(lambda x: seen.append("after"), exec_kind=ExecutionKind.Cpu,
           args=(a,))
    ex = _ex(g, donate=False, async_regions=True)
    with pytest.raises(ValueError, match="callback failed"):
        ex(ex.init_state())
    assert seen == ["before"]


def test_async_executor_usable_after_callback_failure():
    """The pool is process-wide: one failed call must not poison the
    executor (or the pool) for later calls."""
    a = DistTensor("a", (8,))
    fail = [True]
    ran = []

    def maybe_boom(x):
        if fail[0]:
            raise RuntimeError("transient")
        ran.append(float(x[0]))

    g = Graph(name="recover")
    g.split(lambda x: x + 1.0, a, writes=(0,))
    g.then(maybe_boom, exec_kind=ExecutionKind.Cpu, args=(a,))
    ex = _ex(g, donate=False, async_regions=True)
    with pytest.raises(RuntimeError, match="transient"):
        ex(ex.init_state())
    fail[0] = False
    st = ex(ex.init_state())
    assert ran == [1.0]
    assert torch.equal(st["a"], torch.full((8,), 1.0))


def test_async_flag_not_in_plan_signature():
    """Both modes run the SAME cached programs: the flag must not fork
    the process-wide executable cache."""
    seen = []
    g = _cb_chain_graph(seen)
    ex_a = _ex(g, donate=False, async_regions=True)
    ex_s = _ex(g, donate=False, async_regions=False)
    assert ex_a.plan.signature == ex_s.plan.signature
    ex_a(ex_a.init_state())
    built = port.executable_cache_stats()["trace_events"]
    ex_s(ex_s.init_state())
    assert port.executable_cache_stats()["trace_events"] == built


def test_executors_on_threads_share_the_pool():
    """Eight threads, each with its own executor, run the chain graph at
    once through the one process-wide pool, with the interpreter switching
    threads every 10 us: every callback log stays in program order and
    every state equals the synchronous run's."""
    import sys

    want_seen = []
    sync = _ex(_cb_chain_graph(want_seen), async_regions=False)
    want = sync.run(sync.init_state(), 6)
    results = {}

    def worker(i):
        seen = []
        ex = _ex(_cb_chain_graph(seen))
        results[i] = (ex.run(ex.init_state(), 6), seen)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(8))
    for state, seen in results.values():
        assert seen == want_seen
        _equal(state, want)


# -- async == sync, bit for bit ------------------------------------------------------

@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[lay.name for lay in LAYOUTS])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5])
def test_prop_async_equals_sync(seed, layout, donate):
    """Identical final state bit for bit between the event-driven
    dispatcher and the synchronous path, on random graphs WITH host
    callbacks, across layouts and donation modes, and equal to the eager
    per-segment path."""
    g, overrides, keys = build_random_graph(seed, layout)
    eager = Executor(g, device="cpu", regions=False)
    want = eager.run(eager.init_state(**overrides()), 2)
    outs = {}
    for mode in (True, False):
        ex = _ex(g, donate=donate, async_regions=mode)
        outs[mode] = ex.run(ex.init_state(**overrides()), 2)
    for k in keys:
        assert torch.equal(outs[True][k], outs[False][k]), (seed, k)
        assert torch.equal(outs[True][k], want[k]), (seed, k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5])
def test_random_graphs_equal_the_reference_async_runtime(seed):
    """The same seed builds the same graph in both packages; the port's
    async region run equals the JAX executor's (async_regions=True,
    regions=True) within float32 1e-5: XLA on the CPU contracts
    ``c * x + y`` into one fused multiply-add, PyTorch rounds twice."""
    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _graph_gen import build_random_graph as ref_random_graph

    rg, roverrides, keys = ref_random_graph(seed, ref.Layout.SOA,
                                            host_callbacks=True)
    rex = ref.Executor(rg, donate=False)
    want = rex.run(rex.init_state(**roverrides()), 2)
    g, overrides, pkeys = build_random_graph(seed, Layout.SOA)
    assert pkeys == keys
    ex = _ex(g)
    got = ex.run(ex.init_state(**overrides()), 2)
    for k in keys:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=k)


# -- against the JAX executor ------------------------------------------------------

@pytest.mark.parametrize("donate", [False, True])
def test_callbacks_and_state_equal_the_reference(donate):
    """The chain graph under both packages' async runtimes: the callbacks
    observe the same values in the same order, and the states are equal
    bit for bit."""
    seen_ref, seen = [], []
    rex = ref.Executor(_cb_chain_graph(seen_ref, pkg=ref))
    want = rex.run(rex.init_state(), 3)
    ex = _ex(_cb_chain_graph(seen), donate=donate)
    got = ex.run(ex.init_state(), 3)
    assert seen == seen_ref
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _ref_particle_diagnostic_graph(n, record, block=512, dt=workloads.DT):
    from repro.kernels.particle.ops import PARTICLE_SPEC, particle_update
    from repro.kernels.saxpy.kernel import SAXPY_SPEC
    from repro.kernels.saxpy.ops import saxpy_record

    ions = ref.DistTensor("ions", (n,), spec=PARTICLE_SPEC,
                          layout=ref.Layout.AOS)
    electrons = ref.DistTensor("electrons", (n,), spec=PARTICLE_SPEC,
                               layout=ref.Layout.AOSOA)
    field = ref.DistTensor("field", (n,), spec=SAXPY_SPEC,
                           layout=ref.Layout.SOA)
    t = ref.DistTensor("t", (1,))
    vmax = ref.make_reduction_result("vmax")
    g = ref.Graph(name="particle_step_diagnostic")
    g.split(lambda r: particle_update(r, dt, block=block), ions, writes=(0,))
    g.then_split(lambda r: particle_update(r, dt, block=block), electrons,
                 writes=(0,))
    g.then_reduce(ions, vmax, ref.MaxReducer(), field="v")
    g.then(lambda v, c: record(float(np.asarray(c)[0]),
                               float(np.asarray(v))),
           exec_kind=ref.ExecutionKind.Cpu, args=(vmax, t))
    g.then_split(lambda r, c: (saxpy_record(r, dt, block=block), c + dt),
                 field, t, writes=(0, 1))
    return g


def _particle_init(seed=0):
    """The particle fields of ``default_rng(seed)`` as the port's records
    in the diagnostic graph's layouts."""
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC

    f = workloads.particle_fields(N_FLAT, seed)
    specs = {"ions": (PARTICLE_SPEC, Layout.AOS),
             "electrons": (PARTICLE_SPEC, Layout.AOSOA),
             "field": (SAXPY_SPEC, Layout.SOA)}
    return {k: RecordArray.from_fields(
        sp, {fn: torch.from_numpy(v) for fn, v in f[k].items()}, lay)
        for k, (sp, lay) in specs.items()}


def test_particle_diagnostic_plan_runs_device_host_device():
    g, _, _ = workloads.build_particle_diagnostic_graph(N_FLAT,
                                                        lambda t, v: None)
    ex = _ex(g)
    assert [r.kind for r in ex.plan.regions] == ["device", "host", "device"]
    text = ex.describe_dag()
    assert "(war via t)" in text and "region 2 (device)" in text


@pytest.mark.parametrize("donate", [False, True])
def test_particle_diagnostic_async_sync_eager_equal(donate):
    """Async, sync and eager runs of the diagnostic step: equal states bit
    for bit and equal logs, each step's ``t`` in its own entry."""
    logs = {}
    states = {}
    for mode in ("async", "sync", "eager"):
        log = logs[mode] = []
        g, _, _ = workloads.build_particle_diagnostic_graph(
            N_FLAT, lambda t, v, log=log: log.append((t, v)))
        if mode == "eager":
            ex = Executor(g, device="cpu")
        else:
            port.clear_executable_cache()
            ex = _ex(g, donate=donate, async_regions=mode == "async")
        states[mode] = ex.run(ex.init_state(**_particle_init()), 5)
    assert logs["async"] == logs["sync"] == logs["eager"]
    ts = [t for t, _ in logs["async"]]
    assert len(ts) == 5 and ts[0] == 0.0
    assert all(b > a for a, b in zip(ts, ts[1:]))
    _equal(states["async"], states["sync"])
    _equal(states["async"], states["eager"])


def test_particle_diagnostic_equals_the_reference():
    """The same inputs through the JAX executor's async runtime: the
    logged ``(t, vmax)`` equal bit for bit, ``t`` and ``vmax`` too, the
    records within float32 1e-5."""
    from test_torch_executor import _ref_particle_state

    ref_log, log = [], []
    rex = ref.Executor(_ref_particle_diagnostic_graph(
        N_FLAT, lambda t, v: ref_log.append((t, v))))
    s0 = _ref_particle_state(rex, N_FLAT)
    init = {k: np.asarray(v) for k, v in s0.items()}
    want = rex.run(s0, 5)
    g, _, _ = workloads.build_particle_diagnostic_graph(
        N_FLAT, lambda t, v: log.append((t, v)))
    ex = _ex(g)
    got = ex.run(state_from_reference(init, "cpu"), 5)
    assert log == ref_log and len(log) == 5
    assert set(got) == set(want)
    for k in ("t", "vmax"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("ions", "electrons", "field"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


# -- the tuner times candidates as the caller runs ---------------------------------

@pytest.mark.parametrize("mode", [True, False], ids=["async", "sync"])
def test_tuned_executor_keeps_async_regions(mode, tmp_path, monkeypatch):
    """``tune="auto"`` times every candidate with the caller's
    ``async_regions`` (callbacks on the pool, or on the calling thread),
    and the tuned executor keeps it."""
    from repro_torch.tuning import cache as tune_cache

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune-cache"))
    tune_cache.clear_memo()
    threads = []
    r = DistTensor("r", (64,), spec=SPEC, layout=Layout.AOS)
    g = Graph(name="tuned-host")
    g.split(lambda v: v.set_field("y", v.field("x") + v.field("y")), r,
            writes=(0,))
    g.then(lambda v: threads.append(threading.current_thread().name),
           exec_kind=ExecutionKind.Cpu, args=(r,))
    ex = _ex(g, tune="auto", async_regions=mode)
    assert ex.plan.tuning is not None and ex.plan.tuning.measured
    assert threads
    assert all(t.startswith("ripple-host") == mode for t in threads)
    threads.clear()
    assert ex.async_regions is mode
    ex.run(ex.init_state(), 2)
    assert [t.startswith("ripple-host") for t in threads] == [mode] * 2
    tune_cache.clear_memo()


# -- StepStats completion-time contract -----------------------------------------

def test_stepstats_tracks_dispatch_separately():
    s = StepStats()
    for i in range(10):
        s.update(0.1, i, dispatch=0.02)
    assert s.mean == pytest.approx(0.1)
    assert s.dispatch_mean == pytest.approx(0.02)
    assert s.last_dispatch == pytest.approx(0.02)
    assert s.overlap_ms == pytest.approx(80.0)


def test_stepstats_overlap_zero_without_dispatch():
    s = StepStats()
    for i in range(5):
        s.update(0.1, i)
    assert s.overlap_ms == 0.0


def test_stepstats_straggler_judged_on_completion():
    """A step whose dispatch returned instantly but whose completion was
    slow IS a straggler — async dispatch must not blind the detector."""
    s = StepStats()
    for i in range(20):
        s.update(0.1 + 1e-4 * (i % 3), i, dispatch=0.001)
    assert s.update(1.0, 20, dispatch=0.001) is True
    assert s.stragglers and s.stragglers[-1][0] == 20
