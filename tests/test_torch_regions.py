"""Region compile in the port (``Executor(regions=True)``) on the CPU.

On the CPU a region's pieces run through the same code and the same static
buffers as on the card, without capture; ``trace_events`` counts pieces
built.  The cases ported from the JAX package's ``tests/test_regions.py``
keep their names (a "trace" there is a piece built here); the port's own
cases hold ``regions=True`` bit for bit against ``regions=False`` on the
four graphs of the main path under both donation settings, and within
the golden tolerances (float32 1e-5, flux 1e-4) against the JAX package's
``Executor(regions=True)`` on the same numpy inputs."""

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch import workloads
from repro_torch.core import (DistTensor, ExecutionKind, Executor, Graph,
                              Layout, RecordArray, RecordSpec, SumReducer,
                              make_reduction_result, plan_signature,
                              preferred_layout)
from repro_torch.interop import state_from_reference

SPEC = RecordSpec.create("a", "b")
F32_TOL = 1e-5
FLUX_TOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_cache():
    port.clear_executable_cache()
    yield
    port.clear_executable_cache()


def _bump_a(r):
    return r.set_field("a", r.field("a") + 1.0)


def _accum_b(r):
    return r.set_field("b", r.field("b") + r.field("a"))


def _chain_graph():
    """Device-only chain (one segment, one region, one graph)."""
    u = DistTensor("u", (8, 8))
    ws = DistTensor("ws", (8, 8))
    smax = make_reduction_result("smax")
    g = Graph()
    g.split(lambda a, b: a * 2.0, u, ws)
    g.then_reduce(ws, smax, SumReducer())
    g.then_split(lambda a, s: a + s, u, smax, writes=(0,))
    return g


def build_relayout_chain(n_pairs=2, n=256):
    """``device, loop, device, loop, ...`` with AoS<->SoA relayouts at
    every segment boundary; each loop runs once per pass (the device
    segment before it resets its flag)."""
    r = DistTensor("r", (n,), spec=SPEC, layout=Layout.AOS)
    g = Graph(name=f"chain{n_pairs}")
    for i in range(n_pairs):
        f = DistTensor(f"f{i}", (1,))
        g.then_split(_bump_a, r, writes=(0,), layout=Layout.AOS)
        g.split(lambda x: torch.zeros_like(x), f, writes=(0,))
        loop = Graph(name=f"loop{i}")
        loop.split(_accum_b, r, writes=(0,), layout=Layout.SOA)
        loop.split(lambda x: torch.ones_like(x), f, writes=(0,))
        loop.conditional((lambda nm: lambda s: s[nm][0] < 0.5)(f"f{i}"))
        g.then(loop)
    return g


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# -- the four graphs of the main path, at small sizes -----------------------------

N_FLAT = 4096
N_GRID = 64


def _particle_state(ex, seed=0):
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC

    f = workloads.particle_fields(N_FLAT, seed)
    specs = {"ions": (PARTICLE_SPEC, Layout.AOS),
             "electrons": (PARTICLE_SPEC, Layout.AOSOA),
             "field": (SAXPY_SPEC, Layout.SOA)}
    return ex.init_state(**{
        k: RecordArray.from_fields(
            sp, {fn: torch.from_numpy(v) for fn, v in f[k].items()}, lay)
        for k, (sp, lay) in specs.items()})


def _main_path(name, seed=0):
    """``(graph, make_state(ex), run(ex, state))`` of one main-path graph;
    the inputs come from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    if name == "saxpy":
        g, _ = workloads.build_saxpy_graph(N_FLAT, 2.0, block=256)
        x = torch.from_numpy(rng.standard_normal(N_FLAT, dtype=np.float32))
        return g, lambda ex: ex.init_state(x=x), lambda ex, s: ex.run(s, 3)
    if name == "particle":
        g, _, _ = workloads.build_particle_graph(N_FLAT)
        return (g, lambda ex: _particle_state(ex, seed),
                lambda ex, s: ex.run(ex.run(s, 2), 3))
    if name == "flux":
        from repro_torch.physics.euler import shock_bubble_init

        g, _ = workloads.build_flux_graph(N_GRID, N_GRID, lam_y=0.05)
        u = shock_bubble_init(N_GRID, N_GRID, device="cpu")
        u = u + 0.01 * torch.from_numpy(
            rng.standard_normal(tuple(u.shape), dtype=np.float32))
        return g, lambda ex: ex.init_state(u=u), lambda ex, s: ex.run(s, 3)
    g, _, _ = workloads.build_eikonal_graph(N_GRID, block=(8, 64),
                                            max_iters=4 * N_GRID)
    inp = workloads.eikonal_inputs(N_GRID)
    phi = np.where(inp["mask"], 0.0,
                   1e3 * rng.uniform(0.5, 1.0, inp["phi"].shape))
    init = {"phi": torch.from_numpy(phi.astype(np.float32)),
            "mask": torch.from_numpy(inp["mask"])}
    return g, lambda ex: ex.init_state(**init), lambda ex, s: ex(s)


GRAPHS = ["saxpy", "particle", "flux", "eikonal"]


@pytest.mark.parametrize("schedule", ["dag", "sequential"])
@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("graph", GRAPHS)
def test_regions_equal_eager_bit_for_bit(graph, donate, schedule):
    g, make, run = _main_path(graph)
    eager = Executor(g, device="cpu", schedule=schedule, regions=False)
    want = run(eager, make(eager))
    ex = Executor(g, device="cpu", regions=True, donate=donate,
                  schedule=schedule)
    _equal(run(ex, make(ex)), want)
    # steady state: another run builds nothing
    stats = ex.cache_stats()
    _equal(run(ex, make(ex)), want)
    assert ex.cache_stats() == stats


@pytest.mark.parametrize("graph", GRAPHS)
def test_regions_follow_inputs_that_change_after_the_build(graph):
    """A state from another seed, after the pieces are built, gives the
    eager result on that state: nothing of the first state is baked in."""
    g, make, run = _main_path(graph)
    ex = Executor(g, device="cpu", regions=True, donate=True)
    run(ex, make(ex))
    g2, make2, run2 = _main_path(graph, seed=1)
    eager = Executor(g2, device="cpu", regions=False)
    want = run2(eager, make2(eager))
    builds = ex.cache_stats()["trace_events"]
    _equal(run(ex, make2(ex)), want)
    assert ex.cache_stats()["trace_events"] == builds


def _ref_saxpy_graph(n):
    from repro.kernels.saxpy.ops import saxpy

    x, y_bc, y_nbc = (ref.DistTensor(k, (n,)) for k in ("x", "y_bc",
                                                         "y_nbc"))
    g = ref.Graph(name="saxpy_probe")
    g.split(lambda xv, yv: saxpy(2.0, xv, yv, block=256), x, y_bc)
    g.split(lambda xv, yv: saxpy(2.0, xv, yv, block=256, bounds_check=False),
            x, y_nbc)
    return g


@pytest.mark.parametrize("graph", GRAPHS)
def test_regions_match_reference_regions(graph):
    """The port's region path against the JAX package's on the same numpy
    inputs, each running its own region compile."""
    from test_torch_executor import _ref_flux_graph, _ref_particle_graph
    from test_torch_eikonal import _ref_eikonal_graph

    g, make, run = _main_path(graph)
    ex = Executor(g, device="cpu", regions=True)
    init = {k: v.numpy() for k, v in make(ex).items()}
    got = run(ex, state_from_reference(init, "cpu"))
    tol = F32_TOL
    if graph == "saxpy":
        rex = ref.Executor(_ref_saxpy_graph(N_FLAT), regions=True,
                           donate=False)
        want = rex.run(rex.init_state(**init), 3)
    elif graph == "particle":
        rex = ref.Executor(_ref_particle_graph(N_FLAT), regions=True,
                           donate=False)
        want = rex.run(rex.run(rex.init_state(**init), 2), 3)
    elif graph == "flux":
        from repro.kernels.stencil.ops import make_flux_difference_graph
        from repro.physics.euler import EULER_SPEC

        u = ref.DistTensor("u", (N_GRID, N_GRID), spec=EULER_SPEC,
                           layout=ref.Layout.SOA, halo=(1, 1),
                           boundary=ref.Boundary.TRANSMISSIVE)
        out = ref.DistTensor("flux", (N_GRID, N_GRID), spec=EULER_SPEC,
                             layout=ref.Layout.SOA)
        rex = ref.Executor(make_flux_difference_graph(
            u, out, 0.1, 0.05, overlap=False, use_pallas=True),
            regions=True, donate=False)
        want = rex.run(rex.init_state(**init), 3)
        tol = FLUX_TOL
    else:
        rex = ref.Executor(_ref_eikonal_graph(N_GRID, 4, (8, 64), loop=True),
                           regions=True, donate=False)
        want = rex(rex.init_state(**init))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy().astype(np.float64),
                                   w.astype(np.float64), rtol=tol, atol=tol,
                                   err_msg=k)


# -- aliasing in the copy-back ------------------------------------------------------

@pytest.mark.parametrize("donate", [False, True])
def test_eikonal_phi_prev_holds_the_old_phi(donate):
    """The body's first node returns phi itself for phi_prev; after one
    iteration phi_prev must be the phi it started from, not the new one."""
    g, _, _ = workloads.build_eikonal_graph(N_GRID, block=(8, 64))
    body = g.levels[0][0].subgraph
    left = [1]

    def once(state):
        go = left[0] > 0
        left[0] -= 1
        return go

    body.conditional(once)
    inp = workloads.eikonal_inputs(N_GRID)
    ex = Executor(g, device="cpu", regions=True, donate=donate)
    phi0 = torch.from_numpy(inp["phi"])
    out = ex(ex.init_state(phi=phi0, mask=inp["mask"]))
    assert torch.equal(out["phi_prev"], phi0)
    assert not torch.equal(out["phi"], phi0)
    assert torch.equal(out["change"], (out["phi"] - phi0).abs())
    left[0] = 1
    eager = Executor(g, device="cpu", regions=False)
    _equal(out, eager(eager.init_state(phi=phi0, mask=inp["mask"])))


def test_swapped_outputs_go_through_a_temporary():
    """Two keys whose outputs are each other's buffers: a cycle that no
    copy order resolves."""
    a, b = DistTensor("a", (16,)), DistTensor("b", (16,))
    g = Graph(name="swap")
    g.then(lambda x, y: (y, x), args=(a, b), writes=(0, 1))
    ex = Executor(g, device="cpu", regions=True, donate=True)
    x0, y0 = torch.arange(16.0), -torch.arange(16.0)
    st = ex(ex.init_state(a=x0, b=y0))
    assert torch.equal(st["a"], y0) and torch.equal(st["b"], x0)
    st = ex(st)
    assert torch.equal(st["a"], x0) and torch.equal(st["b"], y0)


def _two_key_graph(shape: str):
    """``a <- a - 3`` and ``b <- 2 b + 1``: in one piece, or in two device
    regions with ``b``'s first (so ``b``'s buffer is written before
    ``a`` is staged)."""
    a, b = DistTensor("a", (16,)), DistTensor("b", (16,))
    g = Graph(name=f"two keys {shape}")
    if shape == "one piece":
        g.then(lambda x, y: (x - 3.0, y * 2.0 + 1.0), args=(a, b),
               writes=(0, 1))
        return g
    g.split(lambda y: y * 2.0 + 1.0, b, writes=(0,))
    g.sync()
    g.split(lambda x: x - 3.0, a, writes=(0,))
    return g


@pytest.mark.parametrize("case", ["swapped", "one fresh"])
@pytest.mark.parametrize("shape", ["one piece", "two regions"])
def test_donated_buffers_passed_back_under_other_keys(shape, case):
    """A donated state's buffers handed back under each other's keys: every
    key reads the value it was given, as with ``regions=False``."""
    g = _two_key_graph(shape)
    ex = Executor(g, device="cpu", regions=True, donate=True)
    eager = Executor(g, device="cpu", regions=False)
    st = ex(ex.init_state(a=torch.arange(16.0), b=-torch.arange(16.0)))
    bufs = {b.data_ptr() for b in ex._cache.buffers.values()}
    assert {st["a"].data_ptr(), st["b"].data_ptr()} <= bufs   # aliases
    fresh = torch.full((16,), 7.0)
    inp = ({"a": st["b"], "b": st["a"]} if case == "swapped"
           else {"a": st["b"], "b": fresh})
    want = eager({k: v.clone() for k, v in inp.items()})
    _equal(ex(inp), want)
    _equal(ex(ex.init_state(a=fresh, b=fresh)),
           eager(eager.init_state(a=fresh, b=fresh)))


def test_an_entry_goes_with_its_graph_once_unused():
    """An entry outlives its executors while its graph lives (the reuse);
    once neither is left, it goes, and the tensors the graph's closures
    held with it."""
    import gc
    import weakref

    def build():
        u = DistTensor("u", (64,))
        w = torch.linspace(0.0, 1.0, 64)
        g = Graph(name="closure")
        g.split(lambda x: x * w + 1.0, u, writes=(0,))
        return g, weakref.ref(w)

    g, w_ref = build()
    ex = Executor(g, device="cpu", regions=True, donate=True)
    ex(ex.init_state())
    del ex
    gc.collect()
    assert port.executable_cache_stats()["entries"] == 1
    two = Executor(g, device="cpu", regions=True, donate=True)
    two(two.init_state())
    assert two.cache_stats()["trace_events"] == 1    # reused, no build
    del g                     # the executor still holds the graph
    gc.collect()
    assert port.executable_cache_stats()["entries"] == 1
    del two
    gc.collect()
    assert port.executable_cache_stats()["entries"] == 0
    assert w_ref() is None
    for _ in range(3):        # rebuilt graphs replace, never accumulate
        g, w_ref = build()
        ex = Executor(g, device="cpu", regions=True)
        ex(ex.init_state())
        assert port.executable_cache_stats()["entries"] == 1
        del g, ex
        gc.collect()
        assert w_ref() is None
    assert port.executable_cache_stats()["entries"] == 0


# -- sharing one cache entry ----------------------------------------------------------

@pytest.mark.parametrize("donate", [False, True])
def test_two_executors_of_one_signature_interleaved(donate):
    g, make, _ = _main_path("particle")
    one = Executor(g, device="cpu", regions=True, donate=donate)
    two = Executor(g, device="cpu", regions=True, donate=donate)
    assert plan_signature(one) == plan_signature(two)
    eager = Executor(g, device="cpu", regions=False)
    s1, s2 = make(one), _particle_state(two, seed=1)
    e1, e2 = dict(s1), dict(s2)
    for _ in range(3):
        s1, s2 = one(s1), two(s2)
        e1, e2 = eager(e1), eager(e2)
    _equal(s1, e1)
    _equal(s2, e2)
    assert one._cache is two._cache       # under either donate


def test_a_dead_donating_executor_frees_its_entry():
    g, make, _ = _main_path("saxpy")
    one = Executor(g, device="cpu", regions=True, donate=True)
    one(make(one))
    entry = one._cache
    del one
    two = Executor(g, device="cpu", regions=True, donate=True)
    two(make(two))
    assert two._cache is entry
    assert two.cache_stats()["trace_events"] == 1


def test_tuner_keeps_only_the_winners_executables(monkeypatch, tmp_path):
    from repro_torch.tuning import cache as tune_cache

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune-cache"))
    tune_cache.clear_memo()
    g, make, _ = _main_path("particle")
    eager = Executor(g, device="cpu", regions=False)
    inputs = make(eager)
    ex = Executor(g, device="cpu", regions=True, donate=True, tune="auto",
                  tune_inputs=inputs,
                  tune_budget={"max_measure": 4, "max_proposals": 16})
    assert ex.plan.tuning.measured >= 2
    tune_cache.clear_memo()
    stats = port.executable_cache_stats()
    assert stats["plans"] == 1 and stats["entries"] == 1
    from repro_torch.core import executor as executor_mod

    (key,) = executor_mod._EXECUTABLE_CACHE
    assert key[0] == ex._plan_sig
    built = stats["trace_events"]
    got = ex.run(ex.init_state(**inputs), 2)
    want = eager.run(dict(inputs), 2)
    for k, t in ex.tensors.items():
        assert torch.equal(ex.read(got, t).with_layout(Layout.AOS).data,
                           eager.read(want, t).with_layout(Layout.AOS).data)
    assert torch.equal(got["vmax"], want["vmax"])
    assert port.executable_cache_stats()["trace_events"] == built
    assert ex.cache_stats()["hits"] >= 1


def test_cpu_regions_never_touch_torch_cuda(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("torch.cuda called on the CPU path")

    for name in ("is_available", "synchronize", "current_stream", "Stream",
                 "stream", "graph", "CUDAGraph", "graph_pool_handle",
                 "current_device", "set_stream", "device_count"):
        monkeypatch.setattr(torch.cuda, name, boom)
    for graph in ("eikonal", "particle"):
        g, make, run = _main_path(graph)
        for donate in (False, True):
            ex = Executor(g, device="cpu", regions=True, donate=donate)
            run(ex, make(ex))
    x = DistTensor("x", (8,))
    loop = Graph(name="dec")
    loop.split(lambda v: v - 1.0, x, writes=(0,))
    loop.then(lambda v: None, exec_kind=ExecutionKind.Cpu, args=(x,))
    loop.conditional(lambda s: s["x"][0] > 0.0)
    hg = Graph()
    hg.split(lambda v: torch.full_like(v, 2.0), x, writes=(0,))
    hg.then(loop)
    ex = Executor(hg, device="cpu", regions=True)
    assert torch.equal(ex(ex.init_state())["x"], torch.zeros(8))


def test_state_of_another_shape_is_refused():
    g, make, _ = _main_path("saxpy")
    ex = Executor(g, device="cpu", regions=True)
    ex(make(ex))
    st = ex.init_state(x=torch.ones(N_FLAT, dtype=torch.float64))
    with pytest.raises(ValueError, match="region was built for"):
        ex(st)


# -- cases of the JAX package's tests/test_regions.py ------------------------------

def test_executor_regions_match_segments():
    ex = Executor(build_relayout_chain(), device="cpu", regions=True)
    assert [k for k, _ in ex._segments] == ["device", "loop", "device",
                                            "loop"]
    assert [(r.kind, len(r)) for r in ex.plan.regions] == [("device", 4)]
    assert [(r.kind, r.start, r.stop) for r in ex.plan.regions] == \
        [(r.kind, r.start, r.stop)
         for r in port.group_regions([k for k, _ in ex._segments])]


def test_run_fused_shares_one_trace_across_steps():
    """Distinct step counts share the one graph of a device-only graph."""
    ex = Executor(_chain_graph(), device="cpu", regions=True)
    assert ex.dag.device_only
    ex.run(ex.init_state(u=torch.ones(8, 8)), steps=3)
    base = ex.cache_stats()
    assert base["trace_events"] == 1 and base["executables"] == 1
    for steps in (1, 5, 17):
        ex.run(ex.init_state(u=torch.ones(8, 8)), steps=steps)
    assert ex.cache_stats() == base


def test_run_fused_values_match_stepwise_calls():
    g = _chain_graph()
    ex = Executor(g, device="cpu", regions=True)
    st_fused = ex.run(ex.init_state(u=torch.ones(8, 8)), steps=3)
    ex2 = Executor(g, device="cpu")
    st = ex2.init_state(u=torch.ones(8, 8))
    for _ in range(3):
        st = ex2(st)
    _equal(st_fused, st)


def test_region_run_steady_state_is_build_free():
    """After warm-up, further runs build nothing, and the only eager
    relayout left is the trailing restore (once per run, not per step)."""
    ex = Executor(build_relayout_chain(), device="cpu", regions=True)
    ex.run(ex.init_state(), steps=2)    # both entry layouts built
    warm = ex.cache_stats()
    assert warm["executables"] == 2 and warm["trace_events"] == 8
    eager0 = ex.eager_relayouts
    ex.run(ex.init_state(), steps=10)
    assert ex.cache_stats() == warm
    assert ex.eager_relayouts - eager0 == 1


def test_region_equals_sequential_per_segment_dispatch():
    outs = {}
    for tag, kw in (("region", dict(schedule="dag", regions=True)),
                    ("legacy", dict(schedule="sequential", regions=False))):
        ex = Executor(build_relayout_chain(), device="cpu", **kw)
        outs[tag] = ex.run(ex.init_state(), steps=3)
    _equal(outs["region"], outs["legacy"])


def test_regions_false_run_escapes_the_cache_machinery():
    g = _chain_graph()
    ex = Executor(g, device="cpu", regions=False)
    st = ex.run(ex.init_state(u=torch.ones(8, 8)), steps=3)
    assert ex._cache is None
    assert port.executable_cache_stats()["plans"] == 0
    reg = Executor(g, device="cpu", regions=True)
    _equal(st, reg.run(reg.init_state(u=torch.ones(8, 8)), steps=3))


def test_second_executor_reuses_executables_without_tracing():
    ex1 = Executor(build_relayout_chain(3), device="cpu", regions=True)
    ex1.run(ex1.init_state(), steps=2)
    before = ex1.cache_stats()
    ex2 = Executor(build_relayout_chain(3), device="cpu", regions=True)
    st = ex2.run(ex2.init_state(), steps=2)
    after = ex2.cache_stats()
    assert after["trace_events"] == before["trace_events"]
    assert after["builds"] == before["builds"]
    assert after["hits"] >= 2          # both entry-layout programs reused
    rec = ex2.read(st, DistTensor("r", (256,), spec=SPEC))
    np.testing.assert_allclose(rec.field("a").numpy(), 6.0)


def test_describe_dag_shows_regions_and_cache():
    ex = Executor(build_relayout_chain(), device="cpu", regions=True)
    out = ex.describe_dag()
    assert "regions (captured graphs):" in out
    assert "region 0 (device): seg0..seg3 (4 segments -> 4 graphs)" in out
    assert f"plan signature {ex.plan.signature}" in out
    assert "executable cache: 0 executables" in out
    eager = Executor(build_relayout_chain(), device="cpu",
                     regions=False).describe_dag()
    assert "each segment dispatched eagerly" in eager


def test_plan_signature_keys_donation():
    assert plan_signature(Executor(_chain_graph(), device="cpu",
                                   donate=True)) \
        != plan_signature(Executor(_chain_graph(), device="cpu",
                                   donate=False))


def test_donate_false_keeps_inputs_and_copies():
    u = DistTensor("u", (128, 128))
    g = Graph()
    g.split(lambda x: x + 1.0, u, writes=(0,))
    ex = Executor(g, device="cpu", regions=True, donate=False)
    st = ex.init_state()
    st1 = ex(st)
    st2 = ex(st1)
    assert torch.equal(st["u"], torch.zeros(128, 128))
    assert torch.equal(st1["u"], torch.ones(128, 128))   # not overwritten
    assert torch.equal(st2["u"], torch.full((128, 128), 2.0))
    bufs = {id(b) for b in ex._cache.buffers.values()}
    assert not {id(st1["u"]), id(st2["u"])} & bufs


def test_donate_true_returns_the_static_buffers():
    u = DistTensor("u", (128, 128))
    g = Graph()
    g.split(lambda x: x + 1.0, u, writes=(0,))
    ex = Executor(g, device="cpu", regions=True, donate=True)
    st = ex.init_state()
    st1 = ex(st)
    assert torch.equal(st["u"], torch.zeros(128, 128))    # copied in
    buf = st1["u"]           # an alias of the static buffer
    assert any(buf.data_ptr() == b.data_ptr()
               for b in ex._cache.buffers.values())
    buf[0, 0] = 10.0           # an in-place write lands in the buffer
    st2 = ex(st1)
    assert st2["u"] is buf     # no copy-in: the buffer is read in place
    assert float(buf[0, 0]) == 11.0 and float(buf[1, 1]) == 2.0


def test_host_loop_sub_executor_built_once():
    x = DistTensor("x", (8,))
    seen = []
    loop = Graph(name="dec")
    loop.split(lambda v: v - 1.0, x, writes=(0,))
    loop.then(lambda v: seen.append(float(v[0])),
              exec_kind=ExecutionKind.Cpu, args=(x,))
    loop.conditional(lambda s: s["x"][0] > 0.0)
    g = Graph()
    g.split(lambda v: torch.full_like(v, 3.0), x, writes=(0,))
    g.then(loop)
    ex = Executor(g, device="cpu", regions=True, donate=False)
    assert "host_loop" in [k for k, _ in ex._segments]
    st = ex.run(ex.init_state(), steps=2)
    assert len(ex._sub_execs) == 1
    sub = next(iter(ex._sub_execs.values()))
    assert sub.regions and not sub.donate
    ex.run(st, steps=1)
    assert next(iter(ex._sub_execs.values())) is sub
    assert seen == [2.0, 1.0, 0.0] * 3
    assert torch.equal(st["x"], torch.zeros(8))


def test_region_with_record_hints_restores_initial_layout():
    t = DistTensor("p", (256,), spec=SPEC, layout=Layout.SOA)
    g = Graph()
    g.split(_bump_a, preferred_layout(t, Layout.AOS), writes=(0,))
    g.sync()
    g.split(_bump_a, preferred_layout(t, Layout.AOSOA), writes=(0,))
    ex = Executor(g, device="cpu", regions=True)
    assert [r.kind for r in ex.plan.regions] == ["device", "host", "device"]
    st = ex(ex.init_state())
    assert tuple(st["p"].shape) == (256, 2)   # restored to initial (AoS)
    np.testing.assert_allclose(ex.read(st, t).field("a").numpy(), 2.0)
