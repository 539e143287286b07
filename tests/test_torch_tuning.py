"""The port's measured autotuner (``repro_torch.tuning`` and
``Executor(tune=...)``) against the JAX package's, on the CPU.

Mirrors ``tests/test_tuning.py`` and ``tests/test_tuner_conformance.py``:
the search space (layout candidates, budgets, the proposed and measured
candidates in order, which timing never decides), tuned plans bitwise
equal to the heuristic plan, the plan signature, and the persistent cache
(hits make zero measurements, corrupt files warn once, a decision written
by one process loads in another).  Every test gets its own cache
directory."""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.tuning import cache as ref_cache
from repro.tuning import search as ref_search
from repro_torch import workloads
from repro_torch.tuning import cache as tune_cache
from repro_torch.tuning import search as tune_search
from repro_torch.tuning import tiles as tune_tiles
from repro_torch.tuning import timing as tune_timing

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

# the search space is compared in full, so nothing is pruned; the cap
# keeps the JAX side's interpret-mode runs to a few seconds
PARITY_BUDGET = {"measure_all": True, "max_proposals": 12}
# a tight budget: conformance is about VALUES, not search quality
FAST_BUDGET = {"max_measure": 3, "neighborhoods": 2}


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test gets its own on-disk cache dir and fresh counters, in
    both packages."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune-cache"))
    for cache, search in ((tune_cache, tune_search), (ref_cache, ref_search)):
        cache.clear_memo()
        search.reset_stats()
    yield
    tune_cache.clear_memo()
    ref_cache.clear_memo()


# -- graphs, each built the same way in both packages --------------------------

def _mix(r):
    return r.set_field("a", r.field("a") * 1.5 + r.field("b"))


def _host_read(r):
    """A host node's body: reads the record, changes nothing."""
    float(r.field("a").sum())


def _spec(pkg):
    return pkg.RecordSpec.create("a", "b")


def make_mix_graph(pkg=port, n=1024, name="px", **kw):
    """The JAX package's ``tests/_tuning_workload.py`` graph: one ``_mix``
    node over a ``(4, n)`` AoS record."""
    p = pkg.DistTensor(name, (4, n), spec=_spec(pkg), layout=pkg.Layout.AOS,
                       **kw)
    return pkg.Graph(name=f"tune_{name}").split(_mix, p, writes=(0,))


def _haloed_graph(pkg):
    h = pkg.DistTensor("h", (64,), spec=_spec(pkg), layout=pkg.Layout.SOA,
                       halo=(1,))
    return pkg.Graph().split(lambda r: r, h, writes=(0,))


def _ref_particle_graph(n, block=None):
    from repro.kernels.particle.ops import PARTICLE_SPEC, particle_update
    from repro.kernels.saxpy.kernel import SAXPY_SPEC
    from repro.kernels.saxpy.ops import saxpy_record

    dt = workloads.DT
    ions = ref.DistTensor("ions", (n,), spec=PARTICLE_SPEC,
                          layout=ref.Layout.AOS)
    electrons = ref.DistTensor("electrons", (n,), spec=PARTICLE_SPEC,
                               layout=ref.Layout.AOSOA)
    field = ref.DistTensor("field", (n,), spec=SAXPY_SPEC,
                           layout=ref.Layout.SOA)
    vmax = ref.make_reduction_result("vmax")
    g = ref.Graph(name="particle_step")
    g.split(lambda r: particle_update(r, dt, block=block), ions, writes=(0,))
    g.then_split(lambda r: particle_update(r, dt, block=block), electrons,
                 writes=(0,))
    g.then_split(lambda r: saxpy_record(r, dt, block=block), field,
                 writes=(0,))
    g.then_reduce(ions, vmax, ref.MaxReducer(), field="v")
    return g


def _ref_flux_graph(nx, ny):
    from repro.kernels.stencil.ops import make_flux_difference_graph
    from repro.physics.euler import EULER_SPEC

    u = ref.DistTensor("u", (nx, ny), spec=EULER_SPEC, layout=ref.Layout.SOA,
                       halo=(1, 1), boundary=ref.Boundary.TRANSMISSIVE)
    out = ref.DistTensor("flux", (nx, ny), spec=EULER_SPEC,
                         layout=ref.Layout.SOA)
    return make_flux_difference_graph(u, out, 0.1, 0.1, overlap=False,
                                      use_pallas=True)


GRAPHS = {
    "mix": lambda pkg: make_mix_graph(pkg),
    "pinned": lambda pkg: make_mix_graph(pkg, n=256, name="q",
                                         pin_layout=True),
    "haloed": _haloed_graph,
    "particle": lambda pkg: (_ref_particle_graph(1024) if pkg is ref else
                             workloads.build_particle_graph(
                                 1024, block=None)[0]),
    "flux": lambda pkg: (_ref_flux_graph(16, 64) if pkg is ref else
                         workloads.build_flux_graph(16, 64)[0]),
}


def _port_ex(g, **kw):
    return port.Executor(g, device="cpu", **kw)


def _names(cands):
    return {k: [lay.name for lay in v] for k, v in cands.items()}


def _canonical(ex, state):
    """State values independent of storage layout: record tensors read
    field by field, everything else as it is."""
    out = {}
    for k, v in state.items():
        t = ex.tensors.get(k)
        if t is not None and t.is_record:
            rec = ex.read(state, t)
            for f in t.spec.names:
                out[f"{k}.{f}"] = rec.field(f).clone()
        else:
            out[k] = v.clone()
    return out


def _assert_bitwise(want: dict, got: dict, what: str):
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), f"{what}: {k} differs"


# -- the search space ------------------------------------------------------------

@pytest.mark.parametrize("graph", list(GRAPHS))
def test_layout_candidates_match_reference(graph):
    """Pins, the halo veto on AoSoA and single-layout keys drop out in
    both packages alike."""
    want = ref.layout_candidates(ref.Executor(GRAPHS[graph](ref)))
    got = port.layout_candidates(_port_ex(GRAPHS[graph](port)))
    assert _names(got) == _names(want)
    if graph == "pinned":
        assert got == {}
    if graph == "haloed":
        assert _names(got) == {"h": ["AOS", "SOA"]}


def test_layout_candidates_skip_forced_keys():
    g = make_mix_graph()
    assert port.layout_candidates(
        _port_ex(g, layout_overrides={"px": port.Layout.SOA})) == {}


@pytest.mark.parametrize("budget", [
    {}, {"max_measure_frac": 0.1}, {"min_measure": 5}, {"max_measure": 3},
    {"measure_all": True}, {"max_measure_frac": 1.0, "max_measure": 40}])
def test_measure_count_matches_reference(budget):
    mine = tune_search.TuneBudget.coerce(budget)
    theirs = ref_search.TuneBudget.coerce(budget)
    for proposed in (0, 1, 2, 3, 5, 12, 100, 512, 513):
        assert mine.measure_count(proposed) == \
            theirs.measure_count(proposed), proposed


def test_tune_budget_coerce_rejects_other_types():
    assert tune_search.TuneBudget.coerce(None) == tune_search.TuneBudget()
    b = tune_search.TuneBudget(max_measure=4)
    assert tune_search.TuneBudget.coerce(b) is b
    with pytest.raises(TypeError, match="tune_budget"):
        tune_search.TuneBudget.coerce(3)


@pytest.mark.parametrize("graph", ["mix", "particle"])
def test_search_proposes_and_measures_like_reference(graph):
    """Under ``measure_all`` both packages propose the same count and time
    the same candidate labels in the same order: the order comes from the
    cost ranking and the tile distances, never from a timing."""
    rex = ref.Executor(GRAPHS[graph](ref), tune="auto",
                       tune_budget=PARITY_BUDGET)
    ex = _port_ex(GRAPHS[graph](port), tune="auto",
                  tune_budget=PARITY_BUDGET)
    want, got = rex.plan.tuning, ex.plan.tuning
    assert got.source == want.source == "measured"
    assert (got.proposed, got.pruned, got.measured) == \
        (want.proposed, want.pruned, want.measured)
    assert [(m.kind, m.candidate) for m in got.measurements] == \
        [(m.kind, m.candidate) for m in want.measurements]
    assert got.measured == got.proposed == len(got.measurements)
    if graph == "particle":   # 27 layouts x 4 x 3 tiles, capped at 12
        assert got.proposed == 12
        assert {m.candidate.split("=")[0] for m in got.measurements[1:]} \
            <= {"particle", "saxpy"}
    else:
        assert [m.candidate for m in got.measurements] == \
            ["heuristic", "px=SOA", "px=AOSOA"]


def test_pruned_search_ranks_by_the_layout_penalty():
    """Without ``measure_all`` the cheapest layouts by penalty are timed
    first: SoA streams each field, so it outranks AoSoA and AoS."""
    ex = _port_ex(make_mix_graph(name="pr"), tune="auto",
                  tune_budget={"max_measure": 1})
    dec = ex.plan.tuning
    assert dec.proposed == 3 and dec.measured == 2 and dec.pruned == 1
    assert [m.candidate for m in dec.measurements] == ["heuristic", "pr=SOA"]
    assert "pruned by cost ranking" in dec.describe()


def test_layout_penalty_matches_reference():
    from repro.analysis.hlo import LAYOUT_PENALTY_FACTORS, \
        layout_access_penalty

    assert tune_search.LAYOUT_PENALTY_FACTORS == LAYOUT_PENALTY_FACTORS
    for lay in ("AOS", "SOA", "AOSOA"):
        for fields in (1, 2, 6):
            assert tune_search.layout_access_penalty(lay, 4096.0, fields) \
                == layout_access_penalty(lay, 4096.0, fields)


# -- tuned plans equal the heuristic plan ---------------------------------------

def _two_segment_graph():
    """A record live in three segments: a device node, a host node that
    reads it, a device node."""
    r = port.DistTensor("r", (4, 256), spec=_spec(port),
                        layout=port.Layout.AOS)
    g = port.Graph(name="two_segments").split(_mix, r, writes=(0,))
    g.then(_host_read, exec_kind=port.ExecutionKind.Cpu, args=(r,))
    g.then_split(_mix, r, writes=(0,))
    return g, r


def _particle_case():
    g = workloads.build_particle_graph(1024, block=None)[0]
    fields = workloads.particle_fields(1024, seed=3)
    specs = {"ions": port.Layout.AOS, "electrons": port.Layout.AOSOA,
             "field": port.Layout.SOA}
    inputs = {k: port.RecordArray.from_fields(
        g.all_tensors()[k].spec,
        {f: torch.from_numpy(v) for f, v in fields[k].items()}, lay)
        for k, lay in specs.items()}
    return g, inputs, {}, 3


def _segments_case():
    g, r = _two_segment_graph()
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.standard_normal((4, 256, 2),
                                                dtype=np.float32))
    inputs = {"r": port.RecordArray(data, r.spec, port.Layout.AOS)}
    return g, inputs, {"segment_layout_overrides": {
        2: {"r": port.Layout.SOA}}}, 3


def _eikonal_case():
    g, _, _ = workloads.build_eikonal_graph(64, block=None)
    return g, workloads.eikonal_inputs(64), {}, 1


CASES = {"particle": _particle_case, "segment_override": _segments_case,
         "eikonal": _eikonal_case}


@pytest.mark.parametrize("schedule", ["dag", "sequential"])
@pytest.mark.parametrize("case", list(CASES))
def test_tuned_plan_bitwise_equals_heuristic(case, schedule):
    """Layout changes are storage permutations and every tile the search
    takes tiles the data exactly, so the tuned plan computes the heuristic
    plan's bits: the particle step, a record under a per-segment layout
    override, and the eikonal solve (a conditional loop, its K5 tile
    tuned)."""
    g, inputs, kw, steps = CASES[case]()
    base = _port_ex(g, schedule=schedule, **kw)
    tuned = _port_ex(g, schedule=schedule, tune="auto",
                     tune_budget=FAST_BUDGET, tune_inputs=inputs, **kw)
    dec = tuned.plan.tuning
    assert dec.source == "measured"
    assert dec.proposed == dec.pruned + dec.measured
    if case == "eikonal":   # only the tile of the loop body is searched
        assert {m.candidate.split("=")[0]
                for m in dec.measurements[1:]} == {"eikonal"}
    if case == "segment_override":
        assert tuned.plan.per_segment[2]["r"] is port.Layout.SOA
    want = _canonical(base, base.run(base.init_state(**inputs), steps))
    got = _canonical(tuned, tuned.run(tuned.init_state(**inputs), steps))
    _assert_bitwise(want, got, dec.describe())


@pytest.mark.parametrize("layouts,tiles", [
    ({"ions": "SOA", "electrons": "AOS", "field": "AOSOA"},
     {"particle": 128, "saxpy": 256}),
    ({"ions": "AOSOA", "electrons": "SOA", "field": "AOS"},
     {"particle": 1024, "saxpy": 512})])
def test_particle_candidates_bitwise_equal(layouts, tiles):
    """Two joint candidates the search can commit, forced: the same bits
    as the heuristic plan whichever wins a timing."""
    g, inputs, _, steps = _particle_case()
    base = _port_ex(g)
    ex = _port_ex(g, layout_overrides={k: port.Layout[v]
                                       for k, v in layouts.items()},
                  tile_overrides=tiles)
    _assert_bitwise(_canonical(base, base.run(base.init_state(**inputs),
                                              steps)),
                    _canonical(ex, ex.run(ex.init_state(**inputs), steps)),
                    f"{layouts} {tiles}")


def test_per_segment_refinements_are_proposed_for_multi_segment_keys():
    g, _ = _two_segment_graph()
    ex = _port_ex(g, schedule="sequential", tune="auto",
                  tune_budget={"measure_all": True})
    labels = [m.candidate for m in ex.plan.tuning.measurements]
    homes = [si for si, seg in enumerate(ex.plan.per_segment) if "r" in seg]
    assert len(homes) >= 2
    assert any(lab.startswith("seg") for lab in labels)
    assert ex.plan.tuning.proposed == 3 + 2 * len(homes)


def test_a_refused_tile_raises_out_of_the_search():
    """A candidate whose kernel refuses its tile is not skipped: the
    search has no ``try`` around a measurement, so the fault shows."""
    g = workloads.build_particle_graph(1024, block=None)[0]
    tune_tiles.register_tile_kernel(
        "particle", lambda shape: (128, 384, 512))   # 384 does not tile
    try:
        with pytest.raises(ValueError, match="tile by block=384"):
            _port_ex(g, tune="auto", tune_budget={"measure_all": True})
    finally:
        from repro_torch.kernels.particle import kernel as particle_kernel

        tune_tiles.register_tile_kernel("particle",
                                        particle_kernel.tile_candidates)


def test_invalid_tune_mode_rejected():
    with pytest.raises(ValueError, match="tune must be"):
        _port_ex(make_mix_graph(), tune="always")


def test_describe_tuning_with_tuning_off():
    ex = _port_ex(make_mix_graph())
    assert ex.plan.tuning is None
    assert 'tune="auto"' in ex.describe_tuning()


# -- plan signature --------------------------------------------------------------

def test_overrides_change_the_plan_signature():
    g, _ = _two_segment_graph()
    a = _port_ex(g, schedule="sequential")
    b = _port_ex(g, schedule="sequential",
                 segment_layout_overrides={2: {"r": port.Layout.SOA}})
    c = _port_ex(g, schedule="sequential",
                 segment_layout_overrides={2: {"r": port.Layout.SOA}})
    d = _port_ex(g, schedule="sequential", tile_overrides={"genrec": 4})
    assert len({a.plan.signature, b.plan.signature, d.plan.signature}) == 3
    assert b.plan.signature == c.plan.signature
    assert len(a.plan.signature) == 12
    assert _port_ex(g).plan.signature != a.plan.signature   # schedule


def test_rebuilt_graph_keeps_its_signature():
    """Node names differ between two builds; the signature keys code and
    closures, so an identical rebuild matches and another constant
    does not."""
    one = _port_ex(workloads.build_particle_graph(1024, block=None)[0])
    two = _port_ex(workloads.build_particle_graph(1024, block=None)[0])
    other = _port_ex(workloads.build_particle_graph(1024, block=None,
                                                    dt=0.02)[0])
    assert one.plan.signature == two.plan.signature
    assert one.plan.signature != other.plan.signature


def test_signature_keys_small_tensors_by_value():
    def graph(scale):
        t = port.DistTensor("t", (8,))
        return port.Graph().split(lambda x: x * scale, t)

    sig = [_port_ex(graph(torch.tensor([s]))).plan.signature
           for s in (1.0, 1.0, 2.0)]
    assert sig[0] == sig[1] != sig[2]


# -- persistent cache --------------------------------------------------------------

def test_cache_hit_performs_zero_timed_measurements():
    g = make_mix_graph(name="pc")
    _port_ex(g, tune="auto")
    measured = tune_search.STATS["measurements"]
    assert measured > 0
    ex2 = _port_ex(g, tune="auto")
    assert tune_search.STATS["measurements"] == measured   # ZERO new
    assert ex2.plan.tuning.source == "cache"
    # without the in-process memo the decision loads from the FILE
    tune_cache.clear_memo()
    ex3 = _port_ex(g, tune="load")
    assert tune_search.STATS["measurements"] == measured
    assert ex3.plan.tuning.source == "cache"
    assert ex3.plan.tuning.measurements   # the report survives the trip
    assert ex3.plan.per_segment == ex2.plan.per_segment


def test_load_mode_without_cache_keeps_heuristics_and_never_measures():
    g = make_mix_graph(name="pl")
    ex = _port_ex(g, tune="load")
    assert tune_search.STATS["measurements"] == 0
    dec = ex.plan.tuning
    assert dec.source == "heuristic" and not dec.applied
    assert "heuristic configuration in effect" in ex.describe_tuning()
    assert ex.plan.per_segment == _port_ex(g).plan.per_segment


def test_corrupt_cache_falls_back_to_heuristics_with_single_warning():
    g = make_mix_graph(name="pk")
    probe = _port_ex(g)   # same heuristic plan -> same tuning key
    path = tune_cache.cache_path(tune_search.tuning_key(probe))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("{ this is not json")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ex = _port_ex(g, tune="load")
        ex2 = _port_ex(g, tune="load")
    assert [w.category for w in caught] == [RuntimeWarning]
    assert "corrupt or incompatible" in str(caught[0].message)
    for e in (ex, ex2):
        assert not e.plan.tuning.applied
        assert e.plan.per_segment == probe.plan.per_segment
    assert tune_search.STATS["measurements"] == 0


def test_schema_mismatch_is_a_miss_and_auto_remeasures():
    g = make_mix_graph(name="ps")
    key = tune_search.tuning_key(_port_ex(g))
    path = tune_cache.cache_path(key)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"schema": 999, "key": key,
                                "layouts": {}, "tiles": {}}))
    with pytest.warns(RuntimeWarning, match="schema"):
        ex = _port_ex(g, tune="auto")
    assert ex.plan.tuning.source == "measured"
    assert tune_search.STATS["measurements"] > 0
    assert json.loads(path.read_text())["schema"] == \
        tune_cache.SCHEMA_VERSION


def test_atomic_store_and_memo_roundtrip():
    tune_cache.store("k1", {"layouts": {}, "tiles": {}, "measurements": []})
    assert tune_cache.load("k1")["schema"] == tune_cache.SCHEMA_VERSION
    assert [p.name for p in tune_cache.cache_dir().iterdir()] == ["k1.json"]
    tune_cache.clear_memo()
    loaded = tune_cache.load("k1")
    assert loaded is not None and loaded["key"] == "k1"


def test_applied_decision_roundtrips_through_the_file():
    g, _ = _two_segment_graph()
    key = tune_search.tuning_key(_port_ex(g))
    dec = tune_search.TuningDecision(
        "measured", key, layouts={"r": port.Layout.SOA},
        tiles={"eikonal": (16, 64)},
        segment_layouts={2: {"r": port.Layout.AOSOA}}, baseline_ms=2.0,
        tuned_ms=1.0)
    tune_cache.store(key, tune_search._payload(dec))
    tune_cache.clear_memo()
    ex = _port_ex(g, tune="load")
    got = ex.plan.tuning
    assert got.source == "cache"
    assert (got.layouts, got.tiles, got.segment_layouts) == \
        (dec.layouts, dec.tiles, dec.segment_layouts)
    assert ex.plan.per_segment[0]["r"] is port.Layout.SOA
    assert ex.plan.per_segment[2]["r"] is port.Layout.AOSOA
    assert ex._tile_config == {"eikonal": (16, 64)}
    assert ex.plan.signature != _port_ex(g).plan.signature


def test_device_assortment_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert tune_cache.device_assortment() == ((("cpu", "cpu", None, 1),), 1)


def test_tuning_key_changes_with_device_assortment_and_torch(monkeypatch):
    probe = _port_ex(make_mix_graph(name="pa"))
    key_here = tune_search.tuning_key(probe)
    seen = {key_here}
    for fake in ((("cpu", "cpu", None, 1),),
                 (("cuda", "NVIDIA H100 80GB HBM3", (9, 0), 1),),
                 (("cuda", "NVIDIA H100 80GB HBM3", (9, 0), 4),)):
        for procs in (1, 2):
            monkeypatch.setattr(tune_cache, "device_assortment",
                                lambda f=fake, p=procs: (f, p))
            seen.add(tune_search.tuning_key(probe))
    monkeypatch.undo()
    assert len(seen) == 6   # the real assortment is one of the fakes
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    assert tune_search.tuning_key(probe) not in seen
    monkeypatch.undo()
    assert tune_search.tuning_key(probe) == key_here   # and it's stable


def test_the_packages_never_share_a_key():
    assert tune_search.tuning_key(_port_ex(make_mix_graph())) != \
        ref_search.tuning_key(ref.Executor(make_mix_graph(ref)))


def test_corrupt_fault_exercises_warn_once_fallback():
    from repro_torch.runtime.faults import Fault, FaultPlan, fault_scope

    tune_cache.store("chaos", {"layouts": {}, "tiles": {},
                               "measurements": []})
    tune_cache.clear_memo()
    plan = FaultPlan([Fault("tuning.cache.load", nth=0, kind="corrupt")])
    with fault_scope(plan), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tune_cache.load("chaos") is None
        assert tune_cache.load("chaos") is None
    assert plan.exhausted()
    assert [x.category for x in w] == [RuntimeWarning]


def test_tuning_lock_acquires_releases_and_breaks_stale_locks():
    with tune_cache.tuning_lock("k") as got:
        assert got is True
        assert (tune_cache.cache_dir() / "k.lock").exists()
    assert not (tune_cache.cache_dir() / "k.lock").exists()
    lock = tune_cache.cache_dir() / "k.lock"
    lock.write_text("999999 0\n")
    os.utime(lock, (0, 0))
    with tune_cache.tuning_lock("k", timeout_s=5.0) as got:
        assert got is True
    assert not lock.exists()


def test_cache_written_by_one_process_loads_in_subprocess():
    """The serving pattern across processes: this process tunes and
    persists; a fresh interpreter builds the same graph from this module
    and must apply the cached decision with ZERO timed measurements."""
    ex = _port_ex(make_mix_graph(), tune="auto")
    assert ex.plan.tuning.source == "measured"
    assert len(os.listdir(os.environ["REPRO_TUNE_CACHE"])) == 1
    code = f"""
from {__name__} import make_mix_graph
from repro_torch.core import Executor
from repro_torch.tuning import search

ex = Executor(make_mix_graph(), device="cpu", tune="auto")
assert ex.plan.tuning.source == "cache", ex.plan.tuning.source
assert search.STATS["measurements"] == 0, search.STATS
print("LAYOUTS:", sorted((k, v.name)
                         for k, v in ex.plan.tuning.layouts.items()))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, HERE,
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    want = sorted((k, v.name) for k, v in ex.plan.tuning.layouts.items())
    assert f"LAYOUTS: {want}" in out.stdout


# -- timing harness --------------------------------------------------------------

def test_time_fn_budget_stops_a_dominated_candidate():
    calls = []
    first, steady, iters, dominated = tune_timing.time_fn_budget(
        lambda: calls.append(1), iters=5, warmup=2, min_iters=2,
        stop_above_ms=-1.0)
    assert dominated and iters == 2 and len(calls) == 1 + 1 + 2
    first, steady = tune_timing.time_fn_split(lambda: calls.append(1),
                                              iters=3, warmup=1)
    assert len(calls) == 4 + 1 + 3 and steady >= 0.0
    assert tune_timing.time_fn(lambda: torch.ones(4), iters=1) >= 0.0


def test_a_raising_candidate_leaves_no_losers_executables(monkeypatch):
    """A candidate that raises mid-search still has the losers' region
    programs dropped: at most the incumbent's entry stays in the
    process-wide cache (before the fix, 3 plans stayed)."""
    from repro_torch.core import executor as executor_lib

    port.clear_executable_cache()
    g = workloads.build_particle_graph(1024, block=None)[0]
    made = []

    class FourthFails(executor_lib.Executor):
        def run(self, state, steps):
            if self not in made:
                made.append(self)
            if made.index(self) == 3:
                raise RuntimeError("candidate 4 fails")
            return super().run(state, steps)

    caller = executor_lib.Executor
    monkeypatch.setattr(executor_lib, "Executor", FourthFails)
    with pytest.raises(RuntimeError, match="candidate 4 fails"):
        caller(g, device="cpu", regions=True, donate=True, tune="auto",
               tune_budget={"measure_all": True})
    assert len(made) == 4
    assert port.executable_cache_stats()["plans"] <= 1
    port.clear_executable_cache()
