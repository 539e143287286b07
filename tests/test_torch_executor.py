"""The port's graph, DAG schedule, layout plan and executor against the
JAX package, on the CPU.

The slice end to end: the particle step graph (the JAX package's
``examples/particles.py``) and the FORCE flux graph run under the JAX
``Executor`` and under ``repro_torch``'s ``Executor(device="cpu")`` from
the same initial state, carried across by ``repro_torch.interop``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch import workloads
from repro_torch.interop import state_from_reference, state_to_reference

F32_TOL = 1e-5


def _np_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


# -- the two graphs of the slice, built in both packages ----------------------

def _ref_particle_graph(n, block=512, dt=workloads.DT):
    from repro.kernels.particle.ops import PARTICLE_SPEC, particle_update
    from repro.kernels.saxpy.kernel import SAXPY_SPEC
    from repro.kernels.saxpy.ops import saxpy_record

    # as examples/particles.py:29-46 builds it
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


def _ref_particle_state(ex, n):
    from repro.kernels.particle.ops import PARTICLE_SPEC
    from repro.kernels.saxpy.kernel import SAXPY_SPEC

    f = workloads.particle_fields(n)
    specs = {"ions": PARTICLE_SPEC, "electrons": PARTICLE_SPEC,
             "field": SAXPY_SPEC}
    lays = {"ions": ref.Layout.AOS, "electrons": ref.Layout.AOSOA,
            "field": ref.Layout.SOA}
    return ex.init_state(**{
        k: ref.RecordArray.from_fields(
            specs[k], {fn: jnp.asarray(v) for fn, v in f[k].items()},
            lays[k])
        for k in specs})


def _ref_flux_graph(nx, ny, layout="SOA"):
    from repro.kernels.stencil.ops import make_flux_difference_graph
    from repro.physics.euler import EULER_SPEC

    u = ref.DistTensor("u", (nx, ny), spec=EULER_SPEC,
                       layout=ref.Layout[layout], halo=(1, 1),
                       boundary=ref.Boundary.TRANSMISSIVE)
    out = ref.DistTensor("flux", (nx, ny), spec=EULER_SPEC,
                         layout=ref.Layout[layout])
    return make_flux_difference_graph(u, out, 0.1, 0.1, overlap=False,
                                      use_pallas=True)


def _listing9(pkg, size=16):
    """Paper Listing 9 in either package: init to 4, subtract 1 until the
    sum hits 0.  ``r`` starts nonzero so the while loop enters."""
    full = jnp.full_like if pkg is ref else torch.full_like
    x = pkg.DistTensor("x", (size,))
    res = pkg.make_reduction_result("r", init=1.0)
    init = pkg.Graph(name="init")
    init.split(lambda xs: full(xs, 4.0), x, writes=(0,))
    map_reduce = pkg.Graph(name="map_reduce")
    map_reduce.split(lambda xs: xs - 1.0, x, writes=(0,))
    map_reduce.then_reduce(x, res, pkg.SumReducer())
    map_reduce.conditional(lambda state: state["r"] != 0.0)
    g = pkg.Graph()
    g.emplace(init)
    g.then(map_reduce)
    return g


def _dag_signature(dag):
    units = [(u.kind, u.level, sorted(u.reads), sorted(u.writes), u.barrier,
              u.segment, u.wave) for u in dag.units]
    edges = [(e.src, e.dst, e.reason, e.key) for e in dag.edges]
    return units, edges, list(dag.segment_kinds)


def _segment_signature(segments):
    """Segment kinds and, per device segment, the wave sizes."""
    return [(k, [len(w) for w in p] if k == "device" else None)
            for k, p in segments]


# -- schedule and plan parity ---------------------------------------------------

@pytest.mark.parametrize("graph", ["particles", "flux", "two_flux",
                                   "host_mid", "listing9", "eikonal_solve"])
@pytest.mark.parametrize("schedule", ["dag", "sequential"])
def test_schedule_and_plan_match_reference(graph, schedule):
    """Same units, edges, waves, segments, initial/per-segment layouts and
    relayout steps as the reference for the same graph."""
    from repro.kernels.stencil.ops import make_flux_difference_graph as rmk
    from repro_torch.kernels.stencil.ops import \
        make_flux_difference_graph as pmk

    def build(pkg, mk):
        from repro.physics.euler import EULER_SPEC as RE
        from repro_torch.physics.euler import EULER_SPEC as PE
        spec = RE if pkg is ref else PE
        if graph == "particles":
            return (_ref_particle_graph(1024) if pkg is ref else
                    workloads.build_particle_graph(1024)[0])
        if graph == "flux":
            return (_ref_flux_graph(32, 128) if pkg is ref else
                    workloads.build_flux_graph(32, 128)[0])
        if graph == "listing9":
            return _listing9(pkg)
        if graph == "eikonal_solve":
            from test_torch_eikonal import _ref_eikonal_graph
            return (_ref_eikonal_graph(64, 4, (8, 64), loop=True)
                    if pkg is ref else
                    workloads.build_eikonal_graph(64, block=(8, 64))[0])
        if graph == "two_flux":   # two kernels on separate levels
            g = pkg.Graph(name="two_flux")
            for i in range(2):
                u = pkg.DistTensor(f"u{i}", (16, 8), spec=spec,
                                   layout=pkg.Layout.SOA, halo=(1, 1))
                f = pkg.DistTensor(f"f{i}", (16, 8), spec=spec,
                                   layout=pkg.Layout.SOA)
                mk(u, f, 0.1, 0.1, overlap=False, graph=g)
                g.then()
            return g
        # a record preferred in different layouts on both sides of a host
        # node: two device segments and relayout steps between them
        r = pkg.DistTensor("r", (256,), spec=spec, layout=pkg.Layout.AOS)
        g = pkg.Graph(name="host_mid")
        g.split(lambda x: x, pkg.preferred_layout(r, pkg.Layout.AOSOA),
                writes=(0,))
        g.then(lambda x: None, exec_kind=pkg.ExecutionKind.Cpu, args=(r,))
        g.then_split(lambda x: x, pkg.preferred_layout(r, pkg.Layout.SOA),
                     writes=(0,))
        return g

    rex = ref.Executor(build(ref, rmk), schedule=schedule)
    pex = port.Executor(build(port, pmk), device="cpu", schedule=schedule)
    assert _dag_signature(pex.dag) == _dag_signature(rex.dag)
    assert _segment_signature(pex._segments) == \
        _segment_signature(rex._segments)
    name = lambda d: {k: v.name for k, v in d.items()}  # noqa: E731
    assert name(pex.plan.initial) == name(rex.plan.initial)
    assert [name(s) for s in pex.plan.per_segment] == \
        [name(s) for s in rex.plan.per_segment]
    assert [(s.segment, s.tensor, s.src.name, s.dst.name)
            for s in pex.plan.relayouts] == \
        [(s.segment, s.tensor, s.src.name, s.dst.name)
         for s in rex.plan.relayouts]
    regions_r = ref.group_regions(rex.dag.segment_kinds)
    regions_p = port.group_regions(pex.dag.segment_kinds)
    assert [(r.kind, r.start, r.stop) for r in regions_p] == \
        [(r.kind, r.start, r.stop) for r in regions_r]
    assert [(e.src, e.dst, e.reason, e.key)
            for e in port.region_dag(pex.dag, regions_p)] == \
        [(e.src, e.dst, e.reason, e.key)
         for e in ref.region_dag(rex.dag, regions_r)]
    assert port.region_waves(regions_p, port.region_dag(pex.dag, regions_p)) \
        == ref.region_waves(regions_r, ref.region_dag(rex.dag, regions_r))


def test_particle_dag_fuses_the_three_pushers():
    g, _, _ = workloads.build_particle_graph(1024)
    ex = port.Executor(g, device="cpu")
    fused = ex.dag.fused_antichains()
    assert len(fused) == 1 and len(fused[0]) == 3
    assert "antichain x3" in ex.describe_dag()


# -- the slice end to end --------------------------------------------------------

@pytest.mark.parametrize("schedule", ["dag", "sequential"])
def test_particle_graph_end_to_end_matches_reference(schedule):
    n, steps = 1024, 5
    rex = ref.Executor(_ref_particle_graph(n), schedule=schedule)
    init = _np_state(_ref_particle_state(rex, n))
    want = _np_state(rex.run(rex.init_state(**init), steps))

    g, (ions, electrons, field), _ = workloads.build_particle_graph(n)
    pex = port.Executor(g, device="cpu", schedule=schedule)
    state = state_from_reference(init, "cpu")
    got = pex.run(state, steps)
    assert set(got) == set(want) == {"ions", "electrons", "field", "vmax"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=F32_TOL,
                                   atol=F32_TOL)
    # the closed form x_T = x_0 + T dt v, as examples/particles.py checks
    f = workloads.particle_fields(n)
    for t, key in ((ions, "ions"), (electrons, "electrons")):
        np.testing.assert_allclose(
            pex.read(got, t).field("x").numpy(),
            f[key]["x"] + steps * workloads.DT * f[key]["v"],
            rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pex.read(got, field).field("y").numpy(),
                               steps * workloads.DT * f["field"]["x"],
                               rtol=1e-4, atol=1e-4)
    # the caller's state is never written in place
    for k, v in state_from_reference(init, "cpu").items():
        assert torch.equal(state[k], v)


@pytest.mark.parametrize("layout", ["AOS", "SOA"])
@pytest.mark.parametrize("schedule", ["dag", "sequential"])
def test_flux_graph_end_to_end_matches_reference(layout, schedule):
    from repro.physics.euler import shock_bubble_init

    rex = ref.Executor(_ref_flux_graph(32, 128, layout), schedule=schedule)
    init = _np_state(rex.init_state(u=shock_bubble_init(32, 128)))
    want = _np_state(rex(rex.init_state(**init)))
    g, _ = workloads.build_flux_graph(32, 128, layout=port.Layout[layout])
    pex = port.Executor(g, device="cpu", schedule=schedule)
    got = pex(state_from_reference(init, "cpu"))
    assert tuple(got["flux"].shape) == want["flux"].shape
    np.testing.assert_allclose(got["flux"].numpy(), want["flux"],
                               rtol=1e-4, atol=1e-4)


def test_saxpy_probe_graph_runs_both_variants():
    g, (x, y_bc, y_nbc) = workloads.build_saxpy_graph(1000, 2.0, block=256)
    ex = port.Executor(g, device="cpu")
    assert [len(w) for w in ex.dag.antichains()] == [2]
    xv = torch.arange(1000, dtype=torch.float32)
    st = ex.run(ex.init_state(x=xv), 3)
    for t in (y_bc, y_nbc):
        assert torch.equal(st[t.name], 3 * 2.0 * xv)


def test_interop_roundtrip_keeps_bits():
    rng = np.random.default_rng(0)
    state = {"a": np.asarray(jnp.asarray(rng.standard_normal((4, 8)),
                                         jnp.bfloat16)),
             "b": rng.standard_normal(5).astype(np.float32),
             "c": np.asarray(3.0, np.float32)}
    t = state_from_reference(state, "cpu")
    assert t["a"].dtype == torch.bfloat16 and tuple(t["a"].shape) == (4, 8)
    back = state_to_reference(t)
    for k in state:
        assert back[k].dtype == state[k].dtype
        assert back[k].shape == state[k].shape
        assert back[k].tobytes() == state[k].tobytes()


# -- executor behaviour ---------------------------------------------------------

def test_host_node_sees_updated_state_and_overrides_convert_layouts():
    seen = []
    r = port.DistTensor("r", (256,), spec=port.RecordSpec.create("a", "b"),
                        layout=port.Layout.AOS)
    g = port.Graph(name="host")
    g.split(lambda x: x.map_data(lambda d: d + 1.0), r, writes=(0,))
    g.then(lambda x: seen.append(x.field("a").clone()),
           exec_kind=port.ExecutionKind.Cpu, args=(r,))
    ex = port.Executor(g, device="cpu",
                       layout_overrides={"r": port.Layout.AOSOA})
    assert ex.plan.initial["r"] is port.Layout.AOSOA
    soa = port.RecordArray(torch.zeros(2, 256), r.spec, port.Layout.SOA)
    st = ex(ex.init_state(r=soa))
    assert torch.equal(seen[0], torch.ones(256))
    assert tuple(st["r"].shape) == (2, 2, 128)   # AoSoA storage
    ex2 = port.Executor(g, device="cpu",
                        segment_layout_overrides={0: {"r": port.Layout.SOA}})
    assert ex2.plan.per_segment[0]["r"] is port.Layout.SOA


def test_tile_overrides_reach_the_kernel_contract():
    g, _, _ = workloads.build_particle_graph(1024, block=None)
    ex = port.Executor(g, device="cpu", tile_overrides={"particle": 384})
    with pytest.raises(ValueError, match="tile by block=384"):
        ex(ex.init_state())
    ex = port.Executor(g, device="cpu", tile_overrides={"particle": 256})
    ex(ex.init_state())


_REDUCER_CASES = [
    (r, d) for r in ("Sum", "Max", "Min", "Mul", "Minimum", "Maximum", "And",
                     "Or", "Xor")
    for d in ("float_nan", "all_nan", "int", "bool")
    # the bitwise reducers take integer or boolean tensors only
    if not (r in ("And", "Or", "Xor") and d.endswith("nan"))]


@pytest.mark.parametrize("reducer,data", _REDUCER_CASES)
def test_reducers_match_reference(reducer, data):
    rng = np.random.default_rng(1)
    x = {"float_nan": np.where(rng.random(37) < 0.2, np.nan,
                               rng.standard_normal(37)).astype(np.float32),
         "all_nan": np.full(9, np.nan, np.float32),
         "int": rng.integers(-50, 50, 37).astype(np.int32),
         "bool": rng.random(37) < 0.7}[data]
    if reducer == "Mul" and data == "int":   # keep the product in int32
        x = np.where(x > 0, 1, -1).astype(np.int32)
    want = np.asarray(getattr(ref, f"{reducer}Reducer")().local(
        jnp.asarray(x)))
    got = getattr(port, f"{reducer}Reducer")().local(torch.from_numpy(x))
    np.testing.assert_allclose(got.double().numpy(), want.astype(np.float64),
                               rtol=1e-5, equal_nan=True)


def _record_field(layout, name, n=1024):
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC

    return port.RecordArray.create(PARTICLE_SPEC, (n,), layout=layout,
                                   device="cpu").field(name)


# name -> (the view, the device type it is routed for, the kernel's
# (rows, cols, row_stride, span read) or None for the torch route)
_ROUTE_CASES = {
    "aos_field_v": (lambda: _record_field(port.Layout.AOS, "v"), "cuda",
                    (1024, 3, 6, True)),
    "aos_field_x": (lambda: _record_field(port.Layout.AOS, "x"), "cuda",
                    (1024, 3, 6, True)),
    "soa_field": (lambda: _record_field(port.Layout.SOA, "v"), "cuda",
                  (1, 3072, 3072, True)),
    "aosoa_field": (lambda: _record_field(port.Layout.AOSOA, "v"), "cuda",
                    (1, 3072, 3072, True)),
    "contiguous_1d": (lambda: torch.zeros(4097), "cuda",
                      (1, 4097, 4097, True)),
    "contiguous_2d": (lambda: torch.zeros(64, 48), "cuda",
                      (1, 3072, 3072, True)),
    "zero_d": (lambda: torch.zeros(()), "cuda", (1, 1, 1, True)),
    "one_of_two_columns": (lambda: torch.zeros(100, 2)[:, 1], "cuda",
                           (100, 1, 2, True)),
    "padded_interior": (lambda: torch.zeros(66, 66)[1:-1, 1:-1], "cuda",
                        (64, 64, 66, True)),
    "rows_a_sector_apart": (lambda: torch.zeros(64, 256)[:, :4], "cuda",
                            (64, 4, 256, False)),
    "cpu": (lambda: torch.zeros(4097), "cpu", None),
    "int32": (lambda: torch.zeros(64, dtype=torch.int32), "cuda", None),
    "bool": (lambda: torch.zeros(64, dtype=torch.bool), "cuda", None),
    "bfloat16": (lambda: torch.zeros(64, dtype=torch.bfloat16), "cuda",
                 None),
    "float64": (lambda: torch.zeros(64, dtype=torch.float64), "cuda", None),
    "empty": (lambda: torch.zeros(0, 3), "cuda", None),
    "every_other_element": (lambda: torch.zeros(8, 6)[:, ::2], "cuda",
                            (24, 1, 2, True)),
    "strided_rows": (lambda: torch.zeros(8, 7)[:, ::2], "cuda", None),
    "three_dims_two_gaps": (lambda: torch.zeros(4, 6, 8)[:, :3, :5], "cuda",
                            None),
    "broadcast": (lambda: torch.zeros(4, 1).expand(4, 5), "cuda", None),
}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_max_min_route_follows_what_the_input_shows(case):
    """The NaN-ignoring max/min takes the hand-written kernel for a CUDA
    float32 view whose strides merge into rows of contiguous elements,
    read as one span where the gaps are under a 32-byte sector, and the
    torch route for everything else: a pure function of device type,
    dtype, shape and strides."""
    from repro_torch.kernels.reduce.kernel import kernel_geometry

    make, device_type, want = _ROUTE_CASES[case]
    x = make()
    assert kernel_geometry(device_type, x.dtype, tuple(x.shape),
                           x.stride()) == want


def test_max_min_kernel_wrapper_refuses_what_it_does_not_take():
    """The kernel's wrapper raises on a tensor off the card, of another
    dtype or with no elements; it never falls back to torch."""
    from repro_torch.kernels.reduce.kernel import nan_ignoring_extremum_cuda

    for x in (torch.zeros(8), torch.zeros(8, dtype=torch.int32),
              torch.zeros(0)):
        with pytest.raises(ValueError, match="CUDA float32 view"):
            nan_ignoring_extremum_cuda(x, largest=True)
    assert nan_ignoring_extremum_cuda.launches == 0


def test_max_min_reducers_report_their_route(monkeypatch):
    """``Reducer.route`` says how ``local`` reduces a tensor: on the CPU
    the max and min take torch, as every other reducer does; where the
    kernel takes the view (``kernel_geometry``), the max and min report
    the kernel, unless the tensor requires grad under grad mode."""
    from repro_torch.kernels.reduce import ops

    x = torch.zeros(64)
    for reducer in (port.MaxReducer(), port.MinReducer(), port.SumReducer(),
                    port.MaximumReducer()):
        assert reducer.route(x) == "torch"
    monkeypatch.setattr(ops, "kernel_geometry",
                        lambda *a: (1, 64, 64, True))
    for reducer in (port.MaxReducer(), port.MinReducer()):
        assert reducer.route(x) == "kernel"
        assert reducer.route(x.requires_grad_()) == "torch"
        with torch.no_grad():
            assert reducer.route(x) == "kernel"
        x = x.detach()
    assert port.SumReducer().route(x) == "torch"


@pytest.mark.parametrize("graph", ["particle", "particle_diagnostic",
                                   "eikonal", "eikonal_route_kernel"])
def test_cache_stats_count_reductions_by_route(graph):
    """``cache_stats()`` counts the built pieces' reductions by the
    reducer's route: on the CPU the particle graphs' and the eikonal
    body's max each take torch, once a piece that holds it; a reducer
    that reports the kernel is counted as the kernel's."""
    if graph == "particle":
        g, _, _ = workloads.build_particle_graph(1024)
    elif graph == "particle_diagnostic":
        g, _, _ = workloads.build_particle_diagnostic_graph(
            1024, lambda t, v: None)
    else:
        g, _, _ = workloads.build_eikonal_graph(32, block=(8, 32))
    want = (0, 1)
    if graph == "eikonal_route_kernel":
        (node,) = [n for n in g.levels[0][0].subgraph.nodes()
                   if n.kind == "reduce"]
        node.reducer = dataclasses.replace(node.reducer,
                                           route=lambda x: "kernel")
        want = (1, 0)
    ex = port.Executor(g, device="cpu")
    ex.run(ex.init_state(), 2)
    stats = ex.cache_stats()
    assert (stats["reduce_kernel"], stats["reduce_torch"]) == want


def test_default_device_is_the_gpu():
    g, _, _ = workloads.build_particle_graph(1024)
    if torch.cuda.is_available():
        assert port.Executor(g).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.Executor(g)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.execute(g)


@pytest.mark.parametrize("builder", ["DistTensor.init", "RecordArray.create",
                                     "shock_bubble_init"])
def test_state_builders_default_to_the_gpu(builder):
    from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init

    build = {
        "DistTensor.init": lambda **kw: port.DistTensor(
            "u", (8, 4), spec=EULER_SPEC).init(**kw).data,
        "RecordArray.create": lambda **kw: port.RecordArray.create(
            EULER_SPEC, (8, 4), **kw).data,
        "shock_bubble_init": lambda **kw: shock_bubble_init(8, 4, **kw),
    }[builder]
    assert build(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


@pytest.mark.parametrize("use_kernel,launches", [(None, 1), (False, 0)])
def test_flux_graph_reaches_the_kernel_by_default(monkeypatch, use_kernel,
                                                  launches):
    """A flux graph built with the defaults sends a GPU record to the CUDA
    wrapper; only ``use_kernel=False`` asks for the plain version."""
    from repro_torch.kernels.stencil import ops
    from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init

    calls = []

    def fake_cuda(rec, lam_x, lam_y, out=None):
        calls.append(rec.layout)
        return ops.flux_difference_ref(rec, lam_x, lam_y, out=out)

    monkeypatch.setattr(ops, "on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "flux_difference_cuda", fake_cuda)
    u = port.DistTensor("u", (16, 8), spec=EULER_SPEC, halo=(1, 1))
    out = port.DistTensor("flux", (16, 8), spec=EULER_SPEC)
    kw = {} if use_kernel is None else {"use_kernel": use_kernel}
    g = ops.make_flux_difference_graph(u, out, 0.1, 0.1, **kw)
    ex = port.Executor(g, device="cpu")
    ex(ex.init_state(u=shock_bubble_init(16, 8, device="cpu")))
    assert len(calls) == launches


@pytest.mark.parametrize("option", ["mesh"])
def test_unported_options_raise_with_their_roadmap_item(option):
    """What is left of the mesh refuses with its ROADMAP item: region
    compile on a mesh over several cards ("mesh", item 8's 3(c); the
    refusal comes before any card is touched, and names the eager escape
    hatch), whether ``regions=True`` is named or the default."""
    t = port.DistTensor("p", (64,), partition=("d",))
    g = port.Graph(name="part").split(lambda x: x, t)
    mesh = port.Mesh({"d": 2}, ["cuda:0", "cuda:1"])
    for kw in ({"regions": True}, {}):
        with pytest.raises(NotImplementedError,
                           match="item 8, 3\\(c\\).*regions=False"):
            port.Executor(g, mesh=mesh, **kw)


# -- conditional loops (paper §5.3.6) ----------------------------------------

@pytest.mark.parametrize("schedule", ["dag", "sequential"])
def test_graph_conditional_map_reduce_paper_listing9(schedule):
    ex = port.Executor(_listing9(port), device="cpu", schedule=schedule)
    assert [k for k, _ in ex._segments] == ["device", "loop"]
    state = ex(ex.init_state())
    assert torch.equal(state["x"], torch.zeros(16))
    assert float(state["r"]) == 0.0


def test_graph_conditional_false_on_entry_runs_zero_times():
    """While semantics: a predicate false on entry runs the body no time;
    a satisfiable one iterates until it fails."""
    x = port.DistTensor("x", (8,))
    loop = port.Graph(name="never")
    loop.split(lambda xs: xs + 1.0, x, writes=(0,))
    loop.conditional(lambda state: state["go"] != 0.0)
    ex = port.Executor(port.Graph().emplace(loop), device="cpu")
    state = ex.init_state(x=torch.full((8,), 3.0))
    state["go"] = torch.tensor(0.0)
    assert torch.equal(ex(state)["x"], torch.full((8,), 3.0))

    count = port.Graph(name="until_five")
    count.split(lambda xs: xs + 1.0, x, writes=(0,))
    count.conditional(lambda s: s["x"][0] < 5.0)
    ex2 = port.Executor(port.Graph().emplace(count), device="cpu")
    st = ex2(ex2.init_state(x=torch.full((8,), 3.0)))
    assert torch.equal(st["x"], torch.full((8,), 5.0))


def test_graph_conditional_false_on_entry_host_loop():
    """The same guarantee for a loop whose body holds a host node."""
    x = port.DistTensor("x", (4,))
    seen = []
    loop = port.Graph(name="host_never")
    loop.split(lambda xs: xs + 1.0, x, writes=(0,))
    loop.sync(lambda: seen.append("ran"))
    loop.conditional(lambda state: state["go"] != 0.0)
    ex = port.Executor(port.Graph().emplace(loop), device="cpu")
    assert [k for k, _ in ex._segments] == ["host_loop"]
    state = ex.init_state()
    state["go"] = torch.tensor(0.0)
    state = ex(state)
    assert seen == [] and torch.equal(state["x"], torch.zeros(4))
    state["go"] = torch.tensor(1.0)
    loop.conditional(lambda s: s["x"][0] < 3.0)
    assert torch.equal(ex(state)["x"], torch.full((4,), 3.0))
    assert seen == ["ran"] * 3


@pytest.mark.parametrize("schedule", ["dag", "sequential"])
def test_loop_vertex_orders_conservatively(schedule):
    """A conditional subgraph reads the whole state (opaque predicate): it
    waits for every earlier writer and holds back later writers."""
    x = port.DistTensor("x", (8,))
    loop = port.Graph(name="dec")
    loop.split(lambda v: v - 1.0, x, writes=(0,))
    loop.conditional(lambda s: s["x"][0] > 0.0)
    g = port.Graph()
    g.split(lambda v: torch.full_like(v, 3.0), x, writes=(0,))
    g.then(loop)
    g.then_split(lambda v: v + 10.0, x, writes=(0,))
    ex = port.Executor(g, device="cpu", schedule=schedule)
    assert [k for k, _ in ex._segments] == ["device", "loop", "device"]
    st = ex(ex.init_state())
    assert torch.equal(st["x"], torch.full((8,), 10.0))


def test_loop_sub_executor_is_built_once_per_segment(monkeypatch):
    built = []
    real_init = port.Executor.__init__

    def counting_init(self, graph, *a, **kw):
        built.append(graph.name)
        real_init(self, graph, *a, **kw)

    g = _listing9(port)
    ex = port.Executor(g, device="cpu", tile_overrides={"eikonal": (8, 8)})
    monkeypatch.setattr(port.Executor, "__init__", counting_init)
    for _ in range(3):
        ex(ex.init_state())
    ex.run(ex.init_state(), 2)
    assert built == ["map_reduce"]
    sub = ex._sub_execs[1]
    assert sub.device == ex.device and sub.schedule == ex.schedule
    assert sub._tile_config == {"eikonal": (8, 8)}
    assert sub.graph.condition is not None and \
        [k for k, _ in sub._segments] == ["device"]


def test_loop_body_records_are_solved_with_the_enclosing_plan():
    """A record touched only inside a loop gets its layout from the outer
    plan (the solver walks loop bodies), and the body runs in it."""
    spec = port.RecordSpec.create("a", "b")
    r = port.DistTensor("r", (256,), spec=spec, layout=port.Layout.AOS)
    body = port.Graph(name="inc")
    body.split(lambda x: x.map_data(lambda d: d + 1.0),
               port.preferred_layout(r, port.Layout.AOSOA), writes=(0,))
    body.then_reduce(r, port.make_reduction_result("amax", init=-1.0),
                     port.MaxReducer(), field="a")
    body.conditional(lambda s: s["amax"] < 3.0)
    ex = port.Executor(port.Graph().emplace(body), device="cpu")
    assert ex.plan.per_segment == [{"r": port.Layout.AOSOA}]
    assert ex._sub_executor(0).plan.initial["r"] is port.Layout.AOSOA
    st = ex(ex.init_state())
    assert torch.equal(ex.read(st, r).field("a"), torch.full((256,), 3.0))


def test_loop_relayouts_count_on_the_enclosing_executor():
    """A loop whose body wants another layout than the segment before it:
    the conversion at the loop's entry counts once per pass on the
    executor the caller holds, however often the body runs, and the
    body's own count is folded into it."""
    spec = port.RecordSpec.create("a", "b")
    r = port.DistTensor("r", (256,), spec=spec, layout=port.Layout.AOS)
    body = port.Graph(name="inc")
    body.split(lambda x: x.map_data(lambda d: d + 1.0),
               port.preferred_layout(r, port.Layout.AOSOA), writes=(0,))
    body.then_reduce(r, port.make_reduction_result("amax", init=-1.0),
                     port.MaxReducer(), field="a")
    body.conditional(lambda s: s["amax"] < 3.0)
    g = port.Graph()
    g.split(lambda x: x.map_data(torch.zeros_like),
            port.preferred_layout(r, port.Layout.SOA), writes=(0,))
    g.then(body)
    ex = port.Executor(g, device="cpu", regions=False)
    assert [k for k, _ in ex._segments] == ["device", "loop"]
    assert ex.plan.relayouts == [port.RelayoutStep(1, "r", port.Layout.SOA,
                                                   port.Layout.AOSOA)]
    st = ex(ex.init_state())
    assert torch.equal(ex.read(st, r).field("a"), torch.full((256,), 3.0))
    # into the loop, and back to the initial layout at the end of the call
    assert ex.eager_relayouts == 2
    sub = ex._sub_execs[1]
    assert sub.eager_relayouts == 0   # three iterations, no conversion
    body_pass = sub._call_segments

    def converting_body_pass(state):  # a body that converts once a pass
        sub.eager_relayouts += 1
        return body_pass(state)

    sub._call_segments = converting_body_pass
    ex(ex.init_state())
    assert ex.eager_relayouts == 2 + 2 + 3
