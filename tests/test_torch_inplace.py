"""Outputs written in place under region compile, on the CPU.

The plain versions of K1-K5 take ``out=`` as the kernel wrappers do: a
tensor apart from the inputs, or (K1-K3) the updated input itself; every
such call is bit for bit the fresh-output call.  Under
``Executor(regions=True)`` a node that takes ``out=`` writes its key's
static buffer where the executor's rules allow it (no sibling on its
level reads the buffer, its own read of the buffer is marked
``in_place``, no other key holds the buffer), so the main-path graphs
copy nothing back at their ends (``cache_stats()``'s ``copy_backs``), and
every state still equals ``regions=False``'s bit for bit and the JAX
package's ``Executor(regions=True, donate=True)`` within the golden
tolerances (float32 1e-5, flux 1e-4; ``tests/test_kernel_golden.py``).
The served models' decode writes its caches in place too."""

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch import workloads
from repro_torch.core import (DistTensor, ExecutionKind, Executor, Graph,
                              Layout, RecordArray, in_place)
from repro_torch.interop import state_from_reference

from test_torch_regions import _equal, _main_path, _ref_saxpy_graph, \
    GRAPHS, N_FLAT, N_GRID

DTYPES = ["float32", "bfloat16"]
F32_TOL, FLUX_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _fresh_cache():
    port.clear_executable_cache()
    yield
    port.clear_executable_cache()


def _rand(*shape, dtype="float32", seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(getattr(torch, dtype))


# -- the plain versions' out= -------------------------------------------------

@pytest.mark.parametrize("mode", ["apart", "in place"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_saxpy_out_is_the_fresh_result(dtype, mode):
    from repro_torch.kernels.saxpy.ops import saxpy

    x, y = _rand(4099, dtype=dtype), _rand(4099, dtype=dtype, seed=1)
    want = saxpy(1.75, x, y)
    y0 = y.clone()
    out = y if mode == "in place" else torch.empty_like(y)
    got = saxpy(1.75, x, y, out=out)
    assert got is out and torch.equal(out, want)
    if mode == "apart":
        assert torch.equal(y, y0)


@pytest.mark.parametrize("mode", ["apart", "in place"])
@pytest.mark.parametrize("layout", list(Layout))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["saxpy_record", "particle_update"])
def test_record_kernels_out_is_the_fresh_result(kernel, dtype, layout, mode):
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC, \
        particle_update
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC, saxpy_record

    spec, fn, c = ((SAXPY_SPEC, saxpy_record, 2)
                   if kernel == "saxpy_record"
                   else (PARTICLE_SPEC, particle_update, 6))
    rec = RecordArray(_rand(c, 1024, dtype=dtype), spec,
                      Layout.SOA).with_layout(layout)
    want = fn(rec, 0.01, block=256)
    data0 = rec.data.clone()
    out = rec if mode == "in place" else RecordArray(
        torch.empty_like(rec.data), spec, layout)
    got = fn(rec, 0.01, block=256, out=out)
    assert got is out and torch.equal(out.data, want.data)
    if mode == "apart":
        assert torch.equal(rec.data, data0)


@pytest.mark.parametrize("layout", list(Layout))
@pytest.mark.parametrize("dtype", DTYPES)
def test_flux_out_is_the_fresh_result(dtype, layout):
    from repro_torch.core import Boundary, pad_boundary_only
    from repro_torch.kernels.stencil.ops import flux_difference
    from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init

    u = shock_bubble_init(16, 24, device="cpu").to(getattr(torch, dtype))
    for ax in (1, 2):
        u = pad_boundary_only(u, axis=ax, width=1,
                              boundary=Boundary.TRANSMISSIVE)
    rec = RecordArray(u, EULER_SPEC, Layout.SOA).with_layout(layout)
    want = flux_difference(rec, 0.1, 0.05)
    out = RecordArray(torch.empty_like(want.data), EULER_SPEC, layout)
    got = flux_difference(rec, 0.1, 0.05, out=out)
    assert got is out and torch.equal(out.data, want.data)


@pytest.mark.parametrize("inner", [1, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_eikonal_out_is_the_fresh_result(dtype, inner):
    from repro_torch.kernels.eikonal.ops import eikonal_fim_sweep

    g = torch.Generator().manual_seed(3)
    phi = torch.rand(18, 34, generator=g).to(getattr(torch, dtype))
    mask = torch.rand(16, 32, generator=g) < 0.05
    want = eikonal_fim_sweep(phi, mask, 1 / 16, inner=inner, block=(8, 16))
    out = torch.empty_like(want)
    got = eikonal_fim_sweep(phi, mask, 1 / 16, inner=inner, block=(8, 16),
                            out=out)
    assert got is out and torch.equal(out, want)


def test_out_that_overlaps_an_input_is_refused():
    """K1 may write over ``y`` but not over ``x``; K4 and K5 read their
    neighbours' cells, so their ``out`` lies apart from every input; an
    ``out`` of another shape, or half over an input, is refused."""
    from repro_torch.kernels.eikonal.ops import eikonal_fim_sweep
    from repro_torch.kernels.saxpy.ops import saxpy

    x, y = _rand(64), _rand(64, seed=1)
    with pytest.raises(ValueError, match="overlaps an input"):
        saxpy(2.0, x, y, out=x)
    both = _rand(96)
    with pytest.raises(ValueError, match="without being it"):
        saxpy(2.0, x, both[:64], out=both[32:])
    with pytest.raises(ValueError, match="the result is"):
        saxpy(2.0, x, y, out=torch.empty(63))
    phi = torch.rand(10, 10)
    with pytest.raises(ValueError, match="overlaps an input"):
        eikonal_fim_sweep(phi, torch.zeros(8, 8, dtype=torch.bool), 0.1,
                          inner=1, out=phi.view(-1)[:64].view(8, 8))


# -- region compile writes in place -------------------------------------------

@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("graph", GRAPHS)
def test_main_path_graphs_copy_nothing_back(graph, donate):
    """Every written key of the four graphs lands in its static buffer:
    no copy at a piece's end, the states equal ``regions=False``'s."""
    g, make, run = _main_path(graph)
    eager = Executor(g, device="cpu", regions=False)
    want = run(eager, make(eager))
    ex = Executor(g, device="cpu", regions=True, donate=donate)
    _equal(run(ex, make(ex)), want)
    stats = ex.cache_stats()
    assert stats["copy_backs"] == 0 and stats["copy_back_bytes"] == 0


@pytest.mark.parametrize("graph", GRAPHS)
def test_regions_match_reference_donated_regions(graph):
    """The port's in-place region path against the JAX package's
    ``Executor(regions=True, donate=True)`` on the same numpy inputs."""
    from test_torch_executor import _ref_particle_graph
    from test_torch_eikonal import _ref_eikonal_graph

    g, make, run = _main_path(graph)
    ex = Executor(g, device="cpu", regions=True, donate=True)
    init = {k: v.numpy() for k, v in make(ex).items()}
    got = run(ex, state_from_reference(init, "cpu"))
    tol = F32_TOL
    if graph == "saxpy":
        rex = ref.Executor(_ref_saxpy_graph(N_FLAT), regions=True,
                           donate=True)
        want = rex.run(rex.init_state(**init), 3)
    elif graph == "particle":
        rex = ref.Executor(_ref_particle_graph(N_FLAT), regions=True,
                           donate=True)
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
            regions=True, donate=True)
        want = rex.run(rex.init_state(**init), 3)
        tol = FLUX_TOL
    else:
        rex = ref.Executor(_ref_eikonal_graph(N_GRID, 4, (8, 64), loop=True),
                           regions=True, donate=True)
        want = rex(rex.init_state(**init))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy().astype(np.float64),
                                   w.astype(np.float64), rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("graph", GRAPHS)
def test_donate_false_leaves_the_callers_tensors_alone(graph):
    """With the kernels writing their buffers in place, a ``donate=False``
    call still never writes a tensor its caller passed in, nor one it
    returned before."""
    g, make, run = _main_path(graph)
    ex = Executor(g, device="cpu", regions=True)
    state = make(ex)
    kept = {k: v.clone() for k, v in state.items()}
    first = run(ex, state)
    again = {k: v.clone() for k, v in first.items()}
    run(ex, make(ex))
    _equal(state, kept)
    _equal(first, again)


def _sibling_graph(reader_first: bool):
    """Two nodes on one level: ``a <- a + 1`` (in place, marked) and
    ``b <- 2 a`` (a sibling that reads ``a``), in either order."""
    a, b = DistTensor("a", (64,)), DistTensor("b", (64,))
    bump = in_place(lambda x, out=None: torch.add(x, 1.0, out=out))
    double = in_place(lambda x, _y, out=None: torch.mul(x, 2.0, out=out))
    g = Graph(name="siblings")
    if reader_first:
        g.split(double, a, b)
        g.split(bump, a, writes=(0,))
    else:
        g.split(bump, a, writes=(0,))
        g.split(double, a, b)
    return g


@pytest.mark.parametrize("reader_first", [False, True])
@pytest.mark.parametrize("donate", [False, True])
def test_a_sibling_reader_keeps_the_level_snapshot(donate, reader_first):
    """Rule (i): a level runs against one snapshot, so a node whose key a
    sibling reads writes a new tensor, not the shared buffer."""
    g = _sibling_graph(reader_first)
    eager = Executor(g, device="cpu", regions=False)
    assert len(eager._segments[0][1][0]) == 2        # one level, two nodes
    a0 = torch.arange(64.0)
    want = eager.run(eager.init_state(a=a0), 3)
    ex = Executor(g, device="cpu", regions=True, donate=donate)
    _equal(ex.run(ex.init_state(a=a0), 3), want)
    assert torch.equal(want["b"], 2.0 * (a0 + 2.0))
    # b lands in its buffer; a's new tensor is copied into a's
    assert ex.cache_stats()["copy_backs"] == 1


def test_an_unmarked_node_reading_its_key_gets_no_buffer():
    """Rule (ii): a node that reads the key it writes takes its buffer
    only when marked ``in_place``; unmarked, it writes a new tensor that
    is copied back, with the same result."""
    a = DistTensor("a", (64,))
    seen = []

    def shift(x, out=None):
        seen.append(out)
        return torch.roll(x, 1) if out is None else \
            out.copy_(torch.roll(x, 1))

    g = Graph().split(shift, a, writes=(0,))
    ex = Executor(g, device="cpu", regions=True)
    got = ex.run(ex.init_state(a=torch.arange(64.0)), 2)
    assert torch.equal(got["a"], torch.roll(torch.arange(64.0), 2))
    assert seen and all(o is None for o in seen)
    assert ex.cache_stats()["copy_backs"] == 1


def test_an_alias_of_the_buffer_keeps_it_from_a_writer():
    """Rule (iii): ``b`` holds ``a``'s value itself (an identity node), so
    a later write of ``a`` must not land in ``a``'s buffer."""
    a, b = DistTensor("a", (32,)), DistTensor("b", (32,))
    g = Graph()
    g.split(lambda x, _y: x, a, b)
    g.then_split(in_place(lambda x, out=None: torch.mul(x, 3.0, out=out)),
                 a, writes=(0,))
    a0 = torch.arange(32.0)
    eager = Executor(g, device="cpu", regions=False)
    want = eager(eager.init_state(a=a0))
    for donate in (False, True):
        ex = Executor(g, device="cpu", regions=True, donate=donate)
        got = ex(ex.init_state(a=a0))
        _equal(got, want)
        assert torch.equal(got["b"], a0)


@pytest.mark.parametrize("donate", [False, True])
def test_async_callback_sees_the_value_of_its_step(donate):
    """The particle step's host diagnostic reads ``vmax`` and ``t``, both
    written in place by the next step's graph: each call sees its own
    step's values, as eagerly."""
    from test_torch_regions import _particle_state

    logs = {}
    for mode in ("eager", "regions"):
        got = logs[mode] = []

        class Record:
            def __call__(self, t, v):
                got.append((t, v))

        g, _, _ = workloads.build_particle_diagnostic_graph(
            N_FLAT, Record(), block=256)
        opts = {} if mode == "eager" else {"regions": True,
                                           "donate": donate}
        ex = Executor(g, device="cpu", **opts)
        st = ex.run(_particle_state(ex), 5)
        if mode == "regions":
            assert ex.cache_stats()["copy_backs"] == 0
    assert logs["regions"] == logs["eager"] and len(logs["eager"]) == 5
    assert len({t for t, _ in logs["eager"]}) == 5


def _decode_stats(tc, tp, prompts, want_n, opts):
    from repro_torch.runtime.batcher import Batcher

    b = Batcher(tc, tp, batch=2, max_seq=20, executor_opts=opts,
                log=lambda *_: None)
    reqs = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, want_n)]
    b.run()
    return [r.generated for r in reqs], b


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-130m", "gemma3-12b"])
def test_decode_writes_its_caches_in_place(arch):
    """The decode graph under ``regions=True, donate=True`` at the smoke
    config: the same streams as eagerly; the caches are the static
    buffers the step writes (no cache copied at the graph's end: what is
    copied back a step is less than one layer's cache)."""
    import repro_torch.configs as tconfigs
    from repro_torch.models.lm import init_lm

    tc = tconfigs.get_smoke(arch)
    tp = init_lm(tc, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, tc.vocab_size, (n,)).astype(np.int32)
               for n in (3, 5, 4)]
    want_n = (4, 3, 5)
    eager, _ = _decode_stats(tc, tp, prompts, want_n, {"regions": False})
    got, b = _decode_stats(tc, tp, prompts, want_n,
                           {"regions": True, "donate": True})
    assert got == eager
    stats = b.cache_stats()["decode"]
    caches = {t.name: b.state[t.name] for s in b.dg.slots for t in s.tensors}
    bufs = {v.data_ptr() for v in b.executor._cache.buffers.values()}
    layer = min(sum(b.state[t.name].numel() * b.state[t.name].element_size()
                    for t in s.tensors) for s in b.dg.slots)
    assert all(v.data_ptr() in bufs for v in caches.values())
    assert stats["copy_back_bytes"] < layer
    if arch != "mamba2-130m":   # only the residual h goes through a copy
        h = b.state["h"]
        assert stats["copy_back_bytes"] == h.numel() * h.element_size()


# -- sharded keys: the buffers of a partitioned tensor ------------------------

def test_a_donated_sharded_state_passed_back_swapped():
    """Two partitioned keys of a CPU mesh: a donated state's shard buffers
    handed back under each other's keys read as given."""
    mesh = port.make_mesh((2,), ("d",), devices=["cpu"] * 2)
    a = DistTensor("a", (16,), partition=("d",))
    b = DistTensor("b", (16,), partition=("d",))
    g = Graph()
    g.then(in_place(lambda x, y, out=None: (torch.sub(x, 3.0),
                                            torch.add(y, y))),
           args=(a, b), writes=(0, 1))
    ex = Executor(g, mesh=mesh, regions=True, donate=True)
    eager = Executor(g, mesh=mesh, regions=False)
    st = ex(ex.init_state(a=torch.arange(16.0), b=-torch.arange(16.0)))
    assert isinstance(st["a"], port.ShardedArray)
    inp = {"a": st["b"], "b": st["a"]}
    want = eager(eager.init_state(a=inp["a"].to_global(),
                                  b=inp["b"].to_global()))
    got = ex(inp)
    for t in (a, b):
        assert torch.equal(ex.read(got, t), eager.read(want, t))


def test_state_of_another_sharding_is_refused():
    mesh = port.make_mesh((2,), ("d",), devices=["cpu"] * 2)
    a = DistTensor("a", (16,), partition=("d",))
    g = Graph().split(lambda x: x + 1.0, a, writes=(0,))
    ex = Executor(g, mesh=mesh, regions=True)
    ex(ex.init_state())
    with pytest.raises(ValueError, match="region was built for"):
        ex({"a": torch.zeros(16)})


def test_host_node_on_the_cpu_path_runs_between_pieces():
    """A host node between two device regions of a CPU mesh reads the
    gathered value of its step (async and sync)."""
    mesh = port.make_mesh((2, 2), ("gx", "gy"), devices=["cpu"] * 4)
    u = DistTensor("u", (8, 8), partition=("gx", "gy"))
    seen = {}
    for async_regions in (False, True):
        got = seen[async_regions] = []
        g = Graph()
        g.split(in_place(lambda x, out=None: torch.add(x, 1.0, out=out)),
                u, writes=(0,))
        g.then(lambda x: got.append(float(x.sum())),
               exec_kind=ExecutionKind.Cpu, args=(u,))
        g.then_split(in_place(lambda x, out=None: torch.mul(x, 2.0,
                                                            out=out)),
                     u, writes=(0,))
        ex = Executor(g, mesh=mesh, regions=True, donate=True,
                      async_regions=async_regions)
        st = ex.run(ex.init_state(u=torch.zeros(8, 8)), 3)
        assert torch.equal(ex.read(st, u), torch.full((8, 8), 14.0))
    assert seen[False] == seen[True] == [64.0, 192.0, 448.0]
