"""The port's ``Executor`` at the JAX package's defaults (``regions=True,
donate=True``) and the reference's contract for a returned state, on the
CPU.

The contract, as the executor's module docstring states it: (1) the
caller's input is never written; (2) a returned state passed back is
donated (no copy in); (3) a returned state that is not passed back keeps
its values whatever later calls of this or another executor of the same
signature do; (4) an in-place write into a returned state before it is
passed back lands in the buffers.  Each case runs at the defaults and
with the flags named, and each is held against ``regions=False`` on the
same inputs, bit for bit.  Then the serve launcher's smoke checks (the
decode captured once, a fresh worker with no new decode capture) on the
smoke configs."""

import inspect

import numpy as np
import pytest
import torch

import repro_torch.core as port
from repro_torch import workloads
from repro_torch.core import Executor, Layout, RecordArray

N = 512
OPTS = [{}, {"regions": True, "donate": True}]
OPT_IDS = ["defaults", "named"]


@pytest.fixture(autouse=True)
def _fresh_cache():
    port.clear_executable_cache()
    yield
    port.clear_executable_cache()


def _particle(ex, seed=0):
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC

    f = workloads.particle_fields(N, seed)
    specs = {"ions": (PARTICLE_SPEC, Layout.AOS),
             "electrons": (PARTICLE_SPEC, Layout.AOSOA),
             "field": (SAXPY_SPEC, Layout.SOA)}
    return ex.init_state(**{
        k: RecordArray.from_fields(
            sp, {fn: torch.from_numpy(v) for fn, v in f[k].items()}, lay)
        for k, (sp, lay) in specs.items()})


def _graph():
    return workloads.build_particle_graph(N)[0]


def _copy(state):
    return {k: v.clone() for k, v in state.items()}


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _eager(g, state, steps):
    ex = Executor(g, device="cpu", regions=False)
    return ex.run(_copy(state), steps)


def _in_buffers(ex, state) -> bool:
    stores = {b.untyped_storage().data_ptr()
              for b in ex._cache.buffers.values()}
    return all(v.untyped_storage().data_ptr() in stores
               for v in state.values())


def test_shared_defaults_equal_the_reference_executors():
    """Every constructor parameter the two executors share has the same
    default (``regions=True, donate=True`` among them)."""
    import repro.core as ref

    mine = inspect.signature(Executor.__init__).parameters
    theirs = inspect.signature(ref.Executor.__init__).parameters
    shared = sorted((set(mine) & set(theirs)) - {"self", "graph"})
    assert {"regions", "donate", "async_regions", "tune", "schedule",
            "mesh", "host_timeout", "degrade"} <= set(shared)
    for name in shared:
        assert mine[name].default == theirs[name].default, name
    ex = Executor(_graph(), device="cpu")
    assert ex.regions and ex.donate and ex.async_regions


@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_contract_1_the_callers_input_is_never_written(opts):
    """K2 and K3 write their static buffers in place; the caller's state
    is copied in, never written, and what comes back lies in the
    buffers."""
    g = _graph()
    ex = Executor(g, device="cpu", **opts)
    s0 = _particle(ex)
    keep = _copy(s0)
    out = ex.run(s0, 3)
    _equal(s0, keep)
    assert _in_buffers(ex, out)
    _equal(out, _eager(g, keep, 3))


@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_contract_2_a_returned_state_passed_back_is_donated(opts):
    g = _graph()
    ex = Executor(g, device="cpu", **opts)
    s0 = _particle(ex)
    want = _eager(g, s0, 5)
    a = ex.run(s0, 2)
    ptrs = {k: v.data_ptr() for k, v in a.items()}
    b = ex.run(a, 3)
    assert all(b[k] is a[k] for k in a)        # the same aliases back
    assert {k: v.data_ptr() for k, v in b.items()} == ptrs
    assert ex.cache_stats()["moved_out"] == 0
    _equal(b, want)
    assert ex.cache_stats()["trace_events"] == 1


@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_contract_3_a_state_not_passed_back_keeps_its_values(opts):
    """``a = ex.run(s0, 1); ex.run(s0, 2)`` leaves ``a`` as it was: the
    second call moves it out onto a copy before it writes a buffer."""
    g = _graph()
    ex = Executor(g, device="cpu", **opts)
    s0 = _particle(ex)
    a = ex.run(s0, 1)
    a_was = _copy(a)
    b = ex.run(s0, 2)
    _equal(a, a_was)
    _equal(a, _eager(g, s0, 1))
    _equal(b, _eager(g, s0, 2))
    stats = ex.cache_stats()
    assert stats["moved_out"] == len(a)
    assert stats["moved_out_bytes"] == sum(v.numel() * v.element_size()
                                           for v in a.values())
    # ``a`` now lies outside the buffers: passing it on copies it in
    c = ex.run(a, 1)
    _equal(c, _eager(g, s0, 2))
    _equal(b, _eager(g, s0, 2))               # b was moved out in turn
    dropped = ex.run(s0, 1)
    del dropped                                # nobody holds it: no copy
    before = ex.cache_stats()["moved_out"]
    ex.run(s0, 1)
    assert ex.cache_stats()["moved_out"] == before


@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_contract_3_across_two_executors_of_one_signature(opts):
    """A second live executor of the signature reuses the first's graphs
    and buffers with zero captures, and the first's returned state keeps
    its values."""
    g = _graph()
    one = Executor(g, device="cpu", **opts)
    two = Executor(g, device="cpu", **opts)
    assert port.plan_signature(one) == port.plan_signature(two)
    s0, s1 = _particle(one), _particle(two, seed=1)
    a = one.run(s0, 1)
    a_was = _copy(a)
    builds = one.cache_stats()["trace_events"]
    b = two.run(s1, 2)
    assert two._cache is one._cache
    assert two.cache_stats()["trace_events"] == builds
    _equal(a, a_was)
    _equal(b, _eager(g, s1, 2))
    a = one.run(a, 1)                          # a, passed back: copied in
    _equal(a, _eager(g, s0, 2))
    _equal(b, _eager(g, s1, 2))


@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_contract_4_an_in_place_write_into_a_returned_state_lands(opts):
    g = _graph()
    ex = Executor(g, device="cpu", **opts)
    s0 = _particle(ex)
    a = ex.run(s0, 1)
    bumped = _copy(a)
    bumped["field"][0] += 1.0                  # SoA: the field's x
    a["field"][0] += 1.0
    ptr = a["field"].data_ptr()
    b = ex.run(a, 2)
    assert b["field"].data_ptr() == ptr         # no copy in
    _equal(b, _eager(g, bumped, 2))


def test_contract_3_on_a_mesh_moves_every_shard_out():
    mesh = port.make_mesh((2, 2), ("gx", "gy"), devices=["cpu"] * 4)
    g, (u, flux) = workloads.build_flux_graph(32, 32, mesh=mesh)
    from repro_torch.physics.euler import shock_bubble_init

    u0 = shock_bubble_init(32, 32, device="cpu")
    ex = Executor(g, mesh=mesh)
    a = ex.run(ex.init_state(u=u0), 1)
    assert isinstance(a["flux"], port.ShardedArray)
    a_was = {k: v.to_global().clone() for k, v in a.items()}
    b = ex.run(ex.init_state(u=2 * u0 - 1.0), 1)
    for k in a:
        assert torch.equal(a[k].to_global(), a_was[k]), k
    assert ex.cache_stats()["moved_out"] == 2 * 4
    eager = Executor(g, mesh=mesh, regions=False)
    want = eager.run(eager.init_state(u=2 * u0 - 1.0), 1)
    for k in want:
        assert torch.equal(b[k].to_global(), want[k].to_global()), k


def test_contract_3_with_host_callbacks_in_flight():
    """A host region between two device regions, on the host pool: the
    callbacks read the values of their own call, and an earlier returned
    state is left alone."""
    seen = []
    g, _, _ = workloads.build_particle_diagnostic_graph(
        N, lambda t, v: seen.append((t, v)))
    ex = Executor(g, device="cpu")
    assert ex.async_regions and any(r.kind == "host"
                                    for r in ex.plan.regions)
    s0 = _particle(ex)
    a = ex.run(s0, 3)
    a_was = _copy(a)
    first = list(seen)
    seen.clear()
    ex.run(s0, 3)
    _equal(a, a_was)
    assert seen == first
    eager = Executor(g, device="cpu", regions=False)
    seen.clear()
    _equal(a, eager.run(_copy(s0), 3))
    assert seen == first


def test_a_view_of_a_returned_tensor_passed_under_another_key_is_copied():
    """A returned tensor, or a view of one, passed in under another key is
    read before any buffer is written."""
    u = port.DistTensor("u", (8,))
    v = port.DistTensor("v", (8,))
    g = port.Graph()
    g.split(lambda b, a: a + b + 1.0, v, u)             # writes u
    g.then_split(lambda a, b: 2.0 * b - a, u, v)        # writes v
    ex = Executor(g, device="cpu")
    st = ex(ex.init_state(u=torch.arange(8.0), v=torch.ones(8)))
    inp = {"u": st["v"][:], "v": st["u"]}
    want = _eager(g, {k: x.clone() for k, x in inp.items()}, 1)
    _equal(ex(inp), want)


def _ions():
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC

    return port.DistTensor("ions", (N,), spec=PARTICLE_SPEC,
                           layout=Layout.AOS)


VIEWS = {
    "slice": lambda ex, st: st["ions"][1:4],
    "view": lambda ex, st: st["ions"].view(-1),
    "numpy": lambda ex, st: st["ions"].numpy(),
    "field": lambda ex, st: ex.read(st, _ions()).field("x"),
}


@pytest.mark.parametrize("kind", sorted(VIEWS))
@pytest.mark.parametrize("other", [False, True], ids=["same", "another"])
def test_contract_3_a_view_kept_of_a_returned_state_raises(kind, other):
    """A view of a returned tensor lies in the static buffer, which no move
    can re-point: a call that would move that state out (of this or
    another executor of the signature) raises, naming the key, and leaves
    the view as it was; once the view is gone the call goes through, and
    passing the state back (donating it) never raises."""
    g = _graph()
    ex = Executor(g, device="cpu")
    two = Executor(g, device="cpu") if other else ex
    s0 = _particle(ex)
    a = ex.run(s0, 1)
    view = VIEWS[kind](ex, a)
    kept = torch.as_tensor(view).clone()
    with pytest.raises(RuntimeError, match="'ions'.*view"):
        two.run(s0, 2)
    assert torch.equal(torch.as_tensor(view), kept)
    _equal(a, _eager(g, s0, 1))
    a = ex.run(a, 1)                      # passed back: donated, no raise
    del view
    b = two.run(s0, 2)
    _equal(b, _eager(g, s0, 2))


def test_contract_3_a_view_outliving_its_returned_state_raises():
    """The alias dropped, a view of it kept: the next call raises."""
    g = _graph()
    ex = Executor(g, device="cpu")
    s0 = _particle(ex)
    view = ex.run(s0, 1)["electrons"][0]
    kept = view.clone()
    with pytest.raises(RuntimeError, match="'electrons'"):
        ex.run(s0, 2)
    assert torch.equal(view, kept)
    del view
    _equal(ex.run(s0, 2), _eager(g, s0, 2))


def test_an_out_buffer_in_another_layout_than_its_input_is_copied_back():
    """``u`` AoS and ``flux`` SoA under regions: the executor does not hand
    the flux node a buffer stored unlike its input (the kernel writes
    ``out`` in its input's layout); the output is copied back and the
    state equals the eager run's."""
    from repro_torch.physics.euler import shock_bubble_init

    g, (u, flux) = workloads.build_flux_graph(16, 16)
    over = {"u": Layout.AOS, "flux": Layout.SOA}
    ex = Executor(g, device="cpu", layout_overrides=over)
    eager = Executor(g, device="cpu", layout_overrides=over, regions=False)
    u0 = shock_bubble_init(16, 16, device="cpu")
    got = ex.run(ex.init_state(u=u0), 2)
    want = eager.run(eager.init_state(u=u0), 2)
    _equal(got, want)
    assert ex.cache_stats()["copy_backs"] == 1
    same = Executor(g, device="cpu")
    same.run(same.init_state(u=u0), 1)
    assert same.cache_stats()["copy_backs"] == 0


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-130m"])
def test_serve_smoke_checks_one_decode_capture_and_a_fresh_worker(
        arch, capsys):
    """``launch/serve.py --smoke`` at the defaults: streams equal the
    uniform loop's, the decode step captured once (on the CPU: built
    once), and a fresh worker served with zero new decode captures."""
    from repro_torch.launch import serve

    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "6"])
    out = capsys.readouterr().out
    assert "[smoke] ripple == legacy argmax sequences  OK" in out
    assert "[smoke] decode captured once across" in out
    assert "[smoke] fresh worker served with 0 new decode captures  OK" \
        in out
    assert np.asarray(gen).shape == (2, 6)
