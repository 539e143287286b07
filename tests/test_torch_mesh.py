"""The port's executor on a mesh against the JAX package's.

The JAX side runs once for the module, in one subprocess with 8 fake CPU
devices (``conftest.run_subprocess_devices``): the halo/overlap cases of
``tests/test_distributed.py`` (the 1-D halo exchange, the 2-D corners
under every boundary policy, the Euler solver split and unsplit, the
flux and eikonal graph functions, the thin-shard fallback) and the plan
cases of ``tests/test_overlap_schedule.py``.  It saves its states, its
inputs and a summary of each plan (``halo_transfers``: segment, tensor,
phase, block, mesh axis, width, overlapped, bytes; ``overlap_fallbacks``:
segment and reason; whether a warning was raised) to an ``.npz``.  The
port runs the same graphs on a CPU mesh of as many shards
(``make_mesh(..., devices=["cpu"] * k)``) and is held to them at the
reference tests' tolerances: the 1-D exchange exactly, the corners and
the graph functions at rtol 1e-5 (atol 1e-5 for the corners, 1e-6 for
the rest), the Euler states at rtol 1e-5, atol 1e-6; the plans equal.
Then the port alone: a mesh run against the unsharded run of the same
graph (bit for bit where each shard computes the same cells from the
same values; a sum over shards folds in another order, so within
float32 1e-6 relative), a conditional loop over partitioned tensors, the
mesh's placement helpers and its refusals."""

import gc
import json
import warnings

import numpy as np
import pytest
import torch

from conftest import run_subprocess_devices

import repro_torch.core as port
from repro_torch import workloads
from repro_torch.core import make_mesh
from repro_torch.kernels.eikonal.ops import make_eikonal_graph
from repro_torch.kernels.stencil.ops import make_flux_difference_graph
from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init

JAX_SIDE = r'''
import json, os, sys, warnings
import numpy as np, jax, jax.numpy as jnp, repro
from repro.core import (Boundary, DistTensor, Executor, Graph, Layout,
                        concurrent_padded_access, make_mesh)
from repro.kernels.stencil.ops import make_flux_difference_graph
from repro.kernels.eikonal.ops import make_eikonal_graph
from repro.physics.euler import EULER_SPEC, shock_bubble_init

src_dir = os.path.dirname(os.path.dirname(os.path.abspath(repro.__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(src_dir), "examples"))
from euler2d import build_solver

arrays = {}

def build(g, mesh=None):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ex = Executor(g, mesh=mesh)
    return ex, any("falls back to synchronous" in str(x.message) for x in w)

def summary(ex, warned):
    return {"transfers": [[h.segment, h.tensor, h.phase,
                           [list(b) for b in h.block], h.mesh_axis, h.width,
                           h.overlapped, h.nbytes]
                          for h in ex.plan.halo_transfers],
            "fallbacks": [[f.segment, f.reason]
                          for f in ex.plan.overlap_fallbacks],
            "warned": warned}

out_plans = {}

def diff(s, d):
    return s[2:] - s[:-2]

# test_distributed.py:11 -- 1-D exchange on 4 shards
mesh = make_mesh((4,), ("gx",))
src = DistTensor("src", (64,), partition=("gx",), halo=(1,),
                 boundary=Boundary.TRANSMISSIVE)
dst = DistTensor("dst", (64,), partition=("gx",))
x0 = jnp.arange(64, dtype=jnp.float32) ** 2
for overlap in (False, True):
    g = Graph()
    g.split(diff, concurrent_padded_access(src), dst, overlap=overlap)
    ex, warned = build(g, mesh)
    out_plans[f"halo1d-{overlap}"] = summary(ex, warned)
    arrays[f"halo1d-{overlap}"] = np.asarray(ex(ex.init_state(src=x0))["dst"])

# test_distributed.py:36 -- 2-D corners, every policy, 4 x 2
def sten(s, d):
    n0, n1 = s.shape[0] - 2, s.shape[1] - 4
    out = 0.0
    for di in range(3):
        for dj in range(5):
            out = out + (di + 1) * (dj + 1) * s[di:di + n0, dj:dj + n1]
    return out

mesh = make_mesh((4, 2), ("gx", "gy"))
x0 = np.random.default_rng(0).standard_normal((16, 12)).astype(np.float32)
arrays["corners-x0"] = x0
for boundary in Boundary:
    src = DistTensor("src", (16, 12), partition=("gx", "gy"), halo=(1, 2),
                     boundary=boundary, boundary_constant=3.5)
    dst = DistTensor("dst", (16, 12), partition=("gx", "gy"))
    for overlap in (False, True):
        g = Graph()
        g.split(sten, concurrent_padded_access(src), dst, overlap=overlap)
        ex, warned = build(g, mesh)
        key = f"corners-{boundary.name}-{overlap}"
        out_plans[key] = summary(ex, warned)
        arrays[key] = np.asarray(ex(ex.init_state(src=jnp.asarray(x0)))["dst"])

# test_distributed.py:89 -- the Euler solver on 8 devices, px = 2
U0 = shock_bubble_init(64, 32)
arrays["euler-U0"] = np.asarray(U0)
for unsplit in (False, True):
    for overlap in (False, True):
        ex, u = build_solver(64, 32, n_devices=8, px=2, overlap=overlap,
                             unsplit=unsplit)
        key = f"euler-{unsplit}-{overlap}"
        out_plans[key] = summary(ex, False)
        if not overlap:
            st = ex.run(ex.init_state(u=U0), steps=5)
            arrays[key] = np.asarray(st["u"])
            arrays[key + "-smax"] = np.asarray(st["smax"])
            arrays[key + "-mass"] = np.asarray(st["mass"])

# test_distributed.py:126 -- the kernel graph functions on (2, 4)
mesh = make_mesh((2, 4), ("gx", "gy"))
u = DistTensor("u", (32, 16), spec=EULER_SPEC, layout=Layout.SOA,
               partition=("gx", "gy"), halo=(1, 1),
               boundary=Boundary.TRANSMISSIVE)
du = DistTensor("du", (32, 16), spec=EULER_SPEC, layout=Layout.SOA,
                partition=("gx", "gy"))
U0 = shock_bubble_init(32, 16)
arrays["flux-U0"] = np.asarray(U0)
for overlap in (False, True):
    g = make_flux_difference_graph(u, du, 0.1, 0.2, overlap=overlap)
    ex, warned = build(g, mesh)
    out_plans[f"flux-{overlap}"] = summary(ex, warned)
    arrays[f"flux-{overlap}"] = np.asarray(ex(ex.init_state(u=U0))["du"])
phi0 = jnp.full((32, 16), 10.0).at[16, 8].set(0.0)
mask0 = jnp.zeros((32, 16), bool).at[16, 8].set(True)
phi = DistTensor("phi", (32, 16), partition=("gx", "gy"), halo=(1, 1))
mask = DistTensor("mask", (32, 16), dtype=jnp.bool_, partition=("gx", "gy"))
for overlap in (False, True):
    g = make_eikonal_graph(phi, mask, 1.0 / 32, overlap=overlap)
    ex, warned = build(g, mesh)
    out_plans[f"eikonal-{overlap}"] = summary(ex, warned)
    st = ex.run(ex.init_state(phi=phi0, mask=mask0), steps=6)
    arrays[f"eikonal-{overlap}"] = np.asarray(st["phi"])

# test_distributed.py:182 -- shards too thin for boundary strips
mesh = make_mesh((8,), ("gx",))
src = DistTensor("src", (16,), partition=("gx",), halo=(1,))
dst = DistTensor("dst", (16,), partition=("gx",))
for overlap in (False, True):
    g = Graph()
    g.split(diff, concurrent_padded_access(src), dst, overlap=overlap)
    ex, warned = build(g, mesh)
    out_plans[f"thin-{overlap}"] = summary(ex, warned)
    x0 = jnp.arange(16, dtype=jnp.float32) ** 2
    arrays[f"thin-{overlap}"] = np.asarray(ex(ex.init_state(src=x0))["dst"])

# test_overlap_schedule.py:89-150 -- plans without a mesh or on one shard
def stencil_graph(overlap, partition=()):
    src = DistTensor("src", (8, 6), partition=partition, halo=(1, 1))
    dst = DistTensor("dst", (8, 6), partition=partition)
    def s2(s, d):
        return s[2:, 2:][:8, :6]
    g = Graph()
    g.split(s2, concurrent_padded_access(src), dst, overlap=overlap)
    return g

x0 = np.arange(48.0, dtype=np.float32).reshape(8, 6)   # donated: numpy
for overlap in (False, True):
    ex, warned = build(stencil_graph(overlap))
    out_plans[f"nomesh-{overlap}"] = summary(ex, warned)
    arrays[f"nomesh-{overlap}"] = np.asarray(ex(ex.init_state(src=x0))["dst"])
mesh1 = make_mesh((1,), ("gx",))
ex, warned = build(stencil_graph(True, ("gx", None)), mesh1)
out_plans["single-shard"] = summary(ex, warned)
x = DistTensor("x", (8,), partition=("gx",))
g = Graph()
g.split(lambda xs: xs + 1.0, x, writes=(0,), overlap=True)
ex, warned = build(g, mesh1)
out_plans["no-padded"] = summary(ex, warned)
ex, warned = build(g, mesh1)
out_plans["no-padded-again"] = summary(ex, warned)

np.savez(OUT, plans=json.dumps(out_plans), **arrays)
print("OK")
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "jax_side.npz")
    run_subprocess_devices(f"OUT = {path!r}\n" + JAX_SIDE, timeout=900)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    data["plans"] = json.loads(str(data["plans"]))
    return data


def _mesh(shape, names):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _build(g, mesh=None):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ex = port.Executor(g, device=None if mesh else "cpu", mesh=mesh)
    return ex, any("falls back to synchronous" in str(x.message) for x in w)


def _summary(ex, warned):
    return {"transfers": [[h.segment, h.tensor, h.phase,
                           [list(b) for b in h.block], h.mesh_axis, h.width,
                           h.overlapped, h.nbytes]
                          for h in ex.plan.halo_transfers],
            "fallbacks": [[f.segment, f.reason]
                          for f in ex.plan.overlap_fallbacks],
            "warned": warned}


def _diff(s, d):
    return s[2:] - s[:-2]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- test_distributed.py's halo/overlap cases ---------------------------------

@pytest.mark.parametrize("overlap", [False, True])
def test_halo_exchange_1d(jax_side, overlap):
    mesh = _mesh((4,), ("gx",))
    src = port.DistTensor("src", (64,), partition=("gx",), halo=(1,),
                          boundary=port.Boundary.TRANSMISSIVE)
    dst = port.DistTensor("dst", (64,), partition=("gx",))
    g = port.Graph()
    g.split(_diff, port.concurrent_padded_access(src), dst, overlap=overlap)
    ex, warned = _build(g, mesh)
    st = ex(ex.init_state(src=torch.arange(64, dtype=torch.float32) ** 2))
    got = ex.read(st, dst).numpy()
    np.testing.assert_allclose(got, jax_side[f"halo1d-{overlap}"])
    xp = np.pad(np.arange(64, dtype=np.float64) ** 2, 1, mode="edge")
    np.testing.assert_allclose(got, xp[2:] - xp[:-2])
    assert _summary(ex, warned) == jax_side["plans"][f"halo1d-{overlap}"]
    assert isinstance(st["dst"], port.ShardedArray)
    assert [s.shape for s in st["dst"].shards] == [(16,)] * 4


def _sten(s, d):
    n0, n1 = s.shape[0] - 2, s.shape[1] - 4
    out = 0.0
    for di in range(3):
        for dj in range(5):
            out = out + (di + 1) * (dj + 1) * s[di:di + n0, dj:dj + n1]
    return out


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("boundary", list(port.Boundary))
def test_halo_corners_2d_all_policies(jax_side, boundary, overlap):
    mesh = _mesh((4, 2), ("gx", "gy"))
    src = port.DistTensor("src", (16, 12), partition=("gx", "gy"),
                          halo=(1, 2), boundary=boundary,
                          boundary_constant=3.5)
    dst = port.DistTensor("dst", (16, 12), partition=("gx", "gy"))
    g = port.Graph()
    g.split(_sten, port.concurrent_padded_access(src), dst, overlap=overlap)
    ex, warned = _build(g, mesh)
    got = ex.read(ex(ex.init_state(src=_t(jax_side["corners-x0"]))), dst)
    key = f"corners-{boundary.name}-{overlap}"
    np.testing.assert_allclose(got.numpy(), jax_side[key], rtol=1e-5,
                               atol=1e-5)
    ht = ex.plan.transfers_for_segment(0)
    assert any(h.mesh_axis == "gx" for h in ht)
    assert any(h.mesh_axis == "gy" for h in ht)
    assert any(len(h.block) == 2 for h in ht)
    assert all(h.overlapped == overlap for h in ht)
    assert _summary(ex, warned) == jax_side["plans"][key]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("unsplit", [False, True])
def test_euler_2d_overlap_matches_reference(jax_side, unsplit, overlap):
    mesh = _mesh((2, 4), ("gx", "gy"))
    ex, u = workloads.build_euler_solver(64, 32, mesh=mesh, overlap=overlap,
                                         unsplit=unsplit)
    st = ex.run(ex.init_state(u=_t(jax_side["euler-U0"])), steps=5)
    key = f"euler-{unsplit}-False"
    np.testing.assert_allclose(ex.read(st, u).data.numpy(), jax_side[key],
                               rtol=1e-5, atol=1e-6)
    assert float(st["smax"]) == pytest.approx(float(jax_side[key + "-smax"]),
                                              rel=1e-5)
    assert float(st["mass"]) == pytest.approx(float(jax_side[key + "-mass"]),
                                              rel=1e-5)
    assert _summary(ex, False) == \
        jax_side["plans"][f"euler-{unsplit}-{overlap}"]
    if overlap:
        ht = ex.plan.halo_transfers
        assert any(h.overlapped and h.mesh_axis == "gx" for h in ht)
        assert any(h.overlapped and h.mesh_axis == "gy" for h in ht)
        if unsplit:
            assert any(h.overlapped and len(h.block) == 2 for h in ht)
        assert not ex.plan.overlap_fallbacks


@pytest.mark.parametrize("overlap", [False, True])
def test_kernel_graphs_2d(jax_side, overlap):
    mesh = _mesh((2, 4), ("gx", "gy"))
    u = port.DistTensor("u", (32, 16), spec=EULER_SPEC,
                        layout=port.Layout.SOA, partition=("gx", "gy"),
                        halo=(1, 1), boundary=port.Boundary.TRANSMISSIVE)
    du = port.DistTensor("du", (32, 16), spec=EULER_SPEC,
                         layout=port.Layout.SOA, partition=("gx", "gy"))
    g = make_flux_difference_graph(u, du, 0.1, 0.2, overlap=overlap)
    ex, warned = _build(g, mesh)
    st = ex(ex.init_state(u=_t(jax_side["flux-U0"])))
    np.testing.assert_allclose(ex.read(st, du).data.numpy(),
                               jax_side[f"flux-{overlap}"], rtol=1e-5,
                               atol=1e-6)
    assert _summary(ex, warned) == jax_side["plans"][f"flux-{overlap}"]

    phi0 = torch.full((32, 16), 10.0)
    phi0[16, 8] = 0.0
    mask0 = torch.zeros((32, 16), dtype=torch.bool)
    mask0[16, 8] = True
    phi = port.DistTensor("phi", (32, 16), partition=("gx", "gy"),
                          halo=(1, 1))
    mask = port.DistTensor("mask", (32, 16), dtype=torch.bool,
                           partition=("gx", "gy"))
    g = make_eikonal_graph(phi, mask, 1.0 / 32, overlap=overlap)
    ex, warned = _build(g, mesh)
    st = ex.run(ex.init_state(phi=phi0, mask=mask0), steps=6)
    got = ex.read(st, phi).numpy()
    np.testing.assert_allclose(got, jax_side[f"eikonal-{overlap}"],
                               rtol=1e-5, atol=1e-6)
    assert (got < 10.0).mean() > 0.1
    assert _summary(ex, warned) == jax_side["plans"][f"eikonal-{overlap}"]


def test_overlap_small_shard_warns_and_falls_back(jax_side):
    mesh = _mesh((8,), ("gx",))
    src = port.DistTensor("src", (16,), partition=("gx",), halo=(1,))
    dst = port.DistTensor("dst", (16,), partition=("gx",))
    outs = {}
    for overlap in (False, True):
        g = port.Graph()
        g.split(_diff, port.concurrent_padded_access(src), dst,
                overlap=overlap)
        ex, warned = _build(g, mesh)
        assert warned == overlap
        if overlap:
            assert len(ex.plan.overlap_fallbacks) == 1
            assert "shard extent" in ex.plan.overlap_fallbacks[0].reason
        assert _summary(ex, warned) == jax_side["plans"][f"thin-{overlap}"]
        x0 = torch.arange(16, dtype=torch.float32) ** 2
        outs[overlap] = ex.read(ex(ex.init_state(src=x0)), dst).numpy()
        np.testing.assert_allclose(outs[overlap],
                                   jax_side[f"thin-{overlap}"])
    np.testing.assert_allclose(outs[True], outs[False])


# -- test_overlap_schedule.py's plan cases ------------------------------------

def _stencil_graph(overlap, partition=()):
    src = port.DistTensor("src", (8, 6), partition=partition, halo=(1, 1))
    dst = port.DistTensor("dst", (8, 6), partition=partition)

    def s2(s, d):
        return s[2:, 2:][:8, :6]

    g = port.Graph()
    g.split(s2, port.concurrent_padded_access(src), dst, overlap=overlap)
    return g


@pytest.mark.parametrize("overlap", [False, True])
def test_plans_without_a_mesh_match_the_reference(jax_side, overlap):
    ex, warned = _build(_stencil_graph(overlap))
    assert _summary(ex, warned) == jax_side["plans"][f"nomesh-{overlap}"]
    ht = ex.plan.transfers_for_segment(0)
    assert len(ht) == 8
    assert all(h.mesh_axis is None and not h.overlapped for h in ht)
    assert "fill" in ht[0].describe()
    assert ex.plan.describe_transfers().count("\n") >= 7
    if overlap:
        assert not warned
        assert "no mesh" in ex.plan.overlap_fallbacks[0].reason
    st = ex(ex.init_state(src=torch.arange(48.0).reshape(8, 6)))
    np.testing.assert_allclose(st["dst"].numpy(),
                               jax_side[f"nomesh-{overlap}"])


def test_single_shard_and_no_padded_arg_fallbacks(jax_side):
    mesh1 = _mesh((1,), ("gx",))
    ex, warned = _build(_stencil_graph(True, ("gx", None)), mesh1)
    assert _summary(ex, warned) == jax_side["plans"]["single-shard"]
    assert not warned
    x = port.DistTensor("x", (8,), partition=("gx",))
    g = port.Graph()
    g.split(lambda xs: xs + 1.0, x, writes=(0,), overlap=True)
    ex, warned = _build(g, mesh1)
    assert warned and _summary(ex, warned) == jax_side["plans"]["no-padded"]
    ex, warned = _build(g, mesh1)     # warned once per node
    assert not warned
    assert _summary(ex, warned) == jax_side["plans"]["no-padded-again"]


# -- the port alone: mesh runs against unsharded ones -------------------------

@pytest.mark.parametrize("layout", ["SOA", "AOS"])
@pytest.mark.parametrize("overlap", [False, True])
def test_flux_on_a_mesh_is_bitwise_the_unsharded_run(layout, overlap):
    """Each face is computed from the same two cells whatever the shard,
    so the mesh's flux equals the unsharded run's bit for bit."""
    mesh = _mesh((2, 2), ("gx", "gy"))
    lay = port.Layout[layout]
    g, (u, out) = workloads.build_flux_graph(16, 24, layout=lay, mesh=mesh,
                                             overlap=overlap)
    g0, _ = workloads.build_flux_graph(16, 24, layout=lay)
    u0 = shock_bubble_init(16, 24, device="cpu")
    ex, ex0 = port.Executor(g, mesh=mesh), port.Executor(g0, device="cpu")
    got = ex.read(ex.run(ex.init_state(u=u0), 2), out).data
    want = ex0.read(ex0.run(ex0.init_state(u=u0), 2), out).data
    assert torch.equal(got, want)
    assert not ex.plan.overlap_fallbacks
    assert any(h.overlapped == overlap and len(h.block) == 2
               for h in ex.plan.halo_transfers)


def test_eikonal_solve_loops_over_partitioned_tensors():
    """The conditional loop on a mesh: its predicate reads the max folded
    over the shards; with shards that are tile multiples every tile
    freezes the same halo cells, so the solve takes the same iterations
    and ends bit for bit at the unsharded one's phi."""
    mesh = _mesh((2, 4), ("gx", "gy"))
    inp = workloads.eikonal_inputs(32)
    runs = {}
    for m in (None, mesh):
        g, (phi, mask), conv = workloads.build_eikonal_graph(
            32, inner=4, block=(4, 8), mesh=m, max_iters=200)
        ex = port.Executor(g, device=None if m else "cpu", mesh=m)
        st = ex(ex.init_state(phi=torch.from_numpy(inp["phi"]),
                              mask=torch.from_numpy(inp["mask"])))
        runs[m is not None] = (ex.read(st, phi), conv.iterations,
                               float(st["res"]))
    assert runs[True][1] == runs[False][1] > 0
    assert runs[True][2] == runs[False][2] == 0.0
    assert torch.equal(runs[True][0], runs[False][0])


@pytest.mark.parametrize("reducer", ["SumReducer", "MaxReducer",
                                     "MinReducer", "MulReducer",
                                     "MaximumReducer", "OrReducer"])
def test_reductions_fold_the_shards(reducer):
    """A partitioned tensor's reduction folds the distinct shards'
    local results; a tensor split over one axis of a 2-axis mesh holds
    replicas over the other, which are not folded twice."""
    mesh = _mesh((2, 2), ("a", "b"))
    rng = np.random.default_rng(3)
    is_int = reducer == "OrReducer"
    x0 = (rng.integers(0, 64, (8, 6)).astype(np.int32) if is_int
          else rng.uniform(0.5, 1.5, (8, 6)).astype(np.float32))
    dtype = torch.int32 if is_int else torch.float32
    vals = {}
    for partition in ((), ("a", "b"), ("a", None)):
        t = port.DistTensor("t", (8, 6), dtype=dtype, partition=partition)
        r = port.make_reduction_result("r", dtype=dtype)
        g = port.Graph().reduce(t, r, getattr(port, reducer)())
        m = mesh if partition else None
        ex = port.Executor(g, device=None if m else "cpu", mesh=m)
        vals[partition] = ex(ex.init_state(t=torch.from_numpy(x0)))["r"]
    want = vals[()]
    for p in (("a", "b"), ("a", None)):
        if reducer in ("SumReducer", "MulReducer"):
            torch.testing.assert_close(vals[p], want, rtol=1e-6, atol=0)
        else:
            assert torch.equal(vals[p], want)


def test_exclusive_access_reads_the_pre_update_halo_per_shard():
    """Paper Fig. 9: a node that updates its padded input in place reads
    the neighbours' values from before the step on every shard."""
    mesh = _mesh((4,), ("d",))
    t = port.DistTensor("t", (16,), partition=("d",), halo=(1,),
                        boundary=port.Boundary.PERIODIC)
    g = port.Graph().split(lambda s: s[:-2] + s[2:],
                           port.exclusive_padded_access(t), writes=(0,))
    ex = port.Executor(g, mesh=mesh)
    x0 = torch.arange(16, dtype=torch.float32)
    got = ex.read(ex(ex.init_state(t=x0)), t)
    assert torch.equal(got, torch.roll(x0, 1) + torch.roll(x0, -1))


# -- placement, state and refusals --------------------------------------------

def test_sharded_state_round_trips_and_names_its_placement():
    mesh = _mesh((2, 2), ("gx", "gy"))
    u = port.DistTensor("u", (8, 6), spec=EULER_SPEC,
                        layout=port.Layout.AOS, partition=("gx", "gy"),
                        halo=(1, 1))
    out = port.DistTensor("out", (8, 6), spec=EULER_SPEC,
                          layout=port.Layout.AOS, partition=("gx", "gy"))
    g = port.Graph().split(lambda r, _o: port.RecordArray(
        r.data[1:-1, 1:-1] * 2.0, EULER_SPEC, port.Layout.AOS),
        port.concurrent_padded_access(u), out)
    ex = port.Executor(g, mesh=mesh)
    x = torch.randn(8, 6, 4)
    st = ex.init_state(u=port.RecordArray(x, EULER_SPEC, port.Layout.AOS))
    assert isinstance(st["u"], port.ShardedArray)
    assert st["u"].shards[3].shape == (4, 3, 4)
    assert torch.equal(st["u"].shards[3], x[4:, 3:])
    assert torch.equal(ex.read(st, u).data, x)
    st = ex(st)
    assert torch.equal(ex.read(st, out).data, x * 2.0)
    pl = ex.state_shardings(st)
    assert pl["u"].spec == ("gx", "gy", None)
    assert pl["out"].spec == ("gx", "gy", None)
    assert port.Placement(mesh, ("gx", None)).representatives() == [0, 2]
    again = ex.init_state(u=st["u"])
    assert torch.equal(ex.read(again, u).data, x)
    sa = port.ShardedArray.from_global(x, mesh, u)
    assert torch.equal(sa.to_global(), x)
    assert port.Executor(g, device="cpu").state_shardings({"u": 0}) == \
        {"u": None}


def test_a_shard_of_the_wrong_shape_is_refused():
    """A node whose shard outputs do not fit the written tensor's
    placement (here: split over one axis, computed over two) raises."""
    mesh = _mesh((2, 2), ("gx", "gy"))
    u = port.DistTensor("u", (8, 6), partition=("gx", "gy"))
    out = port.DistTensor("out", (8, 6), partition=("gx", None))
    g = port.Graph().split(lambda x, _o: x * 2.0, u, out)
    ex = port.Executor(g, mesh=mesh)
    with pytest.raises(ValueError, match="a shard of out came out"):
        ex(ex.init_state())


def test_validate_mesh_messages_match_the_reference():
    """The reference's checks only read ``mesh.shape``."""
    import repro.core as ref

    mesh = _mesh((2, 4), ("gx", "gy"))
    for kw in ({"partition": ("gz",)}, {"partition": ("gy",)},
               {"partition": ("gx",), "halo": (5,)},
               {"partition": (None, "gx"), "spec": "aosoa"},
               {"halo": (0, 1), "spec": "aosoa"}):
        kw = dict(kw)
        rec = kw.pop("spec", None)
        p = port.DistTensor("t", (6, 8), **kw)
        r = ref.DistTensor("t", (6, 8), **kw)
        if rec:
            p = p.with_(spec=port.RecordSpec.create("a", "b"),
                        layout=port.Layout.AOSOA)
            r = r.with_(spec=ref.RecordSpec.create("a", "b"),
                        layout=ref.Layout.AOSOA)
        with pytest.raises(ValueError) as pe:
            p.validate_mesh(mesh)
        with pytest.raises(ValueError) as re_:
            r.validate_mesh(mesh)
        assert str(pe.value) == str(re_.value)
    t = port.DistTensor("t", (8, 8), partition=("gx", "gy"))
    assert t.shard_space(mesh) == (4, 2)
    assert [t.shards_along(mesh, d) for d in (0, 1)] == [2, 4]


def test_make_mesh_refuses_cards_that_do_not_exist():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="needs"):
        make_mesh((have + 1,), ("d",))
    with pytest.raises(RuntimeError, match="does not exist"):
        make_mesh((2,), ("d",), devices=["cpu", f"cuda:{have}"]) \
            if have else make_mesh((1,), ("d",), devices=[f"cuda:{have}"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        port.Mesh({"d": 4}, ["cpu"] * 3)
    mesh = _mesh((2, 2), ("a", "b"))
    assert mesh.coords(3) == (1, 1) and mesh.index((1, 0)) == 2
    assert mesh.neighbour(0, "b", -1, wrap=False) is None
    assert mesh.neighbour(0, "b", -1, wrap=True) == 1


# -- measured tuning on a mesh (ROADMAP 3(b)) ---------------------------------

TUNE_N = 32
TUNE_BUDGET = {"max_measure": 4, "max_proposals": 16}


@pytest.fixture
def tune_env(monkeypatch, tmp_path):
    """An empty tuning cache and zeroed tuner counters; yields the search
    module (its ``STATS``)."""
    from repro_torch.tuning import cache, search

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune-cache"))
    cache.clear_memo()
    search.reset_stats()
    yield search
    cache.clear_memo()


def _flux_tuned(mesh, tune, overlap=False, **kw):
    g, (u, flux) = workloads.build_flux_graph(TUNE_N, TUNE_N, mesh=mesh,
                                              overlap=overlap)
    inputs = {"u": shock_bubble_init(TUNE_N, TUNE_N, device="cpu")}
    ex = port.Executor(g, mesh=mesh, tune=tune, tune_inputs=inputs,
                       tune_budget=TUNE_BUDGET, **kw)
    return ex, inputs, (u, flux)


def _read_soa(ex, state, tensors):
    return {t.name: ex.read(state, t).with_layout(port.Layout.SOA).data
            for t in tensors}


@pytest.mark.parametrize("overlap", [False, True])
def test_tune_auto_on_a_mesh_measures_mesh_valid_candidates(tune_env,
                                                            monkeypatch,
                                                            overlap):
    """``tune="auto"`` on a (2, 2) mesh: every candidate is an executor
    over the same mesh (so each of its layouts passed ``validate_mesh``),
    the tuned state equals the heuristic plan's, and a second
    construction loads the decision with zero measurements."""
    mesh = _mesh((2, 2), ("gx", "gy"))
    built = []
    init = port.Executor.__init__

    def spy(self, graph, *a, **kw):
        init(self, graph, *a, **kw)
        built.append(self)

    monkeypatch.setattr(port.Executor, "__init__", spy)
    ex, inputs, tensors = _flux_tuned(mesh, "auto", overlap=overlap)
    dec = ex.plan.tuning
    assert dec.source == "measured" and dec.measured >= 2
    assert dec.proposed >= dec.measured
    candidates = built[:-1]                   # the last is ``ex`` itself
    assert len(candidates) == dec.measured
    for cand in candidates:
        assert cand.mesh is mesh
        for name, lay in cand.plan.initial.items():
            cand.tensors[name].with_(layout=lay).validate_mesh(mesh)
    heur = port.Executor(ex.graph, mesh=mesh)
    got = _read_soa(ex, ex.run(ex.init_state(**inputs), 2), tensors)
    want = _read_soa(heur, heur.run(heur.init_state(**inputs), 2), tensors)
    for k in want:
        if dec.tiles:             # the flux tolerance where tiles changed
            torch.testing.assert_close(got[k], want[k], rtol=1e-4,
                                       atol=1e-4)
        else:
            assert torch.equal(got[k], want[k]), k
    before = tune_env.STATS["measurements"]
    again, _, _ = _flux_tuned(mesh, "auto", overlap=overlap)
    assert again.plan.tuning.source == "cache"
    assert tune_env.STATS["measurements"] == before
    assert again.plan.signature == ex.plan.signature


def test_tune_load_on_a_mesh_never_measures(tune_env):
    mesh = _mesh((2, 2), ("gx", "gy"))
    ex, _, _ = _flux_tuned(mesh, "load")
    assert ex.plan.tuning.source == "heuristic"
    assert tune_env.STATS["measurements"] == 0
    _flux_tuned(mesh, "auto")
    measured = tune_env.STATS["measurements"]
    assert measured >= 2
    ex, _, _ = _flux_tuned(mesh, "load")
    assert ex.plan.tuning.source == "cache"
    assert tune_env.STATS["measurements"] == measured


def test_a_mesh_tuning_decision_is_not_loaded_on_another_mesh(tune_env):
    """The tuning key is the plan signature, which carries the mesh's
    shape and axes: a decision measured on (4,) is a miss on (2, 2) and
    without a mesh."""
    from repro_torch.tuning.search import tuning_key

    four, _, _ = _flux_tuned(_mesh((4,), ("gx",)), "auto")
    assert four.plan.tuning.source == "measured"
    square, _, _ = _flux_tuned(_mesh((2, 2), ("gx", "gy")), "load")
    assert square.plan.tuning.source == "heuristic"
    assert tuning_key(square) != tuning_key(four)
    whole, _, _ = _flux_tuned(None, "load", device="cpu")
    assert whole.plan.tuning.source == "heuristic"


@pytest.mark.parametrize("overlap,n", [(False, 128), (True, 132)])
def test_mesh_tile_candidates_tile_every_shard_and_strip(tune_env, overlap,
                                                         n):
    """K5's frozen-halo tiles (``inner > 1``, ``block=None``) on a (2, 2)
    mesh: the kernel is called per shard, and with the overlapped
    lowering per interior and boundary strip; a tile that does not tile
    every one of those shapes is never proposed.  Synchronously the
    shards' tiles are measured; overlapped, the one-cell strips admit
    none but the default."""
    from repro_torch.kernels.eikonal.kernel import TILE_KERNEL
    from repro_torch.kernels.stencil.kernel import check_block
    from repro_torch.tuning.tiles import record_tile_use

    mesh = _mesh((2, 2), ("gx", "gy"))
    phi = port.DistTensor("phi", (n, n), partition=("gx", "gy"),
                          halo=(1, 1), boundary=port.Boundary.TRANSMISSIVE)
    mask = port.DistTensor("mask", (n, n), dtype=torch.bool,
                           partition=("gx", "gy"))
    g = make_eikonal_graph(phi, mask, 1.0 / n, inner=4, block=None,
                           overlap=overlap)
    inputs = {k: torch.from_numpy(v)
              for k, v in workloads.eikonal_inputs(n).items()}
    probe = port.Executor(g, mesh=mesh)
    with record_tile_use() as used:
        probe.run(probe.init_state(**inputs), 1)
    shapes = {shape for shape, _ in used[TILE_KERNEL]}
    assert len(shapes) == (3 if overlap else 1)   # interior, two strips
    ex = port.Executor(g, mesh=mesh, tune="auto", tune_inputs=inputs,
                       tune_budget={"measure_all": True})
    dec = ex.plan.tuning
    tiles = [eval(m.candidate.split(f"{TILE_KERNEL}=")[1])
             for m in dec.measurements if f"{TILE_KERNEL}=" in m.candidate]
    assert bool(tiles) == (not overlap)
    for tile in tiles + list(dec.tiles.values()):
        for shape in shapes:
            check_block(shape, tile)


def test_a_partitioned_tensor_without_a_mesh_runs_whole():
    """As in the reference, ``partition`` without a mesh is one tensor:
    its halo comes from the boundary policy."""
    t = port.DistTensor("t", (8,), partition=("d",), halo=(1,))
    o = port.DistTensor("o", (8,), partition=("d",))
    g = port.Graph().split(_diff, port.concurrent_padded_access(t), o)
    ex = port.Executor(g, device="cpu")
    st = ex(ex.init_state(t=torch.arange(8.0)))
    assert isinstance(st["o"], torch.Tensor)
    assert torch.equal(st["o"], torch.tensor([1.0, 2, 2, 2, 2, 2, 2, 1]))


@pytest.mark.parametrize("schedule", ["dag", "sequential"])
def test_the_ladder_and_the_schedules_work_on_a_mesh(schedule):
    """An injected ``halo.block`` fault fails the call before any state
    is written; two move the ladder down, whose plan rebuilds run on the
    mesh; the state after a retry equals a clean run's bit for bit."""
    from repro_torch.runtime.faults import (Fault, FaultPlan,
                                            TransientError, fault_scope)

    mesh = _mesh((2, 2), ("gx", "gy"))
    u0 = shock_bubble_init(16, 8, device="cpu")
    ex0, u = workloads.build_euler_solver(16, 8, mesh=mesh, overlap=True)
    want = ex0.read(ex0.run(ex0.init_state(u=u0), 3), u).data
    ex = port.Executor(ex0.graph, mesh=mesh, schedule=schedule)
    state = ex.init_state(u=u0)
    with fault_scope(FaultPlan([Fault("halo.block", nth=0, times=2)])):
        for _ in range(2):
            with pytest.raises(TransientError):
                ex.run(state, 3)
    assert ex.ladder_level == 1
    assert [d.site for d in ex.plan.degradations] == ["halo.block"]
    got = ex.read(ex.run(state, 3), u).data
    assert torch.equal(got, want)


# -- region compile on the mesh (regions=True) --------------------------------
#
# On a CPU mesh the pieces run through the same code and static buffers as
# on the card (one buffer per shard), without capture; each case equals
# regions=False bit for bit and the reference's default
# Executor(mesh=..., regions=True) at the tolerances above.

def _regions(g, mesh, donate, **kw):
    return port.Executor(g, mesh=mesh, regions=True, donate=donate, **kw)


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
def test_regions_halo_exchange_1d(jax_side, overlap, donate):
    mesh = _mesh((4,), ("gx",))
    src = port.DistTensor("src", (64,), partition=("gx",), halo=(1,),
                          boundary=port.Boundary.TRANSMISSIVE)
    dst = port.DistTensor("dst", (64,), partition=("gx",))
    g = port.Graph()
    g.split(_diff, port.concurrent_padded_access(src), dst, overlap=overlap)
    x0 = torch.arange(64, dtype=torch.float32) ** 2
    eager = port.Executor(g, mesh=mesh, regions=False)
    want = eager.read(eager(eager.init_state(src=x0)), dst)
    ex = _regions(g, mesh, donate)
    st = ex(ex.init_state(src=x0))
    assert isinstance(st["dst"], port.ShardedArray)
    got = ex.read(st, dst)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), jax_side[f"halo1d-{overlap}"])


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("boundary", list(port.Boundary))
def test_regions_halo_corners_2d_all_policies(jax_side, boundary, overlap):
    mesh = _mesh((4, 2), ("gx", "gy"))
    src = port.DistTensor("src", (16, 12), partition=("gx", "gy"),
                          halo=(1, 2), boundary=boundary,
                          boundary_constant=3.5)
    dst = port.DistTensor("dst", (16, 12), partition=("gx", "gy"))
    g = port.Graph()
    g.split(_sten, port.concurrent_padded_access(src), dst, overlap=overlap)
    x0 = _t(jax_side["corners-x0"])
    eager = port.Executor(g, mesh=mesh, regions=False)
    want = eager.read(eager(eager.init_state(src=x0)), dst)
    ex = _regions(g, mesh, True)
    for _ in range(2):
        got = ex.read(ex(ex.init_state(src=x0)), dst)
        assert torch.equal(got, want)
    np.testing.assert_allclose(
        got.numpy(), jax_side[f"corners-{boundary.name}-{overlap}"],
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("unsplit", [False, True])
def test_regions_euler_2d_matches_eager_and_reference(jax_side, unsplit,
                                                      overlap, donate):
    mesh = _mesh((2, 4), ("gx", "gy"))
    u0 = _t(jax_side["euler-U0"])
    eager, u = workloads.build_euler_solver(64, 32, mesh=mesh,
                                            overlap=overlap, unsplit=unsplit)
    want = eager.run(eager.init_state(u=u0), 5)
    ex, _ = workloads.build_euler_solver(64, 32, mesh=mesh, overlap=overlap,
                                         unsplit=unsplit, regions=True,
                                         donate=donate)
    st = ex.run(ex.init_state(u=u0), 5)
    assert torch.equal(ex.read(st, u).data, eager.read(want, u).data)
    for k in ("smax", "mass"):
        assert torch.equal(st[k], want[k])
    key = f"euler-{unsplit}-False"
    np.testing.assert_allclose(ex.read(st, u).data.numpy(), jax_side[key],
                               rtol=1e-5, atol=1e-6)
    assert float(st["smax"]) == pytest.approx(float(jax_side[key + "-smax"]),
                                              rel=1e-5)


@pytest.mark.parametrize("overlap", [False, True])
def test_regions_kernel_graphs_2d(jax_side, overlap):
    """The flux and eikonal graph functions on (2, 4) under regions: K4's
    and K5's plain versions write each shard's buffer (``out=``; the
    overlapped lowering stitches into it), bit for bit the eager mesh
    run."""
    mesh = _mesh((2, 4), ("gx", "gy"))
    u = port.DistTensor("u", (32, 16), spec=EULER_SPEC,
                        layout=port.Layout.SOA, partition=("gx", "gy"),
                        halo=(1, 1), boundary=port.Boundary.TRANSMISSIVE)
    du = port.DistTensor("du", (32, 16), spec=EULER_SPEC,
                         layout=port.Layout.SOA, partition=("gx", "gy"))
    g = make_flux_difference_graph(u, du, 0.1, 0.2, overlap=overlap)
    u0 = _t(jax_side["flux-U0"])
    eager = port.Executor(g, mesh=mesh, regions=False)
    want = eager.read(eager(eager.init_state(u=u0)), du).data
    ex = _regions(g, mesh, True)
    got = ex.read(ex(ex.init_state(u=u0)), du).data
    assert torch.equal(got, want)
    assert ex.cache_stats()["copy_backs"] == 0
    np.testing.assert_allclose(got.numpy(), jax_side[f"flux-{overlap}"],
                               rtol=1e-5, atol=1e-6)

    phi0 = torch.full((32, 16), 10.0)
    phi0[16, 8] = 0.0
    mask0 = torch.zeros((32, 16), dtype=torch.bool)
    mask0[16, 8] = True
    phi = port.DistTensor("phi", (32, 16), partition=("gx", "gy"),
                          halo=(1, 1))
    mask = port.DistTensor("mask", (32, 16), dtype=torch.bool,
                           partition=("gx", "gy"))
    g = make_eikonal_graph(phi, mask, 1.0 / 32, overlap=overlap)
    eager = port.Executor(g, mesh=mesh, regions=False)
    want = eager.read(eager.run(eager.init_state(phi=phi0, mask=mask0), 6),
                      phi)
    ex = _regions(g, mesh, False)
    got = ex.read(ex.run(ex.init_state(phi=phi0, mask=mask0), 6), phi)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), jax_side[f"eikonal-{overlap}"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["SOA", "AOS"])
@pytest.mark.parametrize("overlap", [False, True])
def test_regions_flux_on_a_mesh_is_bitwise_the_unsharded_run(layout,
                                                             overlap):
    mesh = _mesh((2, 2), ("gx", "gy"))
    lay = port.Layout[layout]
    g, (u, out) = workloads.build_flux_graph(16, 24, layout=lay, mesh=mesh,
                                             overlap=overlap)
    g0, _ = workloads.build_flux_graph(16, 24, layout=lay)
    u0 = shock_bubble_init(16, 24, device="cpu")
    ex0 = port.Executor(g0, device="cpu")
    want = ex0.read(ex0.run(ex0.init_state(u=u0), 2), out).data
    for donate in (False, True):
        ex = _regions(g, mesh, donate)
        got = ex.read(ex.run(ex.init_state(u=u0), 2), out).data
        assert torch.equal(got, want)


@pytest.mark.parametrize("donate", [False, True])
def test_regions_eikonal_solve_loops_over_partitioned_tensors(donate):
    """The conditional loop under regions on a mesh: one piece for the
    body, built once; the solve takes the unsharded iterations and ends
    at its phi bit for bit; a second solve and a second executor build
    nothing."""
    mesh = _mesh((2, 4), ("gx", "gy"))
    inp = workloads.eikonal_inputs(32)
    init = {"phi": torch.from_numpy(inp["phi"]),
            "mask": torch.from_numpy(inp["mask"])}
    g0, (phi, _), conv0 = workloads.build_eikonal_graph(
        32, inner=4, block=(4, 8), max_iters=200)
    ex0 = port.Executor(g0, device="cpu")
    want = ex0.read(ex0(ex0.init_state(**init)), phi)
    g, _, conv = workloads.build_eikonal_graph(32, inner=4, block=(4, 8),
                                               mesh=mesh, max_iters=200)
    ex = _regions(g, mesh, donate)
    st = ex(ex.init_state(**init))
    assert conv.iterations == conv0.iterations > 0
    assert float(st["res"]) == 0.0
    assert torch.equal(ex.read(st, phi), want)
    gc.collect()    # earlier tests' dead entries leave before the count
    built = port.executable_cache_stats()["trace_events"]
    assert ex.cache_stats()["copy_backs"] == 0
    st = ex(ex.init_state(**init))
    assert torch.equal(ex.read(st, phi), want)
    del ex, st    # under donate=True a live executor keeps its entry
    gc.collect()
    again = _regions(g, mesh, donate)
    assert torch.equal(again.read(again(again.init_state(**init)), phi), want)
    assert port.executable_cache_stats()["trace_events"] == built


@pytest.mark.parametrize("reducer", ["SumReducer", "MaxReducer",
                                     "MaximumReducer", "OrReducer"])
def test_regions_reductions_fold_the_shards(reducer):
    mesh = _mesh((2, 2), ("a", "b"))
    rng = np.random.default_rng(3)
    is_int = reducer == "OrReducer"
    x0 = (rng.integers(0, 64, (8, 6)).astype(np.int32) if is_int
          else rng.uniform(0.5, 1.5, (8, 6)).astype(np.float32))
    dtype = torch.int32 if is_int else torch.float32
    for partition in (("a", "b"), ("a", None)):
        t = port.DistTensor("t", (8, 6), dtype=dtype, partition=partition)
        r = port.make_reduction_result("r", dtype=dtype)
        g = port.Graph().reduce(t, r, getattr(port, reducer)())
        eager = port.Executor(g, mesh=mesh, regions=False)
        want = eager(eager.init_state(t=torch.from_numpy(x0)))["r"]
        ex = _regions(g, mesh, True)
        assert torch.equal(ex(ex.init_state(t=torch.from_numpy(x0)))["r"],
                           want)


def test_regions_host_node_on_a_mesh():
    """A host node between device regions on a mesh: it reads the gathered
    value of its step, async and sync, as the eager mesh run does."""
    mesh = _mesh((2, 2), ("gx", "gy"))
    seen = {}
    for mode in ("eager", "sync", "async"):
        log = seen[mode] = []

        class Log:
            def __call__(self, x, s):
                log.append((float(x.sum()), float(s)))

        u = port.DistTensor("u", (8, 8), partition=("gx", "gy"), halo=(1, 1))
        v = port.DistTensor("v", (8, 8), partition=("gx", "gy"))
        s = port.make_reduction_result("s")
        g = port.Graph()
        g.split(lambda p, _v: p[1:-1, 1:-1] + p[:-2, 1:-1],
                port.concurrent_padded_access(u), v)
        g.then_reduce(v, s, port.SumReducer())
        g.then(Log(), exec_kind=port.ExecutionKind.Cpu, args=(v, s))
        g.then_split(lambda x, _u: x * 0.5, v, u)
        opts = {} if mode == "eager" else {
            "regions": True, "donate": True,
            "async_regions": mode == "async"}
        ex = port.Executor(g, mesh=mesh, **opts)
        st = ex.run(ex.init_state(u=torch.arange(64.0).reshape(8, 8)), 3)
        seen[mode + " u"] = ex.read(st, u)
    assert seen["sync"] == seen["async"] == seen["eager"]
    assert len(seen["eager"]) == 3
    assert torch.equal(seen["sync u"], seen["eager u"])


def test_regions_on_a_mesh_capture_nothing_in_steady_state():
    """One build per piece; further calls and a second executor over an
    equal graph build nothing (the plan signature keys the mesh)."""
    mesh = _mesh((2, 2), ("gx", "gy"))
    g, (u, out) = workloads.build_flux_graph(16, 24, mesh=mesh, overlap=True)
    u0 = shock_bubble_init(16, 24, device="cpu")
    ex = _regions(g, mesh, False)
    ex.run(ex.init_state(u=u0), 2)
    stats = ex.cache_stats()
    assert stats["trace_events"] == 1
    ex.run(ex.init_state(u=u0), 3)
    assert ex.cache_stats() == stats
    g2, _ = workloads.build_flux_graph(16, 24, mesh=mesh, overlap=True)
    two = _regions(g2, mesh, False)
    two(two.init_state(u=u0))
    assert two.cache_stats()["trace_events"] == 1
    assert two.cache_stats()["hits"] >= 1
    other = _mesh((2, 2), ("gx", "gy"))
    g3, _ = workloads.build_flux_graph(16, 24, mesh=other, overlap=True)
    assert port.plan_signature(_regions(g3, other, False)) == \
        port.plan_signature(ex)


def test_regions_over_several_cards_raise_naming_their_item():
    """Region compile over the shards of several cards is ROADMAP 3(c);
    the refusal comes at construction, before any card is touched."""
    mesh = port.Mesh({"d": 4}, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])
    t = port.DistTensor("t", (8,), partition=("d",))
    g = port.Graph().split(lambda x: x + 1.0, t, writes=(0,))
    with pytest.raises(NotImplementedError, match="3\\(c\\)"):
        port.Executor(g, mesh=mesh, regions=True)
