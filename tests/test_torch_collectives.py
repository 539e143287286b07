"""The port's collectives (``repro_torch.core.collectives``), its
sequence-parallel halo and carry (``models/ssm.py``'s
``seqpar_conv_halo`` and ``seqpar_scan_carry``) and ``compressed_psum``
(``optim/compression.py``) against ``lax``'s and the JAX package's on the
CPU.  The JAX side runs once, in one subprocess with 8 fake devices; the
port runs on ``make_mesh(..., devices=["cpu"] * n)``.

Tolerances: the collectives bit for bit (XLA's CPU all-reduce sums left
to right in group order, as the port does); the halo bit for bit; the
carry within 1e-6 (a scan of float32 products); ``compressed_psum``'s
means and residuals bit for bit over 30 steps of the reference test's
(8, 64) input.  Autograd through the collectives: the backward of an
``all_to_all`` is the reverse exchange, of a ``psum`` the sum of the
cotangents, and ``halo._transfer``'s copy reaches its source."""

import numpy as np
import pytest
import torch

from conftest import run_subprocess_devices
from repro_torch.core import collectives as coll
from repro_torch.core.halo import _transfer
from repro_torch.core.mesh import ShardedArray, make_mesh
from repro_torch.models.ssm import (causal_conv1d, linear_scan,
                                    seqpar_conv_halo, seqpar_scan_carry)
from repro_torch.optim import ErrorFeedbackState, compressed_psum

#: (name, collective, axes, keyword arguments) on a (4, 2) ("data",
#: "model") mesh, each device's block (8, 6) float32
CASES = [
    ("psum_data", "psum", "data", {}),
    ("psum_model", "psum", "model", {}),
    ("psum_both", "psum", ("data", "model"), {}),
    ("pmax_data", "pmax", "data", {}),
    ("pmax_both", "pmax", ("data", "model"), {}),
    ("pmean_data", "pmean", "data", {}),
    ("pmean_both", "pmean", ("model", "data"), {}),
    ("all_gather_data", "all_gather", "data", {}),
    ("all_gather_model", "all_gather", "model", {}),
    ("all_gather_both", "all_gather", ("data", "model"), {}),
    ("ppermute_shift", "ppermute", "data",
     {"perm": [(0, 1), (1, 2), (2, 3)]}),
    ("ppermute_ring", "ppermute", "data",
     {"perm": [(i, (i + 1) % 4) for i in range(4)]}),
    ("all_to_all_data", "all_to_all", "data",
     {"split_axis": 0, "concat_axis": 1}),
    ("all_to_all_model", "all_to_all", "model",
     {"split_axis": 1, "concat_axis": 0}),
    ("all_to_all_both", "all_to_all", ("data", "model"),
     {"split_axis": 0, "concat_axis": 1}),
    ("psum_scatter_data", "psum_scatter", "data",
     {"scatter_dimension": 0}),
    ("psum_scatter_model", "psum_scatter", "model",
     {"scatter_dimension": 1}),
]

JAX_SIDE = r'''
import json
import numpy as np, jax, jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.models.ssm import seqpar_conv_halo, seqpar_scan_carry
from repro.optim.compression import ErrorFeedbackState, compressed_psum

out = {}
mesh = make_mesh((4, 2), ("data", "model"))
x = np.random.default_rng(3).standard_normal((8, 8, 6)).astype(np.float32)
out["x"] = x
every = P(("data", "model"))

def lax_op(op, axes, kw):
    if op == "all_to_all":
        return lambda b: lax.all_to_all(b, axes, kw["split_axis"],
                                        kw["concat_axis"], tiled=True)
    if op == "psum_scatter":
        return lambda b: lax.psum_scatter(
            b, axes, scatter_dimension=kw["scatter_dimension"], tiled=True)
    if op == "all_gather":
        return lambda b: lax.all_gather(b, axes)
    if op == "ppermute":
        return lambda b: lax.ppermute(b, axes, kw["perm"])
    return lambda b: getattr(lax, op)(b, axes)

for name, op, axes, kw in CASES:
    axes = tuple(axes) if isinstance(axes, list) else axes
    f = lax_op(op, axes, kw)
    out[name] = np.asarray(jax.jit(jax.shard_map(
        lambda b: f(b[0])[None], mesh=mesh, in_specs=every,
        out_specs=every, check_vma=False))(jnp.asarray(x)))

# the reference test's sequence-parallel inputs
sp = make_mesh((4,), ("sp",))
B, S, C = 2, 32, 4
xs = np.random.default_rng(0).standard_normal((B, S, C)).astype(np.float32)
out["sp_x"] = xs
out["halo"] = np.asarray(jax.jit(jax.shard_map(
    lambda x_l: seqpar_conv_halo(x_l, width=3, axis_name="sp"), mesh=sp,
    in_specs=(P(None, "sp", None),), out_specs=P(None, "sp", None),
    check_vma=False))(jnp.asarray(xs)))
a = np.random.default_rng(1).uniform(0.5, 0.9, (B, S, C)).astype(np.float32)
b = np.random.default_rng(2).standard_normal((B, S, C)).astype(np.float32)

def local(a_l, b_l):
    def step(h, inp):
        h = inp[0] * h + inp[1]
        return h, h
    h_last, _ = lax.scan(step, jnp.zeros((B, C)),
                         (jnp.moveaxis(a_l, 1, 0), jnp.moveaxis(b_l, 1, 0)))
    a_total = jnp.prod(a_l, axis=1)
    inc = seqpar_scan_carry(a_total, h_last, axis_name="sp")
    return a_total[:, None], h_last[:, None], inc[:, None]

at, hl, inc = jax.jit(jax.shard_map(
    local, mesh=sp, in_specs=(P(None, "sp", None),) * 2,
    out_specs=(P(None, "sp", None),) * 3, check_vma=False))(a, b)
out["a_total"], out["h_local"], out["incoming"] = map(np.asarray,
                                                      (at, hl, inc))

# compressed_psum: 30 steps on the reference test's input
dmesh = make_mesh((8,), ("data",))
gs = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
out["gs"] = gs

def cstep(g, r):
    m, ef = compressed_psum({"g": g}, "data",
                            ef=ErrorFeedbackState({"g": r}))
    return m["g"], ef.residual["g"]

run = jax.jit(jax.shard_map(cstep, mesh=dmesh,
                            in_specs=(P("data", None), P("data", None)),
                            out_specs=(P("data", None), P("data", None)),
                            check_vma=False))
resid = jnp.zeros((8, 64), jnp.float32)
means, resids = [], []
for _ in range(30):
    mean, resid = run(jnp.asarray(gs), resid)
    means.append(np.asarray(mean))
    resids.append(np.asarray(resid))
out["means"], out["resids"] = np.stack(means), np.stack(resids)
np.savez(OUT, **out)
print("OK")
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("collectives") / "jax_side.npz")
    run_subprocess_devices(f"OUT = {path!r}\nCASES = {CASES!r}\n"
                           + JAX_SIDE, timeout=900)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _mesh(shape, names):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _blocks(x):
    return [torch.from_numpy(b.copy()) for b in x]


@pytest.mark.parametrize("name,op,axes,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_collective_matches_lax(jax_side, name, op, axes, kw):
    """Every device's result bit for bit ``lax``'s inside ``shard_map``."""
    mesh = _mesh((4, 2), ("data", "model"))
    got = getattr(coll, op)(_blocks(jax_side["x"]), mesh, axes, **kw)
    want = jax_side[name]
    assert len(got) == 8
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), want[i], err_msg=f"{i}")


def test_collectives_take_a_sharded_array(jax_side):
    """A ShardedArray's shards are the list in the mesh's order."""
    mesh = _mesh((4, 2), ("data", "model"))
    x = torch.from_numpy(jax_side["x"].reshape(64, 6))
    xs = ShardedArray.from_global(x, mesh, ("data", None))
    got = coll.psum(xs, mesh, "model")
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(),
                                      2 * xs.shards[i].numpy())


def test_axis_groups_order_by_named_axes():
    mesh = _mesh((4, 2), ("data", "model"))
    assert coll.axis_groups(mesh, "data") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert coll.axis_groups(mesh, ("model", "data")) == [
        [0, 2, 4, 6, 1, 3, 5, 7]]
    assert coll.axis_index(mesh, ("model", "data"), 3) == 5
    with pytest.raises(ValueError, match="no axis 'sp'"):
        coll.axis_size(mesh, "sp")


@pytest.mark.parametrize("axes", ["data", ("data", "model")])
def test_all_to_all_backward_is_the_reverse_exchange(axes):
    mesh = _mesh((4, 2), ("data", "model"))
    rng = np.random.default_rng(5)
    xs = [torch.tensor(rng.standard_normal((8, 3)), requires_grad=True)
          for _ in range(8)]
    n = coll.axis_size(mesh, axes)
    ys = coll.all_to_all(xs, mesh, axes, 0, 1)
    cts = [torch.tensor(rng.standard_normal((8 // n, 3 * n)))
           for _ in range(8)]
    sum((y * c).sum() for y, c in zip(ys, cts)).backward()
    back = coll.all_to_all(cts, mesh, axes, 1, 0)
    for x, want in zip(xs, back):
        torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


def test_psum_backward_sums_the_cotangents():
    mesh = _mesh((4, 2), ("data", "model"))
    rng = np.random.default_rng(6)
    xs = [torch.tensor(rng.standard_normal(5), requires_grad=True)
          for _ in range(8)]
    cts = [torch.tensor(rng.standard_normal(5)) for _ in range(8)]
    ys = coll.psum(xs, mesh, "data")
    sum((y * c).sum() for y, c in zip(ys, cts)).backward()
    want = coll.psum(cts, mesh, "data")
    for x, w in zip(xs, want):
        torch.testing.assert_close(x.grad, w, rtol=1e-12, atol=0)


def test_transfer_backward_reaches_its_source():
    """The copy a block takes to another device: its gradient flows back
    to the block it was copied from."""
    x = torch.arange(6.0, requires_grad=True)
    y = _transfer(x[2:5], torch.device("cpu"))
    assert y.data_ptr() != x.data_ptr()
    (y * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0, 0, 1, 2, 3, 0])


@pytest.mark.parametrize("op,kw", [
    ("all_to_all", {"split_axis": 1, "concat_axis": 0}),
    ("psum_scatter", {"scatter_dimension": 1})])
def test_an_indivisible_split_raises(op, kw):
    mesh = _mesh((4, 2), ("data", "model"))
    xs = [torch.zeros(8, 6) for _ in range(8)]
    with pytest.raises(ValueError, match=r"extent 6 is not divisible by 4"):
        getattr(coll, op)(xs, mesh, "data", **kw)


def test_ppermute_refuses_a_repeated_destination():
    mesh = _mesh((4,), ("sp",))
    xs = [torch.zeros(2) for _ in range(4)]
    with pytest.raises(ValueError, match="partial permutation"):
        coll.ppermute(xs, mesh, "sp", [(0, 1), (2, 1)])
    with pytest.raises(ValueError, match="8 shards for a mesh of 4"):
        coll.psum(xs * 2, mesh, "sp")


# -- sequence parallelism ---------------------------------------------------

def _seq_shards(x, n=4):
    return [torch.from_numpy(np.ascontiguousarray(p))
            for p in np.split(x, n, axis=1)]


def test_seqpar_conv_halo_matches_reference(jax_side):
    """The reference test's input (B 2, S 32, C 4, 4 shards, width 3):
    each shard's halo bit for bit, zeros on the first."""
    mesh = _mesh((4,), ("sp",))
    halos = seqpar_conv_halo(_seq_shards(jax_side["sp_x"]), mesh, width=3,
                             axis_name="sp")
    want = np.split(jax_side["halo"], 4, axis=1)
    for h, w in zip(halos, want):
        np.testing.assert_array_equal(h.numpy(), w)
    assert not halos[0].any()


def test_seqpar_scan_carry_matches_reference(jax_side):
    mesh = _mesh((4,), ("sp",))
    at = [torch.from_numpy(np.ascontiguousarray(jax_side["a_total"][:, i]))
          for i in range(4)]
    hl = [torch.from_numpy(np.ascontiguousarray(jax_side["h_local"][:, i]))
          for i in range(4)]
    got = seqpar_scan_carry(at, hl, mesh, axis_name="sp")
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), jax_side["incoming"][:, i],
                                   rtol=0, atol=1e-6)


def test_seqpar_conv_equals_the_unsharded_conv():
    """Each shard's causal conv with its halo as the prefix is bit for
    bit its part of the conv over the whole sequence."""
    mesh = _mesh((4,), ("sp",))
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 64, 10)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((10, 4)).astype(np.float32))
    shards = list(torch.chunk(x, 4, dim=1))
    halos = seqpar_conv_halo(shards, mesh, width=3, axis_name="sp")
    got = torch.cat([causal_conv1d(s, w, prefix=h)
                     for s, h in zip(shards, halos)], dim=1)
    torch.testing.assert_close(got, causal_conv1d(x, w), rtol=0, atol=0)


def test_seqpar_carry_gives_the_unsharded_scan():
    """Per-shard ``linear_scan`` from zero, then the carry: each shard's
    last state within float32 rtol 1e-5 of the unsharded scan's; a carry
    that leaves out the shard's decay product falls outside."""
    mesh = _mesh((4,), ("sp",))
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.uniform(0.5, 0.99, (2, 64, 6)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 64, 6)).astype(np.float32))
    whole = linear_scan(a, b)[:, 15::16]                    # (B, 4, R)
    a_s, b_s = torch.chunk(a, 4, dim=1), torch.chunk(b, 4, dim=1)
    h_local = [linear_scan(x, y)[:, -1] for x, y in zip(a_s, b_s)]
    a_total = [x.prod(dim=1) for x in a_s]
    inc = seqpar_scan_carry(a_total, h_local, mesh, axis_name="sp")
    last = torch.stack([c * t + h for c, t, h in zip(inc, a_total, h_local)],
                       dim=1)
    torch.testing.assert_close(last, whole, rtol=1e-5, atol=1e-6)
    wrong = torch.stack([c + h for c, h in zip(inc, h_local)], dim=1)
    assert not torch.allclose(wrong, whole, rtol=1e-5, atol=1e-6)


# -- compressed_psum --------------------------------------------------------

def test_compressed_psum_matches_reference(jax_side):
    """30 steps with error feedback: every shard's mean and residual bit
    for bit the reference's."""
    mesh = _mesh((8,), ("data",))
    gs = [torch.from_numpy(g.copy()) for g in jax_side["gs"]]
    ef = ErrorFeedbackState.init({"g": gs})
    for step in range(30):
        mean, ef = compressed_psum({"g": gs}, mesh, "data", ef=ef)
        for i in range(8):
            np.testing.assert_array_equal(mean["g"][i].numpy(),
                                          jax_side["means"][step][i],
                                          err_msg=f"step {step} shard {i}")
            np.testing.assert_array_equal(ef.residual["g"][i].numpy(),
                                          jax_side["resids"][step][i],
                                          err_msg=f"step {step} shard {i}")


def test_compressed_psum_converges_to_the_true_mean(jax_side):
    """The reference test's gate: the time-averaged mean within 2e-2 of
    the true mean; the int32 payload sum equals a float64 sum."""
    mesh = _mesh((8,), ("data",))
    gs = jax_side["gs"]
    shards = [torch.from_numpy(g.copy()) for g in gs]
    ef = ErrorFeedbackState.init({"g": shards})
    total = torch.zeros(64)
    for _ in range(30):
        mean, ef = compressed_psum({"g": shards}, mesh, "data", ef=ef)
        total += mean["g"][0]
    np.testing.assert_allclose(total.numpy() / 30, gs.mean(axis=0),
                               atol=2e-2)
    q = [torch.from_numpy(np.random.default_rng(i).integers(
        -127, 128, 64).astype(np.int32)) for i in range(8)]
    np.testing.assert_array_equal(
        coll.psum(q, mesh, "data")[0].numpy(),
        np.sum([x.numpy().astype(np.float64) for x in q], axis=0))


def test_error_feedback_init_per_shard():
    ef = ErrorFeedbackState.init({"a": [torch.ones(3, dtype=torch.bfloat16)]
                                  * 2, "b": torch.ones(2)})
    assert [r.dtype for r in ef.residual["a"]] == [torch.float32] * 2
    assert ef.residual["b"].shape == (2,) and not ef.residual["b"].any()
