"""The port's expert parallelism (``models/moe.py``'s ``make_moe_a2a`` on
the port's ``Mesh``), its hook through ``forward_loss``, ``prefill`` and
the train step, and the uniform loop's pooled prefill
(``launch/serve.py``'s ``legacy_generate``), against the JAX package on
the CPU.  The mesh cases' JAX side runs once, in one subprocess with 8
fake devices; the port runs on ``make_mesh(..., devices=["cpu"] * 8)``.

Cases: the a2a on a (4, 2) ("data", "model") mesh at E 8, d 16, f 32,
T 64, capacity factors 8 (nothing dropped), 1.25 and 0.25 (pairs
dropped), ``residual_tp`` both ways, and on a (2, 2, 2) ("pod", "data",
"model") mesh; phi3.5-moe's smoke ``forward_loss`` (and its gradients)
and ``prefill`` through the hook on the (4, 2) mesh.

Tolerances: float32, sums in another order.  The a2a's outputs and its
gradients within 1e-5, its aux within 1e-6; ``forward_loss`` within
1e-5 and its gradients atol 1e-6 + rtol 1e-4 (two layers of backward
sums, as ``test_torch_train.py``); the prefill logits within 1e-5; the
uniform loop's streams exactly."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_subprocess_devices
import repro.configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import lm as jlm
import repro_torch.configs as tconfigs
from repro_torch.core.mesh import make_mesh
from repro_torch.interop import params_from_reference
from repro_torch.launch import steps as tsteps
from repro_torch.launch.serve import legacy_generate
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.common import Init, ParamModule

E, D, F, T = 8, 16, 32, 64
#: (tag, mesh shape, axis names, capacity factor, residual_tp)
A2A = [(f"cf{cf}_{'rtp' if rtp else 'psum'}", (4, 2), ("data", "model"),
        cf, rtp) for cf in (8.0, 1.25, 0.25) for rtp in (False, True)] + [
    ("pod_cf1.25_rtp", (2, 2, 2), ("pod", "data", "model"), 1.25, True)]
ARCH = "phi3.5-moe"

JAX_SIDE = r'''
import numpy as np, jax, jax.numpy as jnp
import repro.configs as jconfigs
from repro.launch.mesh import make_mesh
from repro.models import lm as jlm
from repro.models.blocks import ShardCtx
from repro.models.common import ParamTree
from repro.models.moe import init_moe, make_moe_a2a

out = {}
pt = ParamTree(jax.random.PRNGKey(0))
init_moe(pt, d_model=D, d_ff=F, n_experts=E, name="moe")
p = pt.params["moe"]
x = jnp.asarray(np.random.default_rng(0).standard_normal((T, D))
                .astype(np.float32)) * 0.5
r = jnp.asarray(np.random.default_rng(1).standard_normal((T, D))
                .astype(np.float32))
for k, v in p.items():
    out["p_" + k] = np.asarray(v)
out["x"], out["r"] = np.asarray(x), np.asarray(r)
for tag, shape, names, cf, rtp in A2A:
    mesh = make_mesh(shape, names)
    fn = make_moe_a2a(mesh, dp_axes=tuple(a for a in ("pod", "data")
                                          if a in names),
                      top_k=2, capacity_factor=cf, residual_tp=rtp)

    def loss(p, x):
        y, aux = fn(p, x)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, x)
    out[tag + "_y"], out[tag + "_aux"] = np.asarray(y), np.asarray(aux)
    for k, v in gp.items():
        out[tag + "_g_" + k] = np.asarray(v)
    out[tag + "_g_x"] = np.asarray(gx)

jc = jconfigs.get_smoke(ARCH)
jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
mesh = make_mesh((4, 2), ("data", "model"))
ctx = ShardCtx(moe_a2a=make_moe_a2a(
    mesh, dp_axes=("data",), top_k=jc.top_k,
    capacity_factor=jc.capacity_factor, residual_tp=jc.shard_activations))
batch = {k: jnp.asarray(v) for k, v in BATCH.items()}
(total, parts), g = jax.jit(jax.value_and_grad(
    lambda p, b: jlm.forward_loss(p, b, jc, ctx), has_aux=True))(jp, batch)
out["lm_total"], out["lm_loss"], out["lm_aux"] = (
    np.asarray(total), np.asarray(parts["loss"]), np.asarray(parts["aux"]))
for path, v in jax.tree_util.tree_flatten_with_path(g)[0]:
    out["lm_g/" + "/".join(k.key for k in path)] = np.asarray(v)
logits, _ = jax.jit(lambda p, b: jlm.prefill(p, b, jc, ctx, max_seq=20))(
    jp, {"tokens": batch["tokens"]})
out["lm_logits"] = np.asarray(logits)
np.savez(OUT, **out)
print("OK")
'''


def _lm_batch(vocab: int) -> dict:
    toks = np.random.default_rng(0).integers(1, vocab, (4, 16)).astype(
        np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ep") / "jax_side.npz")
    batch = {k: v.tolist() for k, v in _lm_batch(
        tconfigs.get_smoke(ARCH).vocab_size).items()}
    head = (f"OUT = {path!r}\nA2A = {A2A!r}\nARCH = {ARCH!r}\n"
            f"E, D, F, T = {E}, {D}, {F}, {T}\n"
            f"BATCH = {{k: np.asarray(v, np.int32) for k, v in "
            f"{batch!r}.items()}}\n")
    run_subprocess_devices("import numpy as np\n" + head + JAX_SIDE,
                           timeout=900)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def lm_models():
    jc = jconfigs.get_smoke(ARCH)
    tc = tconfigs.get_smoke(ARCH)
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _mesh(shape=(4, 2), names=("data", "model")):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _dp(names):
    return tuple(a for a in ("pod", "data") if a in names)


def _moe_params(jax_side, requires_grad=False):
    return {k: torch.tensor(jax_side["p_" + k], requires_grad=requires_grad)
            for k in ("router", "wi", "wo")}


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- make_moe_a2a -------------------------------------------------------------

@pytest.mark.parametrize("tag,shape,names,cf,rtp", A2A,
                         ids=[a[0] for a in A2A])
def test_moe_a2a_matches_reference(jax_side, tag, shape, names, cf, rtp):
    """The output within 1e-5 and the aux (the mean of the per-shard
    estimates) within 1e-6 of the reference's a2a."""
    fn = tmoe.make_moe_a2a(_mesh(shape, names), dp_axes=_dp(names), top_k=2,
                           capacity_factor=cf, residual_tp=rtp)
    y, aux = fn(_moe_params(jax_side), _t(jax_side["x"]))
    np.testing.assert_allclose(y.numpy(), jax_side[tag + "_y"], rtol=1e-5,
                               atol=1e-5)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jax_side[tag + "_aux"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("tag,shape,names,cf,rtp", A2A,
                         ids=[a[0] for a in A2A])
def test_moe_a2a_gradients_match_reference(jax_side, tag, shape, names, cf,
                                           rtp):
    """The gradients of ``sum(y * r) + aux`` with respect to the router,
    both expert weights and the tokens within 1e-5 of ``jax.grad``'s."""
    fn = tmoe.make_moe_a2a(_mesh(shape, names), dp_axes=_dp(names), top_k=2,
                           capacity_factor=cf, residual_tp=rtp)
    p = _moe_params(jax_side, requires_grad=True)
    x = torch.tensor(jax_side["x"], requires_grad=True)
    y, aux = fn(p, x)
    loss = (y * _t(jax_side["r"])).sum() + aux
    grads = torch.autograd.grad(loss, [p["router"], p["wi"], p["wo"], x])
    for name, g in zip(("router", "wi", "wo", "x"), grads):
        np.testing.assert_allclose(g.numpy(), jax_side[f"{tag}_g_{name}"],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("cf,dropped", [(8.0, False), (0.25, True)])
def test_moe_a2a_drops_pairs_only_past_capacity(jax_side, cf, dropped,
                                                monkeypatch):
    """At capacity factor 0.25 some data shard's buckets drop pairs; at 8
    none does."""
    real = tmoe._dispatch_slots
    kept = []

    def counting(gate_idx, n_experts, C):
        out = real(gate_idx, n_experts, C)
        kept.append(bool(out[1].all()))
        return out

    monkeypatch.setattr(tmoe, "_dispatch_slots", counting)
    fn = tmoe.make_moe_a2a(_mesh(), dp_axes=("data",), top_k=2,
                           capacity_factor=cf, residual_tp=False)
    fn(_moe_params(jax_side), _t(jax_side["x"]))
    assert len(kept) == 4                  # once per data shard
    assert (not all(kept)) == dropped


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_moe_a2a_is_moe_block_per_data_shard(jax_side, cf):
    """Expert parallelism computes ``moe_block`` on each data shard's
    tokens, and its aux is their mean; at capacity 8 (nothing dropped)
    it is also ``moe_block`` over all the tokens."""
    p = _moe_params(jax_side)
    x = _t(jax_side["x"])
    fn = tmoe.make_moe_a2a(_mesh(), dp_axes=("data",), top_k=2,
                           capacity_factor=cf, residual_tp=True)
    y, aux = fn(p, x)
    parts = [tmoe.moe_block(p, xs, top_k=2, capacity_factor=cf)
             for xs in torch.chunk(x, 4)]
    torch.testing.assert_close(y, torch.cat([o for o, _ in parts]),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux, torch.stack([a for _, a in parts]).mean(),
                               rtol=0, atol=1e-6)
    if cf == 8.0:
        whole, _ = tmoe.moe_block(p, x, top_k=2, capacity_factor=cf)
        torch.testing.assert_close(y, whole, rtol=1e-5, atol=1e-6)


def test_placed_experts_are_views_and_give_the_same_output(jax_side):
    """``place_experts`` on the weights' own device copies nothing: every
    shard is a view of the global weights; the block takes the placed
    weights and gives the global weights' output bit for bit."""
    mesh = _mesh()
    p = _moe_params(jax_side)
    placed = tmoe.place_experts(p, mesh, dp_axes=("data",))
    assert placed["wi"].placement.spec == ("data", None, None, "model")
    assert placed["wo"].placement.spec == ("data", "model", None)
    for name in ("wi", "wo"):
        for s in placed[name].shards:
            assert s.untyped_storage().data_ptr() == \
                p[name].untyped_storage().data_ptr()
    fn = tmoe.make_moe_a2a(mesh, dp_axes=("data",), top_k=2,
                           capacity_factor=1.25, residual_tp=False)
    x = _t(jax_side["x"])
    torch.testing.assert_close(fn(placed, x)[0], fn(p, x)[0], rtol=0, atol=0)


def test_moe_a2a_refuses_what_the_mesh_does_not_divide(jax_side):
    p = _moe_params(jax_side)
    x = _t(jax_side["x"])
    fn = tmoe.make_moe_a2a(_mesh((3, 2), ("data", "model")),
                           dp_axes=("data",), top_k=2, capacity_factor=1.25,
                           residual_tp=False)
    with pytest.raises(ValueError, match="token count of 64 is not "
                                         "divisible by mesh axis"):
        fn(p, x)
    with pytest.raises(ValueError, match="expert count of 8 is not"):
        fn(p, x[:63])
    fn = tmoe.make_moe_a2a(_mesh((2, 4), ("data", "model")),
                           dp_axes=("data",), top_k=2, capacity_factor=1.25,
                           residual_tp=False)
    with pytest.raises(ValueError, match="d_ff of 30 is not divisible"):
        fn({**p, "wi": p["wi"][..., :30], "wo": p["wo"][:, :30]}, x)
    with pytest.raises(ValueError, match=r"placed as \('data', None, None, "
                                         r"'model'\), expected"):
        other = tmoe.place_experts(p, _mesh((4, 2), ("data", "model")),
                                   dp_axes=("data",))
        fn(other, x)


def test_a_dropless_ffn_never_takes_the_hook(jax_side):
    """A decode step's FFN routes dropless and never through
    ``moe_a2a``, as the reference's ``ffn_forward``."""
    cfg = tconfigs.get_smoke(ARCH)

    def refuse(*_):
        raise AssertionError("moe_a2a called on a dropless FFN")

    p = ParamModule()
    tblocks.init_ffn(Init(torch.Generator().manual_seed(0), torch.float32,
                          "cpu"), p, cfg, name="ffn")
    x = torch.randn(3, cfg.d_model, generator=torch.Generator().manual_seed(1))
    out, _ = tblocks.ffn_forward(p["ffn"], x, cfg, dropless=True,
                                 moe_a2a=refuse)
    want, _ = tblocks.ffn_forward(p["ffn"], x, cfg, dropless=True)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


# -- the hook through the model -----------------------------------------------

def _jax_grad(jax_side, name: str):
    """The reference gradient of a port parameter name (the groups
    stacked on a leading axis there)."""
    parts = name.split(".")
    key = "lm_g/" + "/".join(p for p in parts if not p.isdigit())
    g = jax_side[key]
    digits = [int(p) for p in parts if p.isdigit()]
    return g[digits[0]] if digits else g


def test_forward_loss_through_the_a2a_matches_reference(jax_side, lm_models):
    """phi3.5-moe's smoke ``forward_loss`` with ``moe_a2a`` on the (4, 2)
    mesh: total, loss and aux within 1e-5 of the reference's with
    ``ShardCtx(moe_a2a=...)``, and every gradient of the train step's
    objective against ``jax.grad``'s."""
    _, tc, _, tp = lm_models
    fn = tsteps.moe_a2a_for(tc, _mesh())
    assert fn is not None
    batch = {k: _t(v) for k, v in _lm_batch(tc.vocab_size).items()}
    total, parts = tlm.forward_loss(tp, batch, tc, moe_a2a=fn)
    for got, key in ((total, "lm_total"), (parts["loss"], "lm_loss"),
                     (parts["aux"], "lm_aux")):
        np.testing.assert_allclose(float(got), float(jax_side[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    # the hook changes the aux: the mean of per-shard estimates
    _, plain = tlm.forward_loss(tp, batch, tc)
    assert abs(float(plain["aux"]) - float(parts["aux"])) > 1e-3
    tp.requires_grad_(True)
    try:
        loss, grads = tsteps.loss_and_grads(tp, batch, tc, moe_a2a=fn)
    finally:
        tp.requires_grad_(False)
    np.testing.assert_allclose(float(loss), float(jax_side["lm_total"]),
                               rtol=1e-5)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), _jax_grad(jax_side, name),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_prefill_through_the_a2a_matches_reference(jax_side, lm_models):
    _, tc, _, tp = lm_models
    fn = tsteps.moe_a2a_for(tc, _mesh())
    toks = _t(_lm_batch(tc.vocab_size)["tokens"])
    logits, caches = tlm.prefill(tp, {"tokens": toks}, tc, max_seq=20,
                                 moe_a2a=fn)
    np.testing.assert_allclose(logits.numpy(), jax_side["lm_logits"],
                               rtol=1e-5, atol=1e-5)
    assert int(caches["pos"]) == 16


def test_train_step_on_a_mesh_runs_the_a2a(jax_side, lm_models):
    """``make_train_step(cfg, mesh=...)`` steps through the hook: its loss
    is the reference's ``forward_loss`` through the a2a."""
    _, tc, jp, _ = lm_models
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    tp.requires_grad_(True)
    step, opt = tsteps.make_train_step(tc, total_steps=100, device="cpu",
                                       mesh=_mesh())
    state = {"params": tp, "opt": opt.init(tp),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = step(state, _lm_batch(tc.vocab_size))
    np.testing.assert_allclose(float(m["loss"]),
                               float(jax_side["lm_total"]), rtol=1e-5)
    assert int(state["step"]) == 1


@pytest.mark.parametrize("shape,names,over", [
    ((4, 2), ("data", "model"), {}),
    ((8,), ("data",), {}),
    ((4, 1), ("data", "model"), {}),
    ((3, 2), ("data", "model"), {}),
    ((2, 2, 2), ("pod", "data", "model"), {}),
    ((1, 8), ("data", "model"), {}),
    ((4, 2), ("data", "model"), {"train_sharding": "fsdp"}),
    ((4, 2), ("data", "model"), {"n_experts": 0}),
])
def test_moe_a2a_for_follows_make_ctx(shape, names, over):
    """The train step takes the a2a where the reference's ``make_ctx``
    builds one: an MoE arch under "tp" sharding whose mesh has "model" >
    1 and a "data" size > 1 that divides the expert count."""
    jc = jconfigs.get(ARCH).with_(**over)
    tc = tconfigs.get(ARCH).with_(**over)
    fake = types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)
    want = jsteps.make_ctx(jc, fake).moe_a2a is not None
    got = tsteps.moe_a2a_for(tc, _mesh(shape, names)) is not None
    assert got == want


# -- the uniform loop's pooled prefill ----------------------------------------

@pytest.mark.parametrize("arch", ["phi3.5-moe", "arctic-480b"])
def test_legacy_generate_pools_the_rows_capacity(arch):
    """Capacity factor 1.25, 3 rows of 12 tokens, 6 new: one prefill over
    the 36 tokens buckets them together, as the reference's, and the
    streams are the reference's token for token (a prefill of each row
    alone, reckoning each row's capacity over 12 tokens, gives others)."""
    jc = jconfigs.get_smoke(arch).with_(capacity_factor=1.25)
    tc = tconfigs.get_smoke(arch).with_(capacity_factor=1.25)
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    toks = np.random.default_rng(13).integers(1, 256, (3, 12)).astype(
        np.int32)
    want, _, _ = jserve.legacy_generate(jc, jp, {"tokens": jnp.asarray(toks)},
                                        6, 20)
    got, _, _ = legacy_generate(tc, tp, torch.from_numpy(toks), 6, 20)
    np.testing.assert_array_equal(got, want)
    alone = np.concatenate([legacy_generate(tc, tp, torch.from_numpy(
        toks[i:i + 1]), 6, 20)[0] for i in range(3)])
    assert not np.array_equal(alone, want)
