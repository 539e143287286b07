"""The port's LM stack against the JAX package on the CPU, at the smoke
configs (2-6 layers, d_model 64): configs, norms and RoPE, the KV cache in
every layout and order, weights carried across with
``params_from_reference``, then prefill logits and caches and 4 decode
steps for qwen3-8b (attention), mamba2-130m (Mamba-2), gemma3-12b (local
and global attention, sandwich norms; its 21-token prompt wraps the
16-slot ring), recurrentgemma-9b (RG-LRU and local attention),
qwen1.5-4b (QKV bias, MHA), chatglm3-6b (GQA, half-dim interleaved
RoPE), phi3.5-moe (routed experts) and arctic-480b (routed experts
beside a dense residual FFN), also with a capacity that drops pairs;
``forward_loss`` with the MoE load-balance loss and its gradients.  The
encoder-decoder and VLM archs are in ``test_torch_encdec.py``, the MoE
block alone in ``test_torch_moe.py``.

Tolerances: float32 1e-5 for layers and the cache (the cache bit for
bit), 1e-4 for whole prefill / decode logits (two layers of sums in
another order)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core.layout import Layout as JLayout
from repro.models import common as jcommon
from repro.models import kvcache as jkv
from repro.models import lm as jlm
from repro.models.blocks import ShardCtx
import repro_torch.configs as tconfigs
from repro_torch.core.layout import Layout
from repro_torch.interop import params_from_reference
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import kvcache as tkv
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

ARCHS = ["qwen3-8b", "mamba2-130m", "gemma3-12b", "recurrentgemma-9b",
         "qwen1.5-4b", "chatglm3-6b", "phi3.5-moe", "arctic-480b"]
MOE_ARCHS = ["phi3.5-moe", "arctic-480b"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    get = "get_smoke" if smoke else "get"
    j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    for f in dataclasses.fields(j):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name == "kv_layout":
            assert jv.name == tv.name
        else:
            assert jv == tv, f.name
    assert t.ssm_heads() == j.ssm_heads()
    assert t.layer_groups() == j.layer_groups()
    assert t.padded_vocab() == j.padded_vocab(1)


@pytest.mark.parametrize("what", ["moe"])
def test_moe_ffn_and_cross_attention_name_their_roadmap_queue(what):
    """An MoE FFN is built (no arch raises for ``n_experts`` any more);
    an unknown layer kind is a ValueError."""
    base = tconfigs.get_smoke("gemma3-12b")
    lm = tlm.init_lm(base.with_(n_experts=4),
                     torch.Generator().manual_seed(0), "cpu")
    assert tuple(lm["groups"][0]["p0"]["ffn"]["moe"]["wi"].shape) == \
        (4, 64, 2, base.d_ff)
    with pytest.raises(ValueError, match="unknown layer kind"):
        tblocks.layer_forward(None, torch.zeros(1, 2, 64), "X", base)


@pytest.mark.parametrize("alias", ["phi3.5-moe", "phi3.5-moe-42b-a6.6b",
                                   "phi3_5_moe", "arctic-480b"])
def test_moe_archs_and_aliases_resolve(alias):
    """Every alias of the reference's registry names the published
    config, and the published MoE configs count the reference's
    parameters (from shapes, on the meta device)."""
    assert tconfigs.get(alias).name == jconfigs.get(alias).name
    assert tlm.param_count(tconfigs.get(alias)) == \
        jlm.param_count(jconfigs.get(alias))


def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    for plus_one in (False, True):
        np.testing.assert_allclose(
            tcommon.rms_norm(tx, tw, plus_one=plus_one).numpy(),
            _np(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w),
                                 plus_one=plus_one)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tcommon.layer_norm(tx, tw, tb).numpy(),
        _np(jcommon.layer_norm(*map(jnp.asarray, (x, w, b)))),
        atol=1e-5, rtol=1e-5)
    pos = np.arange(5, dtype=np.int32)
    for rot, mode in ((16, "half"), (8, "interleaved")):
        jc, js = jcommon.rope_cos_sin(jnp.asarray(pos), rot, base=1e4)
        tc, ts = tcommon.rope_cos_sin(torch.from_numpy(pos), rot, base=1e4)
        np.testing.assert_allclose(tc.numpy(), _np(jc), atol=1e-6)
        np.testing.assert_allclose(
            tcommon.apply_rope(tx, tc, ts, mode=mode).numpy(),
            _np(jcommon.apply_rope(jnp.asarray(x), jc, js, mode=mode)),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("order", ["bsh", "bhs"])
@pytest.mark.parametrize("layout", ["AOS", "SOA", "AOSOA"])
def test_kvcache_matches_reference(layout, order):
    """Prefill write, a scalar-position and a per-slot token write, and
    the read, storage equal bit for bit."""
    B, S, Hkv, hd = 2, 16, 4, 8
    jl, tl = getattr(JLayout, layout), getattr(Layout, layout)
    rng = np.random.default_rng(1)
    k, v = (rng.standard_normal((B, 5, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    kt, vt = (rng.standard_normal((B, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    js = jkv.kv_make(B, S, Hkv, hd, jnp.float32, jl, order)
    ts = tkv.kv_make(B, S, Hkv, hd, torch.float32, tl, order, "cpu")
    assert tuple(ts.shape) == js.shape
    js = jkv.kv_write_prefill(js, jnp.asarray(k), jnp.asarray(v), jl, order)
    ts = tkv.kv_write_prefill(ts, torch.from_numpy(k), torch.from_numpy(v),
                              tl, order)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for pos in (np.int32(5), np.array([6, 9], np.int32)):
        js = jkv.kv_write_token(js, jnp.asarray(kt), jnp.asarray(vt),
                                jnp.asarray(pos), jl, order)
        ts = tkv.kv_write_token(ts, torch.from_numpy(kt),
                                torch.from_numpy(vt), torch.from_numpy(
                                    np.asarray(pos)), tl, order)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for got, want in zip(tkv.kv_read(ts, hd, tl, order),
                         jkv.kv_read(js, hd, jl, order)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """One arch's smoke model in both packages, the same weights."""
    jc, tc = (jconfigs.get_smoke(request.param),
              tconfigs.get_smoke(request.param))
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def test_params_from_reference_keeps_every_weight(model):
    jc, tc, jp, tp = model
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert sum(int(np.prod(v.shape)) for _, v in flat) == \
        tcommon.count_params(tp)
    last = tc.layer_groups()[0] - 1
    g = tp["groups"][last]["p0"]
    name = next(n for n in ("attn", "mamba", "rglru") if n in g)
    for key in ("wo",):
        np.testing.assert_array_equal(
            g[name][key].numpy(),
            np.asarray(jp["groups"]["p0"][name][key][last]))


def test_prefill_and_decode_match_reference(model):
    """Prefill of a prompt that is no multiple of the SSD chunk (21),
    caches and logits, then 4 greedy decode steps."""
    jc, tc, jp, tp = model
    toks = np.random.default_rng(2).integers(0, 256, (2, 21)).astype(
        np.int32)
    # the JAX side compiled whole: op by op it costs seconds per shape
    jprefill = jax.jit(functools.partial(jlm.prefill, cfg=jc, ctx=ShardCtx(),
                                         max_seq=32))
    jdecode = jax.jit(functools.partial(jlm.decode_step, cfg=jc,
                                        ctx=ShardCtx()))
    jlog, jcache = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tlog, tcache = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                               max_seq=32)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), atol=1e-4,
                               rtol=1e-4)
    for g in range(tc.layer_groups()[0]):
        got = tcache["groups"][g]["p0"]
        want = jax.tree.map(lambda x: x[g], jcache["groups"]["p0"])
        for a, b in zip(jax.tree.leaves(want),
                        [got] if torch.is_tensor(got) else list(got)):
            np.testing.assert_allclose(b.numpy(), _np(a), atol=1e-4,
                                       rtol=1e-4)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 21
    tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    for _ in range(4):
        ttok = torch.from_numpy(np.array(tok))
        jlog, jcache = jdecode(jp, jcache, tok)
        tlog, tcache = tlm.decode_step(tp, tcache, ttok, tc)
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), atol=1e-4,
                                   rtol=1e-4)
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)


def test_init_lm_mirrors_the_reference_tree(model):
    """Random weights from a torch.Generator: the reference's names and
    shapes, fan-in-scaled."""
    jc, tc, jp, _ = model
    lm = tlm.init_lm(tc, torch.Generator().manual_seed(0), "cpu")
    shapes = {}
    for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        if keys[0] == "groups":
            for g in range(v.shape[0]):
                shapes[".".join(["groups", str(g)] + keys[1:])] = v.shape[1:]
        else:
            shapes[".".join(keys)] = v.shape
    got = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    assert got == {k: tuple(v) for k, v in shapes.items()}
    w = lm["embed"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(tc.d_model) + 1e-6


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    cfg = tconfigs.get_smoke("qwen3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_lm(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkv.kv_make(1, 4, 2, 8)


# -- the MoE archs: drops, the load-balance loss, its gradients -------------

def test_prefill_and_decode_with_drops_match_reference():
    """phi3.5-moe's smoke config at capacity factor 1.0: the 21-token
    prompt's prefill drops pairs (bucketed to capacity), the decode
    routes dropless; logits at 1e-4 through 4 decode steps."""
    arch = "phi3.5-moe"
    jc = jconfigs.get_smoke(arch).with_(capacity_factor=1.0)
    tc = tconfigs.get_smoke(arch).with_(capacity_factor=1.0)
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    toks = np.random.default_rng(2).integers(0, 256, (2, 21)).astype(
        np.int32)
    dropped = []
    real = tmoe._dispatch_slots

    def counting(gate_idx, E, C):
        out = real(gate_idx, E, C)
        dropped.append(int((~out[1]).sum()))
        return out

    jprefill = jax.jit(functools.partial(jlm.prefill, cfg=jc, ctx=ShardCtx(),
                                         max_seq=32))
    jdecode = jax.jit(functools.partial(jlm.decode_step, cfg=jc,
                                        ctx=ShardCtx()))
    jlog, jcache = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tmoe._dispatch_slots = counting
    try:
        tlog, tcache = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                   tc, max_seq=32)
    finally:
        tmoe._dispatch_slots = real
    assert sum(dropped) > 0, dropped
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), atol=1e-4,
                               rtol=1e-4)
    tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    for _ in range(4):
        jlog, jcache = jdecode(jp, jcache, tok)
        tlog, tcache = tlm.decode_step(tp, tcache,
                                       torch.from_numpy(np.array(tok)), tc)
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), atol=1e-4,
                                   rtol=1e-4)
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)


def _leaf(tree, name: str):
    leaf, group = tree, None
    for part in name.split("."):
        if part.isdigit():
            group = int(part)
        else:
            leaf = leaf[part]
    return leaf if group is None else leaf[group]


@pytest.mark.parametrize("arch,microbatches", [
    (a, k) for a in MOE_ARCHS for k in (1, 2)])
def test_forward_loss_aux_and_gradients_match_reference(arch, microbatches):
    """``forward_loss``'s total, CE and load-balance loss, and every
    gradient of the total, at capacity factor 1.0 (pairs dropped); with 2
    microbatches each buckets its own tokens, the gradients averaged, as
    the reference's train step."""
    from repro_torch.launch import steps as tsteps

    over = dict(capacity_factor=1.0, microbatches=microbatches)
    jc = jconfigs.get_smoke(arch).with_(**over)
    tc = tconfigs.get_smoke(arch).with_(**over)
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    tp.requires_grad_(True)
    toks = np.random.default_rng(5).integers(0, 256, (4, 33)).astype(
        np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    vg = jax.value_and_grad(
        lambda p, mb: jlm.forward_loss(p, mb, jc, ShardCtx()), has_aux=True)

    @jax.jit
    def ref(p, batch):
        k = microbatches
        acc = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p)
        totals, parts = [], []
        for i in range(k):
            mb = jax.tree.map(
                lambda x: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i],
                batch)
            (total, part), g = vg(p, mb)
            acc = jax.tree.map(lambda a, x: a + x, acc, g)
            totals.append(total)
            parts.append(part)
        return (jnp.mean(jnp.stack(totals)), parts,
                jax.tree.map(lambda a: a / k, acc))

    jtotal, jparts, jgrads = ref(jp, {k: jnp.asarray(v) for k, v in
                                      b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    if microbatches == 1:
        total, parts = tlm.forward_loss(tp, tb, tc)
        np.testing.assert_allclose(float(total.detach()), float(jtotal),
                                   rtol=1e-5)
        for key in ("loss", "aux"):
            np.testing.assert_allclose(float(parts[key].detach()),
                                       float(jparts[0][key]), rtol=1e-5,
                                       err_msg=key)
        assert float(parts["aux"].detach()) > 0
    loss, grads = tsteps.loss_and_grads(tp, tb, tc)
    np.testing.assert_allclose(float(loss), float(jtotal), rtol=1e-5)
    assert set(grads) == {n for n, _ in tp.named_parameters()}
    for name, g in grads.items():
        np.testing.assert_allclose(g.detach().numpy(),
                                   _np(_leaf(jgrads, name)), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert float(grads["groups.0.p0.ffn.moe.router"].abs().max()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_full_recomputes_the_same_routing(arch):
    """``remat="full"`` recomputes each group's routing in the backward:
    the loss, aux and every gradient bit for bit the kept
    activations'."""
    from repro_torch.launch import steps as tsteps

    tc = tconfigs.get_smoke(arch).with_(capacity_factor=1.0)
    tp = tlm.init_lm(tc, torch.Generator().manual_seed(0), "cpu")
    tp.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 25)).astype(np.int32))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, grads = tsteps.loss_and_grads(tp, b, tc)
    rloss, rgrads = tsteps.loss_and_grads(tp, b, tc.with_(remat="full"))
    assert float(rloss) == float(loss)
    for name, g in grads.items():
        torch.testing.assert_close(rgrads[name], g, rtol=0, atol=0,
                                   msg=name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_reference_carries_the_experts_bit_for_bit(arch):
    """Every leaf, the router, the stacked experts and arctic's dense
    residual (``ffn.moe.*``, ``ffn.*_dense``) among them, carried by name
    from the JAX tree bit for bit."""
    jc, tc = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(1))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    names = {n for n, _ in tp.named_parameters()}
    want = {"groups.0.p0.ffn.moe.router", "groups.0.p0.ffn.moe.wi",
            "groups.0.p0.ffn.moe.wo"}
    if tc.dense_residual:
        want |= {"groups.0.p0.ffn.wi_dense", "groups.0.p0.ffn.wo_dense"}
    assert want <= names
    for name, p in tp.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(_leaf(jp, name)),
                                      err_msg=name)
