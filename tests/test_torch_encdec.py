"""The port's encoder-decoder and VLM paths, and the two dense archs that
join them, against the JAX package on the CPU at the smoke configs
(float32, d_model 64): seamless-m4t-medium (a 2-layer encoder over
projected frames, cross-attention in every decoder layer with a frozen
cache), llava-next-mistral-7b (projected patch embeddings before the
text), qwen1.5-4b (QKV bias, MHA) and chatglm3-6b (GQA 4/2, half-dim
interleaved RoPE).

Checked: configs; every weight carried by ``params_from_reference``;
``encode``, the cross-attention's forward and decode; prefill logits and
caches (the cross caches too) and 4 greedy decode steps; ``forward_loss``
and its gradients (the VLM's logits cut to the labels); the uniform loop
token for token; the ``Batcher`` against the JAX ``Batcher`` for the two
dense archs; and the graph builders' refusal of encoder-decoder and VLM
archs, which serve through the uniform loop in both packages.

Tolerances as in ``test_torch_lm.py``: 1e-4 for whole prefill / decode
logits and the losses' gradients (float32 sums in another order), 1e-5
for one layer; streams token for token."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import serve as jserve
from repro.models import blocks as jblocks
from repro.models import kvcache as jkv
from repro.models import lm as jlm
from repro.models.blocks import ShardCtx
from repro.runtime.batcher import Batcher as JBatcher
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_reference
from repro_torch.launch import steps as tsteps
from repro_torch.launch.serve import legacy_generate
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import kvcache as tkv
from repro_torch.models import lm as tlm
from repro_torch.runtime.batcher import Batcher

ARCHS = ["qwen1.5-4b", "chatglm3-6b", "seamless-m4t-medium",
         "llava-next-mistral-7b"]
FRONTEND = ["seamless-m4t-medium", "llava-next-mistral-7b"]
CTX = ShardCtx()
ENC = 16          # frames a request carries at the smoke size


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=1e-4, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=tol,
                               rtol=tol, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    """One arch's smoke model in both packages, the same weights."""
    jc, tc = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _frontend(cfg, B: int, seed: int) -> dict:
    """A request's frames (encoder-decoder) or patches (VLM), seeded."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": rng.standard_normal(
            (B, ENC, cfg.frontend_dim)).astype(np.float32)}
    if cfg.frontend_dim:
        return {"patches": rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)}
    return {}


def _split(b: dict):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _leaves(tree, prefix=()):
    """(port parameter name, JAX leaf) of every weight of a JAX tree, the
    stacks (``groups``, ``encoder``) split at their leading axis."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if k in ("groups", "encoder"):
                n = jax.tree.leaves(v)[0].shape[0]
                for g in range(n):
                    yield from _leaves(jax.tree.map(lambda x: x[g], v),
                                       prefix + (k, str(g)))
            else:
                yield from _leaves(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


# -- configs and weights ------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTEND)
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
    assert t.layer_groups() == j.layer_groups()
    assert t.padded_vocab() == j.padded_vocab(1)
    assert t.is_encdec == j.is_encdec


def test_published_head_counts_are_not_padded():
    """One device pads nothing: qwen1.5-4b keeps its 20 heads (the JAX
    package pads them to 32 only for a 16-way model axis), chatglm3-6b
    its 32/2 and a 64-dim half RoPE."""
    q, g = tconfigs.get("qwen1.5-4b"), tconfigs.get("chatglm3-6b")
    assert (q.padded_heads(), q.padded_kv_heads()) == (20, 20)
    assert (g.padded_heads(), g.padded_kv_heads()) == (32, 2)
    assert int(g.head_dim * g.rope_fraction) == 64
    assert g.rope_mode == "interleaved"


@pytest.mark.parametrize("arch", FRONTEND)
def test_params_from_reference_carries_every_leaf_bit_for_bit(arch):
    """Every leaf, the encoder's stack, ``frontend_proj``, ``enc_final``
    and each decoder layer's ``ln_cross``/``cross`` included; the
    port's tree has the reference's names and shapes and no more."""
    _, tc, jp, tp = _models(arch)
    want = dict(_leaves(jp))
    got = dict(tp.named_parameters())
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(v),
                                      err_msg=name)
    assert "frontend_proj" in got
    if tc.is_encdec:
        assert len(tp["encoder"]) == tc.enc_layers
        assert "enc_final.ln_b" in got
        assert "cross" in tp["groups"][0]["p0"]
        assert "bq" not in tp["groups"][0]["p0"]["cross"]
        assert "bq" in tp["groups"][0]["p0"]["attn"]
    else:
        assert "encoder" not in tp


@pytest.mark.parametrize("arch", FRONTEND)
def test_init_lm_mirrors_the_reference_tree(arch):
    jc, tc, jp, _ = _models(arch)
    lm = tlm.init_lm(tc, torch.Generator().manual_seed(0), "cpu")
    assert {n: tuple(p.shape) for n, p in lm.named_parameters()} == \
        {n: tuple(v.shape) for n, v in _leaves(jp)}
    assert tcommon.count_params(lm) == jlm.param_count(jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_of_the_published_config(arch):
    """Counted from shapes on the meta device, at the published widths."""
    assert tlm.param_count(tconfigs.get(arch)) == \
        jlm.param_count(jconfigs.get(arch))


# -- the encoder and the cross-attention -------------------------------------

def test_encode_matches_reference():
    jc, tc, jp, tp = _models("seamless-m4t-medium")
    frames = _frontend(tc, 2, seed=3)["frames"]
    want = jax.jit(lambda p, f: jlm.encode(p, f, jc, CTX))(
        jp, jnp.asarray(frames))
    got = tlm.encode(tp, torch.from_numpy(frames), tc)
    assert tuple(got.shape) == (2, ENC, tc.d_model)
    _close(got, want, 1e-5)


def test_cross_attention_matches_reference():
    """The cross block's forward (q from h, k/v from enc_out, no RoPE, no
    mask; 7 queries against 16 keys), its decode over the frozen cache
    at every query position, and the decode equal to the forward's row:
    the cache is read, never written."""
    jc, tc, jp, tp = _models("seamless-m4t-medium")
    jcross = jax.tree.map(lambda x: x[0], jp["groups"]["p0"]["cross"])
    tcross = tp["groups"][0]["p0"]["cross"]
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 7, tc.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, ENC, tc.d_model)).astype(np.float32)
    want = jblocks.attention_forward(jcross, jnp.asarray(h), jc, CTX,
                                     enc_out=jnp.asarray(enc))
    got = tblocks.attention_forward(tcross, torch.from_numpy(h), tc,
                                    enc_out=torch.from_numpy(enc))
    _close(got, want, 1e-5)

    k = np.einsum("bsd,dhk->bshk", enc, np.asarray(jcross["wk"]))
    v = np.einsum("bsd,dhk->bshk", enc, np.asarray(jcross["wv"]))
    jstore = jkv.kv_write_prefill(
        jkv.kv_make(2, ENC, tc.padded_kv_heads(), tc.head_dim, jnp.float32,
                    jc.kv_layout, jc.kv_order),
        jnp.asarray(k), jnp.asarray(v), jc.kv_layout, jc.kv_order)
    tstore = tkv.kv_write_prefill(
        tkv.kv_make(2, ENC, tc.padded_kv_heads(), tc.head_dim,
                    torch.float32, tc.kv_layout, tc.kv_order, "cpu"),
        torch.from_numpy(k), torch.from_numpy(v), tc.kv_layout,
        tc.kv_order)
    np.testing.assert_array_equal(tstore.numpy(), np.asarray(jstore))
    before = tstore.clone()
    for t in range(h.shape[1]):
        jo, _ = jblocks.attention_decode(jcross, jnp.asarray(h[:, t]),
                                         jstore, jnp.int32(t), jc, CTX,
                                         cross_len=ENC)
        to, store = tblocks.attention_decode(
            tcross, torch.from_numpy(h[:, t]), tstore, t, tc,
            cross_len=ENC)
        _close(to, jo, 1e-5)
        torch.testing.assert_close(to, got[:, t], rtol=1e-5, atol=1e-5)
        assert store is tstore
    torch.testing.assert_close(tstore, before, rtol=0, atol=0)


# -- whole models --------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTEND)
def test_prefill_and_decode_match_reference(arch):
    """Prefill of 2 x 21 tokens with their frames (16) or patches (8):
    logits and every cache (self and cross), then 4 greedy decode steps
    reading 16 cross slots."""
    jc, tc, jp, tp = _models(arch)
    toks = np.random.default_rng(2).integers(0, 256, (2, 21)).astype(
        np.int32)
    jb, tb = _split({"tokens": toks, **_frontend(tc, 2, seed=5)})
    max_seq = 32 + tc.frontend_tokens
    enc_len = ENC if tc.is_encdec else None
    jprefill = jax.jit(functools.partial(jlm.prefill, cfg=jc, ctx=CTX,
                                         max_seq=max_seq))
    jdecode = jax.jit(functools.partial(jlm.decode_step, cfg=jc, ctx=CTX,
                                        enc_len=enc_len))
    jlog, jcache = jprefill(jp, jb)
    tlog, tcache = tlm.prefill(tp, tb, tc, max_seq=max_seq)
    _close(tlog, jlog)
    S = 21 + tc.frontend_tokens
    assert int(tcache["pos"]) == int(jcache["pos"]) == S
    for g in range(tc.layer_groups()[0]):
        got = tcache["groups"][g]["p0"]
        want = jax.tree.map(lambda x: x[g], jcache["groups"]["p0"])
        if tc.is_encdec:
            assert set(got) == set(want) == {"self", "cross"}
            assert got["cross"].shape[1] == ENC
            for key in ("self", "cross"):
                _close(got[key], want[key], msg=key)
        else:
            _close(got, want)
    tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    for _ in range(4):
        ttok = torch.from_numpy(np.array(tok))
        jlog, jcache = jdecode(jp, jcache, tok)
        tlog, tcache = tlm.decode_step(tp, tcache, ttok, tc, enc_len=enc_len)
        _close(tlog, jlog)
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    assert int(tcache["pos"]) == S + 4


def test_decode_continues_one_prefill():
    """The frozen cross cache and the VLM's positions on the port alone:
    a prefill of P tokens then teacher-forced decode steps give the last
    logits of one prefill over all the tokens (the same frames or
    patches)."""
    for arch in FRONTEND:
        _, tc, _, tp = _models(arch)
        toks = torch.from_numpy(np.random.default_rng(6).integers(
            0, 256, (1, 12)).astype(np.int32))
        fr = {k: torch.from_numpy(v)
              for k, v in _frontend(tc, 1, seed=7).items()}
        max_seq = 12 + tc.frontend_tokens
        want = tlm.prefill(tp, {"tokens": toks, **fr}, tc,
                           max_seq=max_seq)[0]
        _, caches = tlm.prefill(tp, {"tokens": toks[:, :8], **fr}, tc,
                                max_seq=max_seq)
        for t in range(8, 12):
            logits, caches = tlm.decode_step(tp, caches, toks[:, t], tc)
        torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4,
                                   msg=arch)


@pytest.mark.parametrize("arch", FRONTEND)
def test_init_caches_mirror_the_reference(arch):
    """Empty caches: an encoder-decoder's attention entry is {"self",
    "cross"}, the cross storage of ``enc_len`` slots; shapes and dtypes
    those of the reference's (which stacks the groups)."""
    jc, tc, jp, tp = _models(arch)
    want = jlm.init_caches(jp, jc, 2, 12, CTX, enc_len=ENC)
    got = tlm.init_caches(tp, tc, 2, 12, "cpu", enc_len=ENC)
    for g in range(tc.layer_groups()[0]):
        w = jax.tree.map(lambda x: x[g], want["groups"]["p0"])
        c = got["groups"][g]["p0"]
        if tc.is_encdec:
            assert set(c) == {"self", "cross"}
            assert c["cross"].shape[1] == ENC
        for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(
                c, is_leaf=torch.is_tensor)):
            assert tuple(b.shape) == a.shape and not b.any()
    assert int(got["pos"]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_reference(arch):
    """``forward_loss`` (a VLM's logits cut to the text's labels) and the
    gradient of every weight, the encoder's and ``frontend_proj``'s
    included, against ``jax.value_and_grad``."""
    jc, tc, jp, _ = _models(arch)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    tp.requires_grad_(True)
    toks = np.random.default_rng(8).integers(0, 256, (2, 17)).astype(
        np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    jb, tb = _split({"tokens": toks[:, :-1], "labels": labels,
                     **_frontend(tc, 2, seed=9)})
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.forward_loss(p, b, jc, CTX), has_aux=True))(jp, jb)
    loss, parts = tlm.forward_loss(tp, tb, tc)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert parts["aux"].item() == 0.0
    names, leaves = zip(*tp.named_parameters())
    want = dict(_leaves(jgrads))
    for name, g in zip(names, torch.autograd.grad(loss, leaves)):
        np.testing.assert_allclose(g.numpy(), _np(want[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("arch", FRONTEND)
def test_remat_full_equals_none(arch):
    """``remat="full"`` recomputes each encoder layer and decoder group in
    the backward: the same loss and gradients bit for bit."""
    _, tc, jp, _ = _models(arch)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    tp.requires_grad_(True)
    toks = np.random.default_rng(10).integers(0, 256, (2, 9)).astype(
        np.int32)
    _, tb = _split({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    **_frontend(tc, 2, seed=11)})
    loss, grads = tsteps.loss_and_grads(tp, tb, tc)
    rloss, rgrads = tsteps.loss_and_grads(tp, tb, tc.with_(remat="full"))
    assert float(rloss) == float(loss)
    for name, g in grads.items():
        torch.testing.assert_close(rgrads[name], g, rtol=0, atol=0,
                                   msg=name)


@pytest.mark.parametrize("arch", FRONTEND)
def test_assemble_input_matches_reference(arch):
    """(h, positions, enc_out): the patches projected before the tokens,
    positions over both; the encoder's output for the frames."""
    jc, tc, jp, tp = _models(arch)
    toks = np.arange(10, dtype=np.int32).reshape(2, 5)
    jb, tb = _split({"tokens": toks, **_frontend(tc, 2, seed=12)})
    jh, jpos, jenc = jax.jit(
        lambda p, b: jlm.assemble_input(p, b, jc, CTX))(jp, jb)
    th, tpos, tenc = tlm.assemble_input(tp, tb, tc)
    _close(th, jh, 1e-5)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert th.shape[1] == 5 + tc.frontend_tokens
    if tc.is_encdec:
        _close(tenc, jenc, 1e-5)
    else:
        assert tenc is None and jenc is None


# -- serving --------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTEND)
def test_legacy_generate_matches_reference(arch):
    """The uniform loop, token for token: 3 prompts of 6 tokens with
    their frames or patches, 5 tokens each (the port prefills each row
    alone and stacks the caches, the {"self", "cross"} entries on both
    keys)."""
    jc, tc, jp, tp = _models(arch)
    toks = np.random.default_rng(13).integers(1, 256, (3, 6)).astype(
        np.int32)
    fr = _frontend(tc, 3, seed=14)
    max_seq = 6 + 5 + tc.frontend_tokens
    want, _, _ = jserve.legacy_generate(
        jc, jp, {"tokens": jnp.asarray(toks),
                 **{k: jnp.asarray(v) for k, v in fr.items()}}, 5, max_seq)
    got, _, _ = legacy_generate(
        tc, tp, torch.from_numpy(toks), 5, max_seq,
        **{k: torch.from_numpy(v) for k, v in fr.items()})
    np.testing.assert_array_equal(got, want)


MAX_SEQ = 20
LENGTHS, WANT = (3, 5, 3, 5, 4), (4, 3, 4, 2, 5)


@pytest.mark.parametrize("arch,kv_layout", [("qwen1.5-4b", "AOS"),
                                            ("chatglm3-6b", "SOA")])
def test_batcher_matches_reference_batcher(arch, kv_layout):
    """Ragged prompts (2 slots, 5 requests) through the port's default
    ``Batcher`` and the JAX ``Batcher``: the same streams (QKV bias and
    chatglm3's partial interleaved RoPE at per-slot positions)."""
    from repro_torch.core.layout import Layout

    jc, tc, jp, tp = _models(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tc.vocab_size, (L,)).astype(np.int32)
               for L in LENGTHS]

    def serve(b):
        reqs = [b.submit(p, max_new_tokens=n) for p, n in zip(prompts, WANT)]
        b.run()
        return [r.generated for r in reqs]

    refs = serve(JBatcher(jc, jp, batch=2, max_seq=MAX_SEQ,
                          log=lambda *_: None))
    tc = tc.with_(kv_layout=getattr(Layout, kv_layout))
    assert serve(Batcher(tc, tp, batch=2, max_seq=MAX_SEQ)) == refs


@pytest.mark.parametrize("arch", FRONTEND)
def test_graph_serving_refuses_encoder_decoder_and_vlm(arch):
    """As ``tests/test_serving.py``'s refusal: the decode graph builder,
    the prefill graph builder and so the ``Batcher`` refuse these archs,
    naming the uniform loop they serve through."""
    _, tc, _, tp = _models(arch)
    with pytest.raises(NotImplementedError, match="uniform loop"):
        tsteps.make_decode_graph(tc, tp, batch=1, max_seq=8)
    with pytest.raises(NotImplementedError, match="uniform loop"):
        tsteps.make_prefill_graph(tc, tp, prompt_len=4, max_seq=8)
    with pytest.raises(NotImplementedError, match="uniform loop"):
        Batcher(tc, tp, batch=1, max_seq=8)


def test_make_decode_step_reads_enc_len_serve_slots():
    """The legacy loop's step reads ``ENC_LEN_SERVE`` cross slots, as the
    reference's; a cache of that many slots with all but 16 zeroed gives
    other logits than one read at 16 (the padding is read)."""
    assert tsteps.ENC_LEN_SERVE == 4096
    _, tc, _, tp = _models("seamless-m4t-medium")
    toks = torch.arange(1, 5, dtype=torch.int32)[None]
    fr = {k: torch.from_numpy(v)
          for k, v in _frontend(tc, 1, seed=15).items()}
    _, caches = tlm.prefill(tp, {"tokens": toks, **fr}, tc, max_seq=8)
    want, _ = tlm.decode_step(tp, caches, toks[:, -1], tc, enc_len=ENC)
    got, _ = tsteps.make_decode_step(tc)(tp, caches, toks[:, -1])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    padded = {**caches, "groups": [
        {"p0": {"self": g["p0"]["self"], "cross": torch.cat(
            [g["p0"]["cross"], torch.zeros_like(g["p0"]["cross"])], 1)}}
        for g in caches["groups"]]}
    wrong, _ = tlm.decode_step(tp, padded, toks[:, -1], tc, enc_len=2 * ENC)
    assert float((wrong - want).abs().max()) > 1e-3
    same, _ = tlm.decode_step(tp, padded, toks[:, -1], tc, enc_len=ENC)
    torch.testing.assert_close(same, want, rtol=1e-6, atol=1e-6)
