"""gemma3-12b's and recurrentgemma-9b's layers on the port against the JAX
package on the CPU: sliding-window "L" attention over its ring cache, the
sandwich norms, RG-LRU "R" layers, and both models served by the
``Batcher`` with a window small enough that the ring wraps in prefill and
in decode; then, for kinds "M" (mamba2-130m) and "R", prompts shorter
than the conv window (1 and 2 tokens) prefilled and decoded against the
decode from a zero state, also through the ``Batcher``.  Inputs are made
with numpy from a seed and handed to both.

Tolerances: the ring cache's prefill write bit for bit (the same values
placed); RG-LRU in float32 1e-5 (the port's doubling scan and XLA's
associative scan combine in another tree, so they agree to rounding, not
bit for bit); one attention decode step 1e-5; whole prefill and decode
logits 1e-4 (several layers of sums in another order); the served streams
token for token."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core.layout import Layout as JLayout
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.blocks import ShardCtx
from repro.runtime.batcher import Batcher as JBatcher
import repro_torch.configs as tconfigs
from repro_torch.core.layout import Layout
from repro_torch.interop import params_from_reference
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.runtime.batcher import Batcher

ARCHS = ["gemma3-12b", "recurrentgemma-9b"]
CTX = ShardCtx()


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def _models(arch: str, window: int):
    """The arch's smoke model in both packages with the same weights, the
    window set to ``window`` on both sides."""
    jc = jconfigs.get_smoke(arch).with_(window=window)
    tc = tconfigs.get_smoke(arch).with_(window=window)
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("arch,want", [("gemma3-12b", 11_765_788_416),
                                       ("recurrentgemma-9b", 8_578_412_544)])
def test_published_param_counts(arch, want):
    assert tlm.param_count(tconfigs.get(arch)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_carries_every_leaf_bit_for_bit(arch):
    """Lambda, the block-diagonal gates and the post-norms go across by
    the generic walk, every leaf bit for bit."""
    _, tc, jp, tp = _models(arch, 16)
    got = dict(tp.named_parameters())
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        seen.add(keys[-1])
        leaf = np.asarray(leaf)
        if keys[0] == "groups":
            for g in range(leaf.shape[0]):
                name = ".".join(["groups", str(g)] + keys[1:])
                np.testing.assert_array_equal(got.pop(name).numpy(),
                                              leaf[g], err_msg=name)
        else:
            name = ".".join(keys)
            np.testing.assert_array_equal(got.pop(name).numpy(), leaf,
                                          err_msg=name)
    assert not got
    assert {"ln_mix_post", "ln_ffn_post"} <= seen if tc.sandwich_norm \
        else {"lam", "gate_a", "gate_a_b", "gate_x", "gate_x_b"} <= seen


# -- RG-LRU --------------------------------------------------------------------

def _rglru_params():
    _, _, jp, tp = _models("recurrentgemma-9b", 16)
    return (jax.tree.map(lambda x: x[0], jp["groups"]["p0"]["rglru"]),
            tp["groups"][0]["p0"]["rglru"])


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_forward_matches_reference(carried):
    """y, the last h and the conv window; with a carried h and conv
    prefix (``init_state``/``conv_prefix``) or from zeros."""
    jp, tp = _rglru_params()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if carried:
        h0 = rng.standard_normal((2, 64)).astype(np.float32)
        cv = rng.standard_normal((2, 3, 64)).astype(np.float32)
        kw_j = dict(init_state=jnp.asarray(h0), conv_prefix=jnp.asarray(cv))
        kw_t = dict(init_state=torch.from_numpy(h0),
                    conv_prefix=torch.from_numpy(cv))
    jy, (jh, jcv) = jssm.rglru_forward(jp, jnp.asarray(x), **kw_j)
    ty, (th, tcv) = tssm.rglru_forward(tp, torch.from_numpy(x), **kw_t)
    assert th.dtype == torch.float32 and tuple(tcv.shape) == (2, 3, 64)
    for got, want in ((ty, jy), (th, jh), (tcv, jcv)):
        _close(got, want, 1e-5)


def test_rglru_decode_matches_reference_and_the_forward():
    """Decoding the last 6 tokens one by one from the forward's state of
    the first 31 gives the forward's outputs over all 37; each step
    equals the reference's ``rglru_decode``."""
    jp, tp = _rglru_params()
    x = np.random.default_rng(4).standard_normal((2, 37, 64)).astype(
        np.float32)
    tx = torch.from_numpy(x)
    y_all, _ = tssm.rglru_forward(tp, tx)
    _, state = tssm.rglru_forward(tp, tx[:, :31])
    jstate = tuple(jnp.asarray(s.numpy()) for s in state)
    for t in range(31, 37):
        y, state = tssm.rglru_decode(tp, tx[:, t], state)
        jy, jstate = jssm.rglru_decode(jp, jnp.asarray(x[:, t]), jstate)
        _close(y, y_all[:, t], 1e-5)
        _close(y, jy, 1e-5)
        for got, want in zip(state, jstate):
            _close(got, want, 1e-5)


@pytest.mark.parametrize("S", [1, 7, 64])
def test_linear_scan_equals_the_sequential_recurrence(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, S, 5)).astype(np.float32))
    h, want = torch.zeros(2, 5), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(tssm.linear_scan(a, b),
                               torch.stack(want, dim=1), rtol=1e-6,
                               atol=1e-6)


# -- the ring cache ------------------------------------------------------------

@pytest.mark.parametrize("prompt", [5, 13])
@pytest.mark.parametrize("order", ["bsh", "bhs"])
@pytest.mark.parametrize("layout", ["AOS", "SOA", "AOSOA"])
def test_ring_cache_matches_reference(layout, order, prompt):
    """A window-8 ring filled from a prompt shorter (5) and longer (13)
    than the window, bit for bit the reference's storage; then 12 decode
    steps of a local layer (per-slot positions, so the ring wraps at
    different steps per row), outputs and storage within 1e-5."""
    W, B = 8, 2
    jc, tc, jp, tp = _models("gemma3-12b", W)
    jc = jc.with_(kv_layout=getattr(JLayout, layout), kv_order=order,
                  rope_base=jc.rope_base_local)
    tc = tc.with_(kv_layout=getattr(Layout, layout), kv_order=order,
                  rope_base=tc.rope_base_local)
    jattn = jax.tree.map(lambda x: x[0], jp["groups"]["p0"]["attn"])
    tattn = tp["groups"][0]["p0"]["attn"]
    rng = np.random.default_rng(5)
    k, v = (rng.standard_normal((B, prompt, 2, 16)).astype(np.float32)
            for _ in range(2))
    jring = jblocks.fill_attn_cache(
        jblocks.make_attn_cache(jc, B, 32, W, jnp.float32),
        jnp.asarray(k), jnp.asarray(v), jc, W)
    tring = tblocks.fill_attn_cache(
        tblocks.make_attn_cache(tc, B, 32, W, torch.float32, "cpu"),
        torch.from_numpy(k), torch.from_numpy(v), tc, W)
    np.testing.assert_array_equal(tring.numpy(), np.asarray(jring))
    pos = np.array([prompt, prompt + 3], np.int32)
    for _ in range(12):
        h = (0.3 * rng.standard_normal((B, 64))).astype(np.float32)
        jo, jring = jblocks.attention_decode(jattn, jnp.asarray(h), jring,
                                             jnp.asarray(pos), jc, CTX,
                                             window=W)
        to, tring = tblocks.attention_decode(tattn, torch.from_numpy(h),
                                             tring, torch.from_numpy(pos),
                                             tc, window=W)
        _close(to, jo, 1e-5)
        _close(tring, jring, 1e-5)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_past_the_wrap_match_reference(arch):
    """Window 8: a 13-token prompt wraps the ring in prefill, and 12
    decode steps wrap it again; logits at every step and the final
    caches within 1e-4."""
    jc, tc, jp, tp = _models(arch, 8)
    toks = np.random.default_rng(6).integers(0, 256, (2, 13)).astype(
        np.int32)
    jprefill = jax.jit(functools.partial(jlm.prefill, cfg=jc, ctx=CTX,
                                         max_seq=32))
    jdecode = jax.jit(functools.partial(jlm.decode_step, cfg=jc, ctx=CTX))
    jlog, jcache = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tlog, tcache = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                               max_seq=32)
    _close(tlog, jlog, 1e-4)
    tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    for _ in range(12):
        jlog, jcache = jdecode(jp, jcache, tok)
        tlog, tcache = tlm.decode_step(tp, tcache,
                                       torch.from_numpy(np.array(tok)), tc)
        _close(tlog, jlog, 1e-4)
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    n_groups, pattern, tail = tc.layer_groups()
    for i, kind in enumerate(pattern):
        for g in range(n_groups):
            want = jax.tree.map(lambda x: x[g], jcache["groups"][f"p{i}"])
            got = tcache["groups"][g][f"p{i}"]
            got = [got] if torch.is_tensor(got) else list(got)
            if kind == "L":
                assert got[0].shape[1] == 8       # (B, W, Hkv, 2 hd)
            for a, b in zip(got, jax.tree.leaves(want)):
                _close(a, b, 1e-4)
    for got, want in zip(tcache["tail"], jcache["tail"]):
        for a, b in zip(got, want):
            _close(a, b, 1e-4)


# -- serving -------------------------------------------------------------------

MAX_SEQ = 20
LENGTHS, WANT = (3, 5, 3, 5, 4), (4, 3, 4, 2, 5)


def _serve(batcher, prompts):
    reqs = [batcher.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, WANT)]
    batcher.run()
    return [r.generated for r in reqs]


@functools.lru_cache(maxsize=None)
def _reference_streams(arch: str):
    """Ragged prompts (2 slots, 5 requests) through the JAX ``Batcher``
    with window 4: 5-token prompts wrap the ring in prefill and every
    request wraps it in decode."""
    jc, tc, jp, _ = _models(arch, 4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tc.vocab_size, (L,)).astype(np.int32)
               for L in LENGTHS]
    jb = JBatcher(jc, jp, batch=2, max_seq=MAX_SEQ, log=lambda *_: None)
    return prompts, _serve(jb, prompts)


@pytest.mark.parametrize("kv_layout", ["AOS", "SOA", "AOSOA"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_matches_reference_batcher(arch, kv_layout):
    """The port's ``Batcher`` (its default executor, and per-segment
    dispatch for AoS) gives the JAX ``Batcher``'s streams token for token,
    with the KV caches in each layout."""
    _, tc, _, tp = _models(arch, 4)
    prompts, refs = _reference_streams(arch)
    tc = tc.with_(kv_layout=getattr(Layout, kv_layout))
    assert _serve(Batcher(tc, tp, batch=2, max_seq=MAX_SEQ), prompts) == refs
    if kv_layout == "AOS":
        eager = Batcher(tc, tp, batch=2, max_seq=MAX_SEQ,
                        executor_opts={"regions": False})
        assert _serve(eager, prompts) == refs


# -- prompts shorter than the conv window --------------------------------------

def _decode_from_zero(tc, tp, toks, max_seq):
    """Every position's logits, the whole sequence decoded token by token
    from empty caches (zero SSM, RG-LRU and conv states)."""
    caches = tlm.init_caches(tp, tc, toks.shape[0], max_seq, "cpu")
    out = []
    for t in range(toks.shape[1]):
        logits, caches = tlm.decode_step(tp, caches, toks[:, t], tc)
        out.append(logits)
    return out


@pytest.mark.parametrize("prompt", [1, 2])
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_prompt_shorter_than_the_conv_window_then_decode(arch, prompt):
    """A prompt of fewer than ``d_conv - 1`` tokens (kinds "M" and "R"),
    prefilled and then decoded, gives the logits of the token-by-token
    decode from a zero state at every position: the prefill's conv state
    is the zero-padded window (the reference cannot decode here; ROADMAP,
    faults of the port against the reference)."""
    tc = tconfigs.get_smoke(arch)
    assert prompt < tc.d_conv - 1
    tp = tlm.init_lm(tc, torch.Generator().manual_seed(0), "cpu")
    n = prompt + 4
    toks = torch.from_numpy(np.random.default_rng(prompt).integers(
        1, tc.vocab_size, (2, n)).astype(np.int32))
    logits, caches = tlm.prefill(tp, {"tokens": toks[:, :prompt]}, tc,
                                 max_seq=n)
    got = [logits]
    for t in range(prompt, n - 1):
        logits, caches = tlm.decode_step(tp, caches, toks[:, t], tc)
        got.append(logits)
    want = _decode_from_zero(tc, tp, toks, n)[prompt - 1:n - 1]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_batcher_serves_prompts_shorter_than_the_conv_window(arch):
    """1- and 2-token prompts through the default ``Batcher``: each
    stream is the greedy stream of the decode from a zero state."""
    tc = tconfigs.get_smoke(arch)
    tp = tlm.init_lm(tc, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, tc.vocab_size, (L,)).astype(np.int32)
               for L in (1, 2, 1, 2)]
    gen = 5
    b = Batcher(tc, tp, batch=2, max_seq=MAX_SEQ)
    reqs = [b.submit(p, max_new_tokens=gen) for p in prompts]
    b.run()
    for p, r in zip(prompts, reqs):
        toks = torch.from_numpy(p[None])
        caches = tlm.init_caches(tp, tc, 1, MAX_SEQ, "cpu")
        for t in range(len(p)):
            logits, caches = tlm.decode_step(tp, caches, toks[:, t], tc)
        want = []
        for _ in range(gen):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            want.append(int(nxt))
            logits, caches = tlm.decode_step(tp, caches, nxt, tc)
        assert r.generated == want
