"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the CPU: the capacity, the dispatch
slots (slot, keep, order), ``moe_block``'s output and load-balance loss,
and the gradients of ``sum(out * r) + aux`` with respect to the tokens,
the router and both expert weights against ``jax.grad``.  Cases: dropless,
capacity factors 0.25 and 1.25 (pairs dropped), a zero router (every
expert tied: the lower index wins in both), top-k 1 and 2, and a token
count that is no multiple of the expert count.

Tolerances: float32 atol/rtol 1e-5 (sums in another order); bfloat16
2e-2 (the golden bfloat16 limit); slots, masks and orders exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.common import ParamTree
from repro_torch.models import moe as tmoe
from repro_torch.models.common import Init, ParamModule

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(E, d=32, f=48, zero_router=False):
    pt = ParamTree(jax.random.PRNGKey(0))
    jmoe.init_moe(pt, d_model=d, d_ff=f, n_experts=E, name="moe")
    jp = {k: np.asarray(v) for k, v in pt.params["moe"].items()}
    if zero_router:
        jp["router"] = np.zeros_like(jp["router"])
    return jp


def _torch_params(jp, dtype=torch.float32):
    return {k: torch.tensor(v, dtype=dtype) for k, v in jp.items()}


@pytest.mark.parametrize("T,E,K,cf", [(48, 8, 2, 1.25), (13, 4, 1, 0.25),
                                      (2048, 128, 2, 1.25),
                                      (2048, 16, 2, 1.25), (4, 16, 2, 8.0)])
def test_moe_capacity_matches_reference(T, E, K, cf):
    assert tmoe.moe_capacity(T, E, K, cf) == jmoe.moe_capacity(T, E, K, cf)


@pytest.mark.parametrize("T,E,K,C", [(48, 8, 2, 8), (37, 4, 2, 8),
                                     (20, 8, 1, 16), (64, 4, 2, 96)])
def test_dispatch_slots_match_reference(T, E, K, C):
    """Slot, keep mask and sort order exactly, ties among equal experts
    kept in (token, k) order by both stable sorts."""
    idx = np.random.default_rng(T).integers(0, E, (T, K)).astype(np.int32)
    want = jmoe._dispatch_slots(jnp.asarray(idx), E, C)
    got = tmoe._dispatch_slots(torch.from_numpy(idx).long(), E, C)
    for w, g in zip(want, got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


CASES = {
    "dropless": dict(T=48, E=8, K=2, dropless=True),
    "capacity 1.25": dict(T=48, E=8, K=2, cf=1.25),
    "capacity 0.25 drops": dict(T=48, E=4, K=2, cf=0.25),
    "zero router ties": dict(T=40, E=4, K=2, cf=1.25, zero_router=True),
    "top-1": dict(T=32, E=4, K=1, cf=1.25),
    "T no multiple of E": dict(T=37, E=8, K=2, cf=1.25),
    "top-1 dropless ties": dict(T=21, E=4, K=1, dropless=True,
                                zero_router=True),
}


def _case(name, seed=0):
    c = CASES[name]
    jp = _params(c["E"], zero_router=c.get("zero_router", False))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c["T"], 32)).astype(np.float32)
    kw = dict(top_k=c["K"], capacity_factor=c.get("cf", 1.25),
              dropless=c.get("dropless", False))
    return jp, x, kw


@pytest.mark.parametrize("name", list(CASES))
def test_moe_block_matches_reference(name):
    """Output and aux at float32; where pairs are dropped, the dropped
    tokens' rows are those of the reference."""
    jp, x, kw = _case(name)
    # the JAX side compiled whole: op by op it costs seconds a case
    want, jaux = jax.jit(functools.partial(jmoe.moe_block, **kw))(
        jp, jnp.asarray(x))
    got, aux = tmoe.moe_block(_torch_params(jp), torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert aux.dtype == torch.float32 and got.dtype == torch.float32
    if name == "capacity 0.25 drops":
        dropped = np.linalg.norm(_np(want), axis=-1) == 0
        assert dropped.any()
        np.testing.assert_array_equal(
            np.linalg.norm(got.numpy(), axis=-1) == 0, dropped)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_block_gradients_match_reference(name):
    """d/d(x, router, wi, wo) of sum(out * r) + aux against jax.grad."""
    jp, x, kw = _case(name)
    r = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_block(p, x, **kw)
        return jnp.sum(out * r) + aux

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _torch_params(jp).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_block(tp, tx, **kw)
    (out * torch.from_numpy(r)).sum().add(aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jg_x), atol=1e-5,
                               rtol=1e-5)
    for k in ("router", "wi", "wo"):
        np.testing.assert_allclose(tp[k].grad.numpy(), _np(jg_p[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["capacity 1.25", "dropless"])
def test_moe_block_bfloat16_matches_reference(name):
    """bfloat16 tokens and weights: the buffer, the expert products and
    the weighted pairs rounded where the reference rounds them."""
    jp, x, kw = _case(name)
    jpb = {k: jnp.asarray(v, jnp.bfloat16) for k, v in jp.items()}
    want, jaux = jax.jit(functools.partial(jmoe.moe_block, **kw))(
        jpb, jnp.asarray(x, jnp.bfloat16))
    got, aux = tmoe.moe_block(_torch_params(jp, torch.bfloat16),
                              torch.from_numpy(x).to(torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_init_moe_mirrors_the_reference():
    """Names, shapes and fan-in scaling of the router and the experts."""
    p = ParamModule()
    tmoe.init_moe(Init(torch.Generator().manual_seed(0), torch.float32,
                       "cpu"), p, d_model=32, d_ff=48, n_experts=8)
    jp = _params(8)
    got = {n: tuple(v.shape) for n, v in p["moe"].named_parameters()}
    assert got == {k: v.shape for k, v in jp.items()}
    for name, fan_in in (("router", 32), ("wi", 32), ("wo", 48)):
        assert float(p["moe"][name].abs().max()) <= 2 / np.sqrt(fan_in)


def test_moe_dropless_matches_per_token_loop():
    """Dropless routing equals each token through its top-2 experts,
    weighted by its renormalised router probabilities (the reference's
    ``test_moe_dropless_matches_per_token_loop`` on the port)."""
    jp = _params(8, f=64)
    p = _torch_params(jp)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((48, 32), dtype=np.float32)
                         * 0.5)
    out, aux = tmoe.moe_block(p, x, top_k=2, dropless=True)
    probs = torch.softmax(x @ p["router"], -1)
    w, idx = torch.topk(probs, 2)
    w = w / w.sum(-1, keepdim=True)
    for t in range(0, 48, 7):
        acc = 0
        for j in range(2):
            e = int(idx[t, j])
            h = torch.einsum("d,dtf->tf", x[t], p["wi"][e])
            h = torch.nn.functional.silu(h[0]) * h[1]
            acc = acc + w[t, j] * (h @ p["wo"][e])
        np.testing.assert_allclose(out[t].numpy(), acc.numpy(), rtol=2e-3,
                                   atol=2e-4)
    assert float(aux) > 0


# -- serving: the Batcher, the uniform loop, the launcher --------------------

MAX_SEQ = 28
LENGTHS, WANT = (3, 12, 5, 9, 16), (4, 3, 4, 2, 5)


@functools.lru_cache(maxsize=None)
def _served(arch: str):
    """The arch's smoke model at capacity factor 1.0 (a 16-token prompt's
    prefill drops pairs) in both packages with the same weights, ragged
    prompts, and the JAX ``Batcher``'s streams (2 slots, 5 requests)."""
    import repro.configs as jconfigs
    from repro.models import lm as jlm
    from repro.runtime.batcher import Batcher as JBatcher
    import repro_torch.configs as tconfigs
    from repro_torch.interop import params_from_reference

    jc = jconfigs.get_smoke(arch).with_(capacity_factor=1.0)
    tc = tconfigs.get_smoke(arch).with_(capacity_factor=1.0)
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tc.vocab_size, (L,)).astype(np.int32)
               for L in LENGTHS]
    jb = JBatcher(jc, jp, batch=2, max_seq=MAX_SEQ, log=lambda *_: None)
    return tc, tp, prompts, _streams(jb, prompts, WANT)


def _streams(batcher, prompts, want_n):
    reqs = [batcher.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, want_n)]
    batcher.run()
    assert all(r.status == "done" for r in reqs)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("arch", ["phi3.5-moe", "arctic-480b"])
def test_batcher_matches_reference_batcher_and_the_uniform_loop(arch):
    """The port's default ``Batcher`` gives the JAX ``Batcher``'s streams
    (each prefill buckets its own request's tokens, the decode routes
    dropless), and each request alone through ``legacy_generate`` gives
    the same stream."""
    from repro_torch.launch.serve import legacy_generate
    from repro_torch.runtime.batcher import Batcher

    tc, tp, prompts, refs = _served(arch)
    got = _streams(Batcher(tc, tp, batch=2, max_seq=MAX_SEQ), prompts, WANT)
    assert got == refs
    for p, n, want in zip(prompts, WANT, got):
        gen, _, _ = legacy_generate(tc, tp, torch.from_numpy(p[None]), n,
                                    MAX_SEQ)
        assert gen[0].tolist() == want


def test_a_slots_stream_does_not_depend_on_its_neighbours():
    """phi3.5-moe: a request served alone, beside each other request, and
    beside a copy of itself gives one stream: the decode's dropless
    buckets hold every slot's pairs whatever the other slots route."""
    from repro_torch.runtime.batcher import Batcher

    tc, tp, prompts, refs = _served("phi3.5-moe")
    first, n = prompts[1], 6
    alone = _streams(Batcher(tc, tp, batch=2, max_seq=MAX_SEQ), [first],
                     [n])[0]
    for other in prompts[:1] + prompts[2:] + [first]:
        both = _streams(Batcher(tc, tp, batch=2, max_seq=MAX_SEQ),
                        [first, other], [n, 6])
        assert both[0] == alone
    assert alone[:WANT[1]] == refs[1]


@pytest.mark.parametrize("flag", [None, "--chaos"])
def test_serve_smoke_on_the_cpu(flag, capsys):
    """``launch/serve.py --arch phi3.5-moe --smoke``: the Batcher's streams
    equal the uniform loop's, one decode capture, a fresh worker with none;
    with ``--chaos`` the request-log replay gives the same streams."""
    from repro_torch.launch import serve as tserve

    flags = ["--arch", "phi3.5-moe", "--smoke", "--batch", "2",
             "--prompt-len", "8", "--gen", "6", "--device", "cpu"]
    gen = tserve.main(flags + ([flag] if flag else []))
    out = capsys.readouterr().out
    assert "[smoke] ripple == legacy argmax sequences  OK" in out
    assert "[smoke] fresh worker served with 0 new decode captures  OK" \
        in out
    if flag:
        assert "injected failures recovered; token streams identical  OK" \
            in out
    assert np.asarray(gen).shape == (2, 6)
