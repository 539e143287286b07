"""The port's training path against the JAX package on the CPU, at the
smoke configs (2-6 layers, d_model 64, float32): the loss and its pieces,
``param_count`` at the full configs (from shapes, no allocation), the
optimizers on identical gradients, the schedules and int8 compression, one
train step's loss, gradient norm and every gradient (also with
``microbatches=2``, and ``remat="full"`` against ``"none"``), and a 4-step
loss trajectory; then the grad guard of the K6/K7 wrappers and the plain
recompute behind their ``autograd.Function``s.

Tolerances: float32 sums in another order.  Losses rtol 1e-5; gradients
atol 1e-6 + rtol 1e-4 (two layers of backward sums); the optimizers 1e-6
relative in float32 and one bfloat16 step (2^-7 relative) for a bfloat16
parameter, whose float32 update is rounded once; the schedules 1e-6.
AdamW's first update is sign(g) * lr wherever |g| is tiny, so a gradient
that differs at rounding level can flip it: the trajectory is held by its
loss (rtol 1e-5), not by its parameters.  The launcher's batches for the
encoder-decoder and the VLM (frames, patches) are held bit for bit
against the reference launcher's, and it trains both smoke configs."""

import dataclasses
import functools
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models.blocks import ShardCtx
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_reference
from repro_torch.kernels._common import plain_vjp
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

ARCHS = ["qwen3-8b", "mamba2-130m", "gemma3-12b", "recurrentgemma-9b"]
CTX = ShardCtx()
B, S = 4, 32


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_leaf(tree, name: str):
    """The JAX tree's leaf for a port parameter name (the groups stacked
    on a leading axis there)."""
    leaf, group = tree, None
    for part in name.split("."):
        if part.isdigit():
            group = int(part)
        else:
            leaf = leaf[part]
    return leaf if group is None else leaf[group]


def _batch(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1          # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _models(arch, **over):
    jc = jconfigs.get_smoke(arch).with_(**over)
    tc = tconfigs.get_smoke(arch).with_(**over)
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    tp.requires_grad_(True)
    return jc, tc, jp, tp


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# -- the loss --------------------------------------------------------------

def test_ce_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(-1, 50, (3, 7)).astype(np.int32)
    got = tlm.ce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jlm.ce_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = np.full((3, 7), -1, np.int32)   # every position masked: 0
    assert float(tlm.ce_loss(torch.from_numpy(logits),
                             torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_full_config_allocates_nothing(arch):
    """At the published widths (qwen3-8b: 8.19e9 parameters, 16 GB in
    bfloat16), counted from shapes on the meta device."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    n = tlm.param_count(tconfigs.get(arch))
    grown_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert n == jlm.param_count(jconfigs.get(arch))
    assert grown_kib < 256 * 1024, grown_kib


# -- one step against the reference ------------------------------------------

def _jax_loss_and_grads(jc, jp, batch):
    """The reference train step's loss, gradients and clipped norm (its
    microbatch scan written out, as ``repro.launch.steps.make_train_step``
    computes them before the optimizer)."""
    k = jc.microbatches
    vg = jax.value_and_grad(
        lambda p, mb: jlm.forward_loss(p, mb, jc, CTX), has_aux=True)

    @jax.jit
    def run(p, b):
        aux = jnp.zeros((), jnp.float32)
        if k == 1:
            (loss, parts), g = vg(p, b)
            aux = parts["aux"]
        else:
            acc = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p)
            losses = []
            for i in range(k):
                mb = jax.tree.map(
                    lambda x: x.reshape(k, x.shape[0] // k,
                                        *x.shape[1:])[i], b)
                (loss, _), g = vg(p, mb)
                acc = jax.tree.map(lambda a, x: a + x.astype(a.dtype), acc,
                                   g)
                losses.append(loss)
            loss, g = jnp.mean(jnp.stack(losses)), jax.tree.map(
                lambda a: a / k, acc)
        return loss, aux, g, jopt.clip_by_global_norm(g, 1.0)[1]

    return run(jp, batch)


# microbatching is the same code for every arch: the local-layer archs,
# whose JAX side compiles slowest, take one microbatch, as do the archs
# that phase 3f of chip_smoke.py trains besides these (arctic-480b with
# its load-balance loss, through Adafactor)
@pytest.mark.parametrize("arch,microbatches", [
    (arch, k) for arch in ARCHS for k in (1, 2)
    if k == 1 or arch in ("qwen3-8b", "mamba2-130m")] + [
    (arch, 1) for arch in ("qwen1.5-4b", "chatglm3-6b", "arctic-480b")])
def test_train_step_matches_reference(arch, microbatches):
    """``forward_loss`` and its parts, then one train step's loss, every
    gradient, the clipped norm and the step counter."""
    jc, tc, jp, tp = _models(arch, microbatches=microbatches)
    b = _batch(tc, seed=1)
    jloss, jaux, jgrads, jgnorm = _jax_loss_and_grads(jc, jp, _jbatch(b))
    if microbatches == 1:
        total, parts = tlm.forward_loss(tp, _tbatch(b), tc)
        # jloss is the reference's objective: CE + 0.01 aux
        np.testing.assert_allclose(total.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(parts["loss"].item(),
                                   float(jloss) - 0.01 * float(jaux),
                                   rtol=1e-5)
        if tc.n_experts:
            np.testing.assert_allclose(parts["aux"].item(), float(jaux),
                                       rtol=1e-5)
        else:
            assert parts["aux"].item() == float(jaux) == 0.0
    loss, grads = tsteps.loss_and_grads(tp, _tbatch(b), tc)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(grads) == {n for n, _ in tp.named_parameters()}
    for name, g in grads.items():
        np.testing.assert_allclose(g.detach().numpy(),
                                   _np(_jax_leaf(jgrads, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)

    step, opt = tsteps.make_train_step(tc, total_steps=100, device="cpu")
    state = {"params": tp, "opt": opt.init(tp),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = step(state, b)
    for key, want in (("loss", jloss), ("grad_norm", jgnorm)):
        assert m[key].dtype == torch.float32
        np.testing.assert_allclose(float(m[key]), float(want), rtol=1e-5,
                                   err_msg=key)
    assert int(state["step"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_none(arch):
    _, tc, _, tp = _models(arch)
    b = _tbatch(_batch(tc, seed=2))
    loss, grads = tsteps.loss_and_grads(tp, b, tc)
    rloss, rgrads = tsteps.loss_and_grads(tp, b, tc.with_(remat="full"))
    assert float(rloss) == float(loss)
    for name, g in grads.items():
        torch.testing.assert_close(rgrads[name], g, rtol=0, atol=0,
                                   msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_four_step_loss_trajectory_matches_reference(arch):
    jc, tc, jp, tp = _models(arch)
    b = _batch(tc, seed=3)
    step, opt = tsteps.make_train_step(tc, lr=1e-2, device="cpu")
    state = {"params": tp, "opt": opt.init(tp),
             "step": torch.zeros((), dtype=torch.int32)}
    jstep, jo = jsteps.make_train_step(jc, None, lr=1e-2)
    jstep = jax.jit(jstep)
    jstate = {"params": jp, "opt": jo.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    got, want = [], []
    for _ in range(4):
        state, m = step(state, b)
        jstate, jm = jstep(jstate, _jbatch(b))
        got.append(float(m["loss"]))
        want.append(float(jm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


# -- optimizers, schedules, compression --------------------------------------

def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "t": rng.standard_normal((2, 3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_on_identical_grads(name, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p0 = _params()
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    lr = jsched.cosine_schedule(1e-2, 2, 10)
    jo = jopt.make_optimizer(name, lr, weight_decay=0.1)
    to = topt.make_optimizer(name, tsched.cosine_schedule(1e-2, 2, 10),
                             weight_decay=0.1)
    js, ts = jo.init(jp), to.init(tp)
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    for i in range(3):
        g = _params(seed=10 + i)
        jp, js = jo.update({k: jnp.asarray(v).astype(jdt)
                            for k, v in g.items()}, js, jp,
                           jnp.asarray(i, jnp.int32))
        to.update({k: torch.from_numpy(v).to(tdt) for k, v in g.items()},
                  ts, tp, torch.tensor(i, dtype=torch.int32))
        for k in p0:
            assert tp[k].dtype == tdt
            np.testing.assert_allclose(tp[k].float().numpy(), _np(jp[k]),
                                       rtol=rtol, atol=1e-7, err_msg=k)
    for path, leaf in jax.tree_util.tree_flatten_with_path(js)[0]:
        keys = [p.key for p in path]
        got = ts
        for key in keys:
            got = got[key]
        np.testing.assert_allclose(got.numpy(), _np(leaf), rtol=1e-5,
                                   atol=1e-12, err_msg=str(keys))


def test_make_optimizer_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("sgd", 1e-3)


def test_clip_by_global_norm_matches_reference():
    g = _params(seed=4)
    for max_norm in (0.5, 1e3):
        got, gn = topt.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        want, jgn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), _np(want[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "clip"])
def test_optimizers_in_row_blocks_match_reference(name, monkeypatch):
    """A tensor above ``_BLOCK`` elements is updated in blocks of leading
    rows (what keeps arctic-480b's float32 temporaries to one expert):
    with ``_BLOCK`` at 30 the (5, 4, 6), (9, 5) and per-group (3, 4, 5)
    parameters go in blocks, and the updates, the state and the clipped
    gradients (scaled in place, a tensor under two names once) still
    match the reference's whole-tensor formulas, over its tree with the
    groups stacked (``groups.1.s`` is row 1 of its ``groups.s``)."""
    monkeypatch.setattr(topt, "_BLOCK", 30)
    rng = np.random.default_rng(5)
    shapes = {"t": (5, 4, 6), "w": (9, 5), "b": (7,),
              "groups.0.s": (3, 4, 5), "groups.1.s": (3, 4, 5),
              "groups.0.v": (7,), "groups.1.v": (7,)}

    def draw():
        return {k: rng.standard_normal(sh).astype(np.float32)
                for k, sh in shapes.items()}

    def jax_tree(d):
        tree = {k: jnp.asarray(v) for k, v in d.items() if "." not in k}
        tree["groups"] = {k: jnp.stack([jnp.asarray(d[f"groups.{i}.{k}"])
                                        for i in range(2)])
                          for k in ("s", "v")}
        return tree

    p0, grads = draw(), [draw() for _ in range(3)]
    if name == "clip":
        g = {k: torch.from_numpy(v.copy()) for k, v in grads[0].items()}
        g["t_again"] = g["t"]
        want, jgn = jopt.clip_by_global_norm(
            {**jax_tree(grads[0]), "t_again": jnp.asarray(grads[0]["t"])},
            0.5)
        got, gn = topt.clip_by_global_norm_(g, 0.5)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        for k in g:
            assert got[k] is g[k]
            np.testing.assert_allclose(got[k].numpy(),
                                       _np(_jax_leaf(want, k)), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        return
    jp = jax_tree(p0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jo = jopt.make_optimizer(name, 1e-2, weight_decay=0.1)
    to = topt.make_optimizer(name, 1e-2, weight_decay=0.1)
    js, ts = jo.init(jp), to.init(tp)
    for i, g in enumerate(grads):
        jp, js = jo.update(jax_tree(g), js, jp, jnp.asarray(i, jnp.int32))
        to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                  torch.tensor(i, dtype=torch.int32))
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), _np(_jax_leaf(jp, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # AdamW's moments by parameter; Adafactor's state by the reference's
    # leaf (the groups stacked)
    pairs = ([(ts[m][k], _jax_leaf(js[m], k)) for m in ("m", "v")
              for k in p0] if name == "adamw" else
             [(t, _jax_leaf(js, leaf)[key]) for leaf, st in ts.items()
              for key, t in st.items()])
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-12)


def test_adafactor_train_step_matches_reference():
    """arctic-480b's step (Adafactor, one microbatch, the load-balance
    loss): the parameters and the factored moments after two steps
    against the reference's train step on the same batch.  The
    reference's leaves stack the two layer groups, so a norm's scale is
    a (2, 64) matrix to its Adafactor (factored, one RMS over both
    groups), which the port's per-group (64,) vectors must follow."""
    jc, tc, jp, tp = _models("arctic-480b")
    assert tc.optimizer == "adafactor" and tc.microbatches == 1
    b = _batch(tc, seed=6)
    step, opt = tsteps.make_train_step(tc, lr=1e-2, device="cpu")
    state = {"params": tp, "opt": opt.init(tp),
             "step": torch.zeros((), dtype=torch.int32)}
    jstep, jo = jsteps.make_train_step(jc, None, lr=1e-2)
    jstep = jax.jit(jstep)
    jstate = {"params": jp, "opt": jo.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    for _ in range(2):
        state, m = step(state, b)
        jstate, jm = jstep(jstate, _jbatch(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    for name, p in tp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   _np(_jax_leaf(jstate["params"], name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    # the state is keyed by the reference's leaves: groups stacked
    for leaf, st in state["opt"].items():
        for key, got in st.items():
            np.testing.assert_allclose(
                got.numpy(), _np(_jax_leaf(jstate["opt"], leaf)[key]),
                rtol=1e-4, atol=1e-12, err_msg=f"{leaf} {key}")


@pytest.mark.parametrize("step", [0, 1, 5, 17, 99, 150])
def test_schedules_match_reference(step):
    for t, j in ((tsched.cosine_schedule(3e-4, 20, 100),
                  jsched.cosine_schedule(3e-4, 20, 100)),
                 (tsched.linear_warmup(1e-3, 10),
                  jsched.linear_warmup(1e-3, 10))):
        want = float(j(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(float(t(step)), want, rtol=1e-6)
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("seed,scale", [(0, 1e-4), (1, 1.0), (2, 37.5),
                                        (3, 1e3)])
def test_quantize_int8_matches_reference(seed, scale):
    x = (np.random.default_rng(seed).standard_normal(128)
         * scale).astype(np.float32)
    q, s = tcomp.quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    err = np.abs(tcomp.dequantize_int8(q, s).numpy() - x)
    assert err.max() <= float(s) / 2 + 1e-6      # round to nearest


def test_quantize_zero():
    q, s = tcomp.quantize_int8(torch.zeros(16))
    np.testing.assert_array_equal(tcomp.dequantize_int8(q, s).numpy(),
                                  np.zeros(16))


def test_error_feedback_accumulates_exactly():
    """With a constant gradient the mean of the dequantised series tends
    to the gradient, as the reference's test states."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(64)
                         .astype(np.float32))
    ef = tcomp.ErrorFeedbackState.init({"g": g})
    resid, total, n = ef.residual["g"], torch.zeros_like(g), 50
    for _ in range(n):
        eff = g + resid
        q, s = tcomp.quantize_int8(eff)
        g_hat = tcomp.dequantize_int8(q, s)
        resid = eff - g_hat
        total = total + g_hat
    np.testing.assert_allclose((total / n).numpy(), g.numpy(),
                               atol=float(s) / 2 / n * 3 + 1e-5)


# -- the kernels' gradients ---------------------------------------------------

def test_kernel_wrappers_refuse_an_input_that_requires_grad():
    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda

    q = torch.zeros(1, 2, 8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        flash_attention_cuda(q, q.detach(), q.detach())
    x = torch.zeros(1, 8, 2, 8, requires_grad=True)
    z = torch.zeros(1, 8, 8)
    with pytest.raises(RuntimeError, match="SsdIntraChunkFn"):
        ssd_intra_chunk_cuda(x, torch.zeros(1, 8, 2), torch.zeros(2), z, z,
                             chunk=8)
    with torch.no_grad():     # no gradient asked: the device check speaks
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(q, q, q)


def test_plain_vjp_is_the_plain_versions_gradient():
    """The backward of the K6/K7 Functions: the gradient of the plain
    version recomputed from the saved inputs, for the inputs that need
    one."""
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 16, 2, 4)).astype(
        np.float32))
    dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (1, 16, 2)).astype(
        np.float32))
    A = -torch.linspace(1.0, 4.0, 2)
    Bm, C = (torch.from_numpy(rng.standard_normal((1, 16, 3)).astype(
        np.float32)) for _ in range(2))
    gy = torch.from_numpy(rng.standard_normal((1, 16, 2, 4)).astype(
        np.float32))
    gs = torch.from_numpy(rng.standard_normal((1, 2, 2, 4, 3)).astype(
        np.float32))
    plain = functools.partial(ssd_intra_chunk_ref, chunk=8)
    needs = (True, True, False, True, True)
    got = plain_vjp(plain, (x, dt, A, Bm, C), needs, (gy, gs))
    ins = [t.clone().requires_grad_(n) for t, n in
           zip((x, dt, A, Bm, C), needs)]
    y, s = plain(*ins)
    torch.autograd.backward((y, s), (gy, gs))
    assert got[2] is None
    for g, t, n in zip(got, ins, needs):
        if n:
            torch.testing.assert_close(g, t.grad, rtol=0, atol=0)


# -- the launcher: frames and patches ------------------------------------------

FRONTEND = ["seamless-m4t-medium", "llava-next-mistral-7b"]
LAUNCH = ["--smoke", "--steps", "2", "--batch", "2", "--seq", "16"]


class _Stop(Exception):
    pass


def _reference_batches(arch, monkeypatch, tmp_path):
    """The batches the reference's ``launch/train.py`` hands its
    supervisor, recorded by a stand-in ``Supervisor`` (its trainer is not
    built: only ``batch_at`` runs)."""
    from repro.launch import train as jtrain

    got = []

    class Recorder:
        def __init__(self, **_):
            pass

        def run(self, state, batch_at, start_step, num_steps, on_step):
            got.extend(batch_at(i) for i in range(start_step, num_steps))
            raise _Stop

    monkeypatch.setattr(jtrain, "build_trainer", lambda *a, **k: (None, None))
    monkeypatch.setattr(jtrain, "Supervisor", Recorder)
    with pytest.raises(_Stop):
        jtrain.main(["--arch", arch, *LAUNCH, "--ckpt-dir",
                     str(tmp_path / "ref")])
    return got


@pytest.mark.parametrize("arch", FRONTEND)
def test_launcher_batches_equal_the_references(arch, monkeypatch, tmp_path):
    """Tokens, labels and the frames (encoder-decoder) or patches (VLM) of
    each step bit for bit the reference launcher's."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import make_batch_at

    want = _reference_batches(arch, monkeypatch, tmp_path)
    cfg = tconfigs.get_smoke(arch)
    batch_at = make_batch_at(cfg, SyntheticLM(vocab_size=cfg.vocab_size,
                                              seq_len=16, global_batch=2),
                             batch=2, seq=16, device="cpu")
    extra = "frames" if cfg.is_encdec else "patches"
    for i, w in enumerate(want):
        b = batch_at(i)
        assert set(b) == set(w) == {"tokens", "labels", extra}
        for k, v in b.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(w[k]),
                                          err_msg=f"step {i} {k}")


@pytest.mark.parametrize("arch", FRONTEND)
def test_launcher_trains_encoder_decoder_and_vlm(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch ... --smoke --device
    cpu`` takes its steps: finite losses over frames or patches."""
    from repro_torch.launch import train as ttrain

    log = ttrain.main(["--arch", arch, *LAUNCH, "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "port")])
    assert len(log) == 2
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in log)
    assert "[train] done: 2 steps" in capsys.readouterr().out
