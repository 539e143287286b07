"""The port's runtime and I/O against the JAX package on the CPU: the
data pipeline (batches bit for bit, the prefetcher's order, errors and
close), the checkpoint store (bfloat16 bit for bit, the async snapshot,
atomic writes, retention, in-place restore, the fault site), the
``Supervisor`` (the reference's cases in ``tests/test_data_ckpt_runtime.py``
with a torch state, and a smoke model's training resumed from a
checkpoint after an injected step fault, bit for bit the uninterrupted
run), the training launcher, and the serving CLI's ``--legacy`` and
``--chaos`` modes.

Tolerances: none — batches, checkpoints, replays and token streams are
compared exactly."""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import MemmapCorpus as JMemmap
from repro.data import SyntheticLM as JSynthetic
from repro.launch import serve as jserve
from repro.models import lm as jlm
import repro_torch.configs as tconfigs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, named_leaves,
                                    save_checkpoint)
from repro_torch.data import MemmapCorpus, Prefetcher, SyntheticLM
from repro_torch.interop import params_from_reference
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.runtime import (Fault, FaultPlan, InjectedFault, Supervisor,
                                 TransientError, fault_scope)


# -- data ----------------------------------------------------------------

@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2), (3, 4)])
def test_synthetic_batches_equal_reference(shard, num_shards):
    kw = dict(vocab_size=1000, seq_len=12, global_batch=8, seed=5,
              shard=shard, num_shards=num_shards)
    src, ref = SyntheticLM(**kw), JSynthetic(**kw)
    for step in (0, 1, 7, 123456):
        got, want = src.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_memmap_batches_equal_reference(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    for shard in (0, 1):
        kw = dict(seq_len=10, global_batch=4, shard=shard, num_shards=2)
        src, ref = MemmapCorpus(str(path), **kw), JMemmap(str(path), **kw)
        for step in (0, 3, 200):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(src.batch_at(step)[k],
                                              ref.batch_at(step)[k])


def test_uneven_shards_raise():
    with pytest.raises(ValueError, match="split"):
        SyntheticLM(vocab_size=10, seq_len=4, global_batch=3, num_shards=2)


def test_prefetcher_order_and_close():
    src = SyntheticLM(vocab_size=100, seq_len=8, global_batch=2)
    pf = Prefetcher(src, start_step=3, depth=2, device="cpu")
    try:
        for want in (3, 4, 5, 6):
            step, batch = pf.next()
            assert step == want
            assert batch["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          src.batch_at(want)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_reraises_the_producers_error():
    class Broken:
        def batch_at(self, step):
            if step == 2:
                raise KeyError("no such window")
            return {"tokens": np.zeros((1, 2), np.int32)}

    pf = Prefetcher(Broken(), depth=1, device="cpu")
    try:
        assert pf.next()[0] == 0 and pf.next()[0] == 1
        with pytest.raises(RuntimeError, match="step 2"):
            pf.next()
    finally:
        pf.close()


def test_prefetcher_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prefetcher(SyntheticLM(vocab_size=10, seq_len=4, global_batch=1))


# -- checkpoint --------------------------------------------------------------

def _state(x=1.0):
    m = torch.nn.Module()
    m.register_parameter("w", torch.nn.Parameter(
        torch.full((4, 4), x, dtype=torch.bfloat16), requires_grad=False))
    m.register_parameter("b", torch.nn.Parameter(torch.zeros(3),
                                                 requires_grad=False))
    return {"params": m, "opt": {"m": {"w": torch.full((4, 4), x)}},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_bfloat16_bits(tmp_path):
    d = str(tmp_path / "ck")
    st = _state(2.5)
    st["params"].w.copy_(torch.randn(4, 4).bfloat16())
    save_checkpoint(d, 7, st, extra={"step": 7})
    like = _state(0.0)
    w = like["params"].w
    step, restored, extra = load_checkpoint(d, like)
    assert step == 7 and extra == {"step": 7}
    assert restored is like and restored["params"].w is w   # in place
    assert torch.equal(w.view(torch.int16),
                       st["params"].w.view(torch.int16))
    assert torch.equal(restored["opt"]["m"]["w"], torch.full((4, 4), 2.5))
    with open(os.path.join(d, "step_00000007", "index.json")) as f:
        index = json.load(f)
    assert index["step"] == 7 and index["extra"] == {"step": 7}
    by_name = {e["name"]: e for e in index["leaves"]}
    assert set(by_name) == {"params.w", "params.b", "opt.m.w", "step"}
    assert by_name["params.w"]["dtype"] == "bfloat16"
    assert by_name["params.w"]["shape"] == [4, 4]
    assert np.load(os.path.join(d, "step_00000007", by_name["params.w"][
        "file"])).dtype == np.uint16


def test_checkpoint_restore_onto_a_device_replaces_the_leaves(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, _state(3.0))
    like = _state(0.0)
    w, m = like["params"].w, like["opt"]["m"]["w"]
    load_checkpoint(d, like, devices="cpu")
    assert like["params"].w is w                 # the parameter object
    assert like["opt"]["m"]["w"] is not m        # a new tensor in its place
    assert float(like["opt"]["m"]["w"][0, 0]) == 3.0


def test_checkpoint_manager_async_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, _state(float(s)))
    mgr.wait()
    assert sorted(int(x.split("_")[1]) for x in os.listdir(d)) == [30, 40]
    step, restored, _ = mgr.restore_latest(_state(0.0))
    assert step == 40
    assert float(restored["params"].w[0, 0]) == 40.0


def test_checkpoint_snapshot_is_taken_before_save_returns(tmp_path):
    """The train step writes the parameters in place right after a save:
    the checkpoint holds the values at the save, not later ones."""
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d)
    st = _state(1.0)
    mgr.save(5, st)
    st["params"].w.fill_(9.0)
    st["opt"]["m"]["w"].fill_(9.0)
    mgr.wait()
    _, restored, _ = mgr.restore_latest(_state(0.0))
    assert float(restored["params"].w[0, 0]) == 1.0
    assert float(restored["opt"]["m"]["w"][0, 0]) == 1.0


def test_checkpoint_atomic_tmp_ignored(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 5, _state(5.0))
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # a crash mid-write
    assert CheckpointManager(d).latest_step() == 5 == latest_step(d)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, _state())
    bad = _state()
    bad["opt"]["m"]["w"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="opt.m.w"):
        load_checkpoint(d, bad)


def test_checkpoint_save_trips_its_fault_site(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    with fault_scope(FaultPlan([Fault("checkpoint.save", step=3)])):
        mgr.save(3, _state())
        with pytest.raises(InjectedFault):
            mgr.wait()
    assert mgr.latest_step() is None


def test_named_leaves_refuses_what_it_cannot_save():
    with pytest.raises(TypeError, match="x"):
        list(named_leaves({"x": "text"}))


# -- supervisor ----------------------------------------------------------------

def _scalar(x):
    return torch.tensor(float(x))


def test_supervisor_runs_and_checkpoints(tmp_path):
    def step_fn(state, batch):
        return {"x": state["x"] + batch}

    sup = Supervisor(step_fn=step_fn,
                     ckpt=CheckpointManager(str(tmp_path / "ck")),
                     ckpt_every=5, log=lambda *_: None)
    state = sup.run({"x": _scalar(0)}, lambda i: _scalar(1), start_step=0,
                    num_steps=12)
    assert float(state["x"]) == 12.0
    assert sup.ckpt.latest_step() == 10
    assert sup.stats.count == 12


def test_supervisor_recovers_from_transient_failure(tmp_path):
    """Fail at step 7 twice: restore the step-5 checkpoint and replay; the
    final state equals the failure-free run's."""
    fail_at = {"n": 2}

    def step_fn(state, batch):
        if int(state["step"]) == 7 and fail_at["n"] > 0:
            fail_at["n"] -= 1
            raise TransientError("simulated preemption")
        return {"x": state["x"] + batch, "step": state["step"] + 1}

    sup = Supervisor(step_fn=step_fn,
                     ckpt=CheckpointManager(str(tmp_path / "ck")),
                     ckpt_every=5, log=lambda *_: None)
    state = sup.run({"x": _scalar(0), "step": torch.tensor(0)},
                    lambda i: _scalar(1), start_step=0, num_steps=12)
    assert float(state["x"]) == 12.0
    assert sup.failures == 2
    # each failure is recovered when step 7 next completes
    assert [(f, r) for f, r, _ in sup.recoveries] == [(7, 7), (7, 7)]


def test_supervisor_gives_up_on_persistent_failure(tmp_path):
    def step_fn(state, batch):
        raise TransientError("hard down")

    sup = Supervisor(step_fn=step_fn,
                     ckpt=CheckpointManager(str(tmp_path / "ck")),
                     max_retries_per_step=2, log=lambda *_: None)
    with pytest.raises(RuntimeError, match="failed 3 times"):
        sup.run({"x": _scalar(0)}, lambda i: 1.0, 0, 5)


def test_supervisor_reraises_a_deterministic_error(tmp_path):
    def step_fn(state, batch):
        raise KeyError("bug")

    sup = Supervisor(step_fn=step_fn,
                     ckpt=CheckpointManager(str(tmp_path / "ck")),
                     log=lambda *_: None)
    with pytest.raises(KeyError):
        sup.run({"x": _scalar(0)}, lambda i: 1.0, 0, 5)
    assert sup.failures == 0


def test_straggler_detection(tmp_path):
    def step_fn(state, batch):
        time.sleep(0.05 if batch else 0.001)
        return state

    sup = Supervisor(step_fn=step_fn,
                     ckpt=CheckpointManager(str(tmp_path / "ck")),
                     ckpt_every=10**9, straggler_zscore=2.0,
                     log=lambda *_: None)
    sup.run({}, lambda i: i == 18, start_step=0, num_steps=20)
    assert any(s == 18 for s, _ in sup.stats.stragglers), \
        sup.stats.stragglers


def test_supervisor_resize_moves_every_leaf(tmp_path):
    sup = Supervisor(step_fn=lambda s, b: s,
                     ckpt=CheckpointManager(str(tmp_path / "ck")))
    st = _state(2.0)
    w = st["params"].w
    sup.resize(st, "cpu")
    assert st["params"].w is w and sup.state_devices == "cpu"
    assert all(t.device.type == "cpu" for _, t, _ in named_leaves(st))


@pytest.fixture(scope="module")
def smoke_trainer():
    """A 3-step qwen3 smoke trainer, batch 2 x 16, on the CPU."""
    cfg = tconfigs.get_smoke("qwen3-8b")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16,
                       global_batch=2)
    return cfg, lambda i: data.batch_at(i)


def _train(cfg, batch_at, ckpt_dir, steps, plan=None):
    step_fn, state = ttrain.build_trainer(cfg, total_steps=steps,
                                          device="cpu")
    losses = {}

    def step_and_log(state, batch):
        state, m = step_fn(state, batch)
        losses[int(state["step"])] = float(m["loss"])
        return state

    sup = Supervisor(step_fn=step_and_log,
                     ckpt=CheckpointManager(ckpt_dir), ckpt_every=2,
                     log=lambda *_: None)
    with fault_scope(plan or FaultPlan([])):
        state = sup.run(state, batch_at, 0, steps)
    return state, losses, sup


def test_training_resumes_bit_for_bit_after_a_step_fault(tmp_path,
                                                        smoke_trainer):
    """A fault before step 3 restores the step-2 checkpoint and replays:
    every step's loss, the parameters and the moments equal the
    uninterrupted run's bit for bit."""
    cfg, batch_at = smoke_trainer
    want, want_losses, _ = _train(cfg, batch_at, str(tmp_path / "a"), 4)
    plan = FaultPlan([Fault("supervisor.step", step=3)])
    got, got_losses, sup = _train(cfg, batch_at, str(tmp_path / "b"), 4,
                                  plan)
    assert plan.exhausted() and sup.failures == 1
    assert [(f, r) for f, r, _ in sup.recoveries] == [(3, 3)]
    assert got_losses == want_losses
    a = {n: t for n, t, _ in named_leaves(got)}
    b = {n: t for n, t, _ in named_leaves(want)}
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    log = ttrain.main(["--arch", "mamba2-130m", "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--log-every", "1",
                       "--ckpt-every", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert len(log) == 3 and all(np.isfinite(m["loss"]) for m in log)
    assert "[train] step 3: loss=" in out and "[train] done: 3 steps" in out
    assert latest_step(str(tmp_path / "ck")) == 2


# -- serving CLI ---------------------------------------------------------------

class _Args:
    batch, prompt_len, gen, smoke, chaos = 2, 8, 6, True, False


def test_serve_legacy_matches_the_reference_legacy_loop(capsys):
    jc, tc = (jconfigs.get_smoke("qwen3-8b"),
              tconfigs.get_smoke("qwen3-8b"))
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    got = tserve.serve_legacy(tc, tp, _Args())
    want = jserve.serve_legacy(jc, jp, _Args())
    np.testing.assert_array_equal(got, want)
    assert "path=legacy" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-130m", "gemma3-12b",
                                  "recurrentgemma-9b"])
def test_serve_smoke_chaos_and_legacy_on_the_cpu(arch, capsys):
    flags = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
             "--gen", "6", "--device", "cpu"]
    gen = tserve.main(flags + ["--chaos"])
    out = capsys.readouterr().out
    assert "injected failures recovered; token streams identical  OK" in out
    assert "fresh worker after chaos: 0 new decode captures  OK" in out
    np.testing.assert_array_equal(tserve.main(flags + ["--legacy"]), gen)
