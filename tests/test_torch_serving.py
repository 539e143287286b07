"""The port's graph-native serving against the JAX package's on the CPU,
at the smoke configs: the port's ``Batcher`` (prefill and decode graphs
on the port's ``Executor``) gives the same greedy token streams as the
JAX ``Batcher`` on ragged prompts, with more requests than slots, EOS,
eviction, prefill-ahead on and off, another KV layout, an injected
transient fault, and as the port's own uniform loop.  Streams are compared
token for token: the same weights in float32 agree to ~1e-6 in the
logits, far below the gaps between these argmaxes."""

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.runtime.batcher import Batcher as JBatcher
import repro_torch.configs as tconfigs
from repro_torch.core.layout import Layout
from repro_torch.interop import params_from_reference
from repro_torch.launch.serve import legacy_generate
from repro_torch.launch.steps import make_decode_graph
from repro_torch.runtime.batcher import Batcher
from repro_torch.runtime.faults import (Fault, FaultPlan, RetryPolicy,
                                        fault_scope)

MAX_SEQ = 20
LENGTHS, WANT = (3, 5, 3, 5, 4), (4, 3, 4, 2, 5)


def _serve(batcher, prompts, want_n):
    reqs = [batcher.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, want_n)]
    batcher.run()
    return reqs


@pytest.fixture(scope="module", params=["qwen3-8b", "mamba2-130m"])
def served(request):
    """One arch in both packages with the same weights, and the JAX
    Batcher's streams for ragged prompts (2 slots, 5 requests)."""
    jc = jconfigs.get_smoke(request.param)
    tc = tconfigs.get_smoke(request.param)
    jp, _ = jlm.init_lm(jc, jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tc.vocab_size, (L,)).astype(np.int32)
               for L in LENGTHS]
    jb = JBatcher(jc, jp, batch=2, max_seq=MAX_SEQ, log=lambda *_: None)
    refs = [r.generated for r in _serve(jb, prompts, WANT)]
    return tc, tp, jc, jp, prompts, refs


def test_batcher_matches_reference_batcher(served):
    tc, tp, _, _, prompts, refs = served
    b = Batcher(tc, tp, batch=2, max_seq=MAX_SEQ)
    reqs = _serve(b, prompts, WANT)
    assert [r.generated for r in reqs] == refs
    assert all(r.status == "done" for r in reqs)
    assert b.state["tokens"].device.type == "cpu"


@pytest.mark.parametrize("prefill_ahead", [False, True])
def test_prefill_ahead_gives_the_same_streams(served, prefill_ahead):
    tc, tp, _, _, prompts, refs = served
    b = Batcher(tc, tp, batch=2, max_seq=MAX_SEQ,
                prefill_ahead=prefill_ahead)
    assert [r.generated for r in _serve(b, prompts, WANT)] == refs
    assert not b._prepared


@pytest.mark.parametrize("layout", [Layout.SOA, Layout.AOSOA])
def test_other_kv_layouts_give_the_same_streams(served, layout):
    tc, tp, _, _, prompts, refs = served
    names = [t.name for s in make_decode_graph(tc, tp, batch=2,
                                               max_seq=MAX_SEQ).slots
             for t in s.tensors if t.is_record]
    b = Batcher(tc, tp, batch=2, max_seq=MAX_SEQ, executor_opts={
        "layout_overrides": {n: layout for n in names}})
    assert [r.generated for r in _serve(b, prompts, WANT)] == refs


def test_eos_retires_like_the_reference(served):
    tc, tp, jc, jp, prompts, refs = served
    eos = refs[0][1]
    jb = JBatcher(jc, jp, batch=1, max_seq=MAX_SEQ, eos_token=eos,
                  log=lambda *_: None)
    want = [r.generated for r in _serve(jb, prompts[:2], WANT[:2])]
    b = Batcher(tc, tp, batch=1, max_seq=MAX_SEQ, eos_token=eos)
    got = _serve(b, prompts[:2], WANT[:2])
    assert [r.generated for r in got] == want
    assert got[0].generated[-1] == eos and got[0].status == "done"


def test_eviction_from_queue_and_live_slot(served):
    tc, tp, _, _, prompts, refs = served
    b = Batcher(tc, tp, batch=1, max_seq=MAX_SEQ)
    r0 = b.submit(prompts[0], max_new_tokens=10)
    r1 = b.submit(prompts[1], max_new_tokens=WANT[1])
    r2 = b.submit(prompts[2], max_new_tokens=10)
    assert b.evict(r2.rid) and r2.status == "evicted"
    b.step()
    assert b.evict(r0.rid) and r0.status == "evicted"
    assert r0.generated == refs[0][:2]
    b.run()
    assert r1.generated == refs[1] and r1.status == "done"
    assert not b.evict(12345)


def test_injected_faults_replay_the_same_streams(served):
    """An admission fault and a mid-decode fault at the batcher's fault
    sites; the request-log replay gives the fault-free streams."""
    tc, tp, _, _, prompts, refs = served
    b = Batcher(tc, tp, batch=2, max_seq=MAX_SEQ, log=lambda *_: None,
                retry=RetryPolicy(base_delay=0.0, sleep=lambda d: None))
    plan = FaultPlan([Fault("batcher.admit", step=0),
                      Fault("batcher.step", step=1)])
    with fault_scope(plan):
        reqs = _serve(b, prompts, WANT)
    assert plan.exhausted(), plan.report()
    assert b.failures == 2
    assert [r.generated for r in reqs] == refs


def test_legacy_loop_matches_the_batcher(served):
    """The port's uniform loop (one prefill over both rows, batched
    decode) on the equal-length prompts gives the Batcher's streams."""
    tc, tp, _, _, prompts, refs = served
    pair = np.stack([prompts[0], prompts[2]])
    gen, _, _ = legacy_generate(tc, tp, torch.from_numpy(pair), 4, MAX_SEQ)
    assert gen.tolist() == [refs[0][:4], refs[2][:4]]


def test_submit_validation(served):
    tc, tp, _, _, _, _ = served
    b = Batcher(tc, tp, batch=1, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="empty"):
        b.submit([])
    with pytest.raises(ValueError, match="max_seq"):
        b.submit(np.ones(MAX_SEQ, np.int32))


def test_distinct_prompt_lengths_leave_one_cache_entry(served):
    """Traffic of ever new prompt lengths at the defaults: the prefill
    executors run eagerly, so however many lengths are served the
    executable cache holds the decode step's entry alone, and the streams
    equal an all-eager batcher's."""
    import repro_torch.core as tcore

    tc, tp, _, _, _, _ = served
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tc.vocab_size, (L,)).astype(np.int32)
               for L in range(2, 14)]
    want = [r.generated for r in _serve(
        Batcher(tc, tp, batch=2, max_seq=MAX_SEQ,
                executor_opts={"regions": False}),
        prompts, [2] * len(prompts))]
    tcore.clear_executable_cache()
    try:
        b = Batcher(tc, tp, batch=2, max_seq=MAX_SEQ)
        assert [r.generated for r in _serve(b, prompts,
                                            [2] * len(prompts))] == want
        assert sorted(b._prefill) == list(range(2, 14))
        assert not any(ex.regions for _, ex in b._prefill.values())
        assert tcore.executable_cache_stats()["entries"] == 1
    finally:
        tcore.clear_executable_cache()


def test_regions_batcher_gives_the_same_streams_and_frees_its_entry(served):
    """The decode executor under ``regions=True, donate=True`` (admission
    writes into its static buffers) serves the reference's streams; a
    batcher dropped and rebuilt with new weights leaves one cache entry,
    and the old weights go with the old batcher."""
    import copy
    import gc
    import weakref

    import repro_torch.core as tcore

    tc, tp, _, _, prompts, refs = served
    tcore.clear_executable_cache()
    old = None
    try:
        for _ in range(2):
            params = copy.deepcopy(tp)
            b = Batcher(tc, params, batch=2, max_seq=MAX_SEQ,
                        executor_opts={"regions": True, "donate": True})
            assert [r.generated for r in _serve(b, prompts, WANT)] == refs
            stats = tcore.executable_cache_stats()
            assert stats["entries"] == 1
            assert b.cache_stats()["decode"]["trace_events"] >= 1
            if old is not None:
                assert old() is None
            old = weakref.ref(next(params.parameters()))
            del b, params
            gc.collect()
        assert old() is None
        assert tcore.executable_cache_stats()["entries"] == 0
    finally:
        tcore.clear_executable_cache()
