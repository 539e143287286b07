"""Serving launcher: continuous batching over the graph-native executors.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --smoke [--device cpu]

``--arch`` takes qwen3-8b, qwen1.5-4b, chatglm3-6b, mamba2-130m,
gemma3-12b, recurrentgemma-9b, llava-next-mistral-7b and
seamless-m4t-medium.  The last two, a VLM and an encoder-decoder, serve
through the uniform loop alone (:func:`serve_legacy`), as in the JAX
package: their requests carry seeded patch embeddings or frames.

Prefill and batched greedy decode are Ripple graphs (``launch/steps.py``)
run by the port's ``Executor``; the KV cache is a layout-polymorphic
record state tensor; :class:`~repro_torch.runtime.batcher.Batcher` admits
requests into the decode executor's batch slots.  On the GPU (the default)
prefill attention, local or global, runs on the K6 kernel and the
Mamba-2 SSD on K7.

The batcher's decode executor takes the executor's defaults
(``regions=True, donate=True``): the decode step is captured once and
replayed; its prefills run eagerly.
``--smoke`` takes the arch's reduced config and asserts the JAX
package's three smoke checks: the batcher's token streams equal
:func:`legacy_generate`'s, the uniform prefill + decode loop; the steady
decode loop is captured exactly once; and a freshly built worker
``Batcher`` with the same decode plan signature serves the same prompts
with zero new decode captures and equal streams.

``--legacy`` serves through the uniform loop alone (:func:`serve_legacy`:
prefill, then the whole batch decoded at one position).  ``--chaos``
(with ``--smoke``) re-serves the same prompts under the reference's
deterministic fault plan (two mid-decode step failures, an admission
failure and a device-region failure inside the decode executor) and
asserts that the ``Batcher``'s request-log replay gives the same token
streams, that every fault fired, and that a fresh worker afterwards
serves with zero new decode captures.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..core.device import resolve_device
from ..core.layout import Layout
from ..models.lm import init_lm, prefill
from . import steps as S

__all__ = ["legacy_generate", "serve_legacy", "serve_ripple", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def legacy_generate(cfg, params, tokens, gen: int, max_seq: int,
                    use_kernel: bool = True, *, frames=None, patches=None):
    """The uniform loop: prefill, then greedy decode of the whole batch at
    one position.  ``tokens`` (B, S) int, with ``frames`` (B, S_enc,
    frontend_dim) for an encoder-decoder or ``patches`` (B,
    frontend_tokens, frontend_dim) for a VLM (``max_seq`` then counts the
    patch positions); returns ``((B, gen) token array, prefill seconds,
    decode seconds)``.

    Each row is prefilled on its own and the caches are stacked: the
    batcher prefills one request at a time, and a batched prefill runs
    its matrix products at another shape, which the GPU's libraries may
    sum in another order, and greedy decoding would follow any rounding
    difference.  The decode steps run the whole batch at once."""
    dev = next(params.parameters()).device
    batch = {"tokens": tokens, "frames": frames, "patches": patches}
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
             if v is not None}
    _sync(dev)
    t0 = time.perf_counter()
    rows = [prefill(params, {k: v[b:b + 1] for k, v in batch.items()}, cfg,
                    max_seq=max_seq, use_kernel=use_kernel)
            for b in range(batch["tokens"].shape[0])]
    logits = torch.cat([r[0] for r in rows])
    caches = _stack_caches([r[1] for r in rows], cfg)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    step = S.make_decode_step(cfg)
    toks = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [toks]
    t1 = time.perf_counter()
    for _ in range(gen - 1):
        logits, caches = step(params, caches, toks)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(toks)
    out = torch.stack(out, dim=1).cpu().numpy()
    t_decode = time.perf_counter() - t1
    return out, t_prefill, t_decode


def _stack_caches(parts: list, cfg) -> dict:
    """Per-row caches (batch 1 each, at one position) stacked along the
    batch axis: axis 1 of SoA KV storage (its component axis leads), axis
    0 of everything else; an encoder-decoder's ``{"self", "cross"}``
    entry on both keys."""
    kv_axis = 1 if cfg.kv_layout is Layout.SOA else 0

    def cat(xs):
        if isinstance(xs[0], tuple):    # a Mamba or RG-LRU layer's pair
            return tuple(torch.cat(list(z)) for z in zip(*xs))
        if isinstance(xs[0], dict):     # self and cross KV storage
            return {k: cat([x[k] for x in xs]) for k in xs[0]}
        return torch.cat(xs, dim=kv_axis)

    first = parts[0]
    return {"groups": [{k: cat([p["groups"][g][k] for p in parts])
                        for k in grp}
                       for g, grp in enumerate(first["groups"])],
            "tail": [cat([p["tail"][i] for p in parts])
                     for i in range(len(first["tail"]))],
            "pos": first["pos"]}


def _prompts(cfg, batch: int, prompt_len: int, rng=None) -> np.ndarray:
    rng = np.random.default_rng(0) if rng is None else rng
    return rng.integers(0, cfg.vocab_size,
                        (batch, prompt_len)).astype(np.int32)


def serve_legacy(cfg, params, args):
    """Serve ``args.batch`` prompts through the uniform loop alone; an
    encoder-decoder's requests carry ``ENC_LEN_SERVE`` frames each, a
    VLM's ``frontend_tokens`` patch embeddings, from the prompts' seeded
    generator."""
    B = args.batch
    rng = np.random.default_rng(0)
    prompts = _prompts(cfg, B, args.prompt_len, rng)
    extra = {}
    if cfg.is_encdec:
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S.ENC_LEN_SERVE, cfg.frontend_dim)).astype(np.float32))
    elif cfg.frontend_dim:
        extra["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32))
    max_seq = args.prompt_len + args.gen + (
        cfg.frontend_tokens if "patches" in extra else 0)
    gen, t_prefill, t_decode = legacy_generate(
        cfg, params, torch.from_numpy(prompts), args.gen, max_seq, **extra)
    print(f"[serve] arch={cfg.name} batch={B} prompt={args.prompt_len} "
          f"gen={args.gen} path=legacy")
    print(f"[serve] prefill {t_prefill*1e3:.0f}ms; decode "
          f"{t_decode/max(args.gen-1,1)*1e3:.1f}ms/tok "
          f"({B*(args.gen-1)/max(t_decode,1e-9):.1f} tok/s)")
    print(f"[serve] sample generations (first 3 rows):\n{gen[:3]}")
    return gen


def serve_ripple(cfg, params, args):
    """Serve through the Batcher; with ``--smoke`` check it against the
    uniform loop token for token, its decode captured once, and a fresh
    worker serving with zero new decode captures."""
    from ..runtime.batcher import Batcher

    B = args.batch
    max_seq = args.prompt_len + args.gen
    prompts = _prompts(cfg, B, args.prompt_len)
    t0 = time.perf_counter()
    batcher = Batcher(cfg, params, batch=B, max_seq=max_seq)
    reqs = [batcher.submit(p, max_new_tokens=args.gen) for p in prompts]
    batcher.run()
    t_total = time.perf_counter() - t0
    gen = np.stack([r.generated for r in reqs])
    n_tok = int(sum(len(r.generated) for r in reqs))
    print(f"[serve] arch={cfg.name} batch={B} prompt={args.prompt_len} "
          f"gen={args.gen} path=ripple device={batcher.device}")
    print(f"[serve] {batcher.steps} decode steps, {n_tok} tokens in "
          f"{t_total * 1e3:.0f}ms ({n_tok / max(t_total, 1e-9):.1f} tok/s)")
    print(f"[serve] sample generations (first 3 rows):\n{gen[:3]}")
    if args.smoke:
        legacy, _, _ = legacy_generate(cfg, params,
                                       torch.from_numpy(prompts), args.gen,
                                       max_seq)
        if not (gen == legacy).all():
            raise AssertionError(
                f"ripple/legacy argmax mismatch:\n{gen}\nvs\n{legacy}")
        print("[smoke] ripple == legacy argmax sequences  OK")

        # the steady decode loop captured exactly once
        captures = batcher.cache_stats()["decode"]["trace_events"]
        if captures != 1:
            raise AssertionError(f"decode captured {captures} times over "
                                 f"{batcher.steps} steps")
        print(f"[smoke] decode captured once across {batcher.steps} "
              f"steps  OK")

        # a freshly built worker serves with zero new decode captures
        before = batcher.executor.cache_stats()["trace_events"]
        worker = Batcher(cfg, params, batch=B, max_seq=max_seq)
        wreqs = [worker.submit(p, max_new_tokens=args.gen) for p in prompts]
        worker.run()
        wgen = np.stack([r.generated for r in wreqs])
        after = worker.executor.cache_stats()["trace_events"]
        if worker.executor.plan.signature != batcher.executor.plan.signature:
            raise AssertionError("fresh worker: another plan signature")
        if after != before:
            raise AssertionError(f"fresh worker captured anew: {before} -> "
                                 f"{after} captures")
        if not (wgen == gen).all():
            raise AssertionError(f"fresh worker's streams differ:\n{wgen}"
                                 f"\nvs\n{gen}")
        print("[smoke] fresh worker served with 0 new decode captures  OK")
    if getattr(args, "chaos", False):
        gen = _chaos_smoke(cfg, params, args, prompts, gen, max_seq)
    return gen


def _chaos_smoke(cfg, params, args, prompts, want, max_seq):
    """Re-serve ``prompts`` under the reference's fault plan and check that
    the request-log replay gives the streams ``want``, that every fault
    fired, and that a fresh worker afterwards makes no new decode
    capture."""
    from ..runtime.batcher import Batcher
    from ..runtime.faults import Fault, FaultPlan, fault_scope

    plan = FaultPlan([
        Fault("batcher.step", step=2, times=2),     # two mid-decode faults
        Fault("batcher.admit", step=0),             # an admission fault
        Fault("executor.region", nth=8),            # inside the decode
    ])
    batcher = Batcher(cfg, params, batch=args.batch, max_seq=max_seq,
                      log=lambda *_: None)
    reqs = [batcher.submit(p, max_new_tokens=args.gen) for p in prompts]
    with fault_scope(plan):
        batcher.run()
    gen = np.stack([r.generated for r in reqs])
    if not plan.exhausted():
        raise AssertionError(f"not every fault fired:\n{plan.report()}")
    if batcher.failures < 3:
        raise AssertionError(f"{batcher.failures} failures, expected >= 3")
    if not (gen == want).all():
        raise AssertionError(
            f"faulted ripple argmax mismatch:\n{gen}\nvs\n{want}")
    print(f"[chaos] {batcher.failures} injected failures recovered; "
          f"token streams identical  OK")

    # after the chaos run a fresh worker still serves from the
    # process-wide executable cache with no new decode capture
    before = batcher.executor.cache_stats()["trace_events"]
    worker = Batcher(cfg, params, batch=args.batch, max_seq=max_seq)
    wreqs = [worker.submit(p, max_new_tokens=args.gen) for p in prompts]
    worker.run()
    wgen = np.stack([r.generated for r in wreqs])
    after = worker.executor.cache_stats()["trace_events"]
    if after != before:
        raise AssertionError(f"post-chaos worker captured anew: {before} "
                             f"-> {after}")
    if not (wgen == want).all():
        raise AssertionError(f"post-chaos worker's streams differ:\n{wgen}"
                             f"\nvs\n{want}")
    print("[chaos] fresh worker after chaos: 0 new decode captures  OK")
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--legacy", action="store_true",
                    help="serve through the uniform loop alone")
    ap.add_argument("--chaos", action="store_true",
                    help="re-serve under a deterministic fault plan and "
                         "assert request-log recovery (ripple path)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else \
        configs.get(args.arch)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if args.legacy or cfg.is_encdec or cfg.frontend_dim:
        return serve_legacy(cfg, params, args)
    return serve_ripple(cfg, params, args)


if __name__ == "__main__":
    main()
