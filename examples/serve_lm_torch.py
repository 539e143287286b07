"""Continuous-batching LM serving on PyTorch, ``examples/serve_lm.py`` on
the port.

Requests with ragged prompt lengths and a per-request EOS stream through
``runtime.Batcher``: prefill and batched greedy decode are Ripple graphs
(one node per layer), the KV cache is a layout-polymorphic RecordArray
state tensor whose storage the layout solver picks (a ring of ``window``
slots for a local layer), and retired slots are re-filled from the queue
at once: more requests than batch slots is the normal case.  It runs the
arch's smoke config on the GPU (attention on the K6 kernel, the Mamba-2
SSD on K7) unless ``--device cpu`` asks for the plain versions.  An
encoder-decoder or VLM arch (seamless-m4t-medium, llava-next-mistral-7b)
serves through the uniform loop instead: the demo says so and points to
``python -m repro_torch.launch.serve --legacy``.

  PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma3-12b
  PYTHONPATH=src python examples/serve_lm_torch.py --arch recurrentgemma-9b --device cpu
"""

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.core.device import resolve_device
from repro_torch.models.lm import init_lm
from repro_torch.runtime import Batcher


def main(argv=None):
    """Serve 2x ``--batch`` ragged requests; returns the retired
    requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode batch slots (requests = 2x this)")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch)
    if cfg.is_encdec or cfg.frontend_dim:
        print(f"[serve_lm] {cfg.name} is encoder-decoder/VLM; use "
              f"`python -m repro_torch.launch.serve --legacy` for this arch")
        return []
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    rng = np.random.default_rng(0)
    eos = 0  # token 0 acts as EOS for the demo
    n_req = 2 * args.batch
    max_seq = args.prompt_len + args.max_gen

    batcher = Batcher(cfg, params, batch=args.batch, max_seq=max_seq,
                      eos_token=eos)
    t0 = time.perf_counter()
    reqs = []
    for _ in range(n_req):
        # ragged prompts: lengths vary per request
        L = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        prompt = rng.integers(1, cfg.vocab_size, (L,)).astype(np.int32)
        reqs.append(batcher.submit(prompt, max_new_tokens=args.max_gen))
    batcher.run()
    dt = time.perf_counter() - t0

    n_tok = sum(len(r.generated) for r in reqs)
    lens = [len(r.generated) for r in reqs]
    stats = batcher.cache_stats()["decode"]
    print(f"[serve_lm] arch={cfg.name} slots={args.batch} "
          f"requests={n_req} max_gen={args.max_gen} device={dev}")
    print(f"[serve_lm] {batcher.steps} decode steps, {n_tok} tokens in "
          f"{dt*1e3:.0f} ms ({n_tok/max(dt,1e-9):.1f} tok/s); "
          f"decode captures={stats.get('trace_events', 0)}; "
          f"request lengths {lens}")
    for r in reqs[:3]:
        print(f"  req{r.rid} (prompt {len(r.prompt)}): "
              f"{r.generated[:12]}{'...' if len(r.generated) > 12 else ''}")
    return reqs


if __name__ == "__main__":
    main()
