"""End-to-end LM training on PyTorch, ``examples/train_lm.py`` on the
port: data pipeline -> train step -> fault-tolerant supervisor with async
checkpointing.

Default: a ~12M-parameter qwen3-family model for 200 steps; ``--big``
trains a ~100M-parameter one (the same code path).  It runs on the GPU,
where attention is the K6 kernel, unless ``--device cpu`` asks for the
plain versions.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200
  PYTHONPATH=src python examples/train_lm_torch.py --big --steps 300
  PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu
"""

import argparse
import os
import tempfile

import torch

import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.device import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import init_lm, param_count
from repro_torch.optim import cosine_schedule
from repro_torch.runtime import Supervisor


def model_config(big: bool):
    """The reference example's two configs: qwen3's family (GQA, qk-norm,
    SwiGLU) at ~100M or ~12M parameters, float32."""
    base = configs.get("qwen3-8b")
    if big:
        return base.with_(n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
                          head_dim=64, d_ff=2048, vocab_size=32000,
                          param_dtype="float32", compute_dtype="float32",
                          attn_impl="tri", q_chunk=128, k_chunk=128,
                          remat="none")
    return base.with_(n_layers=8, d_model=256, n_heads=8, n_kv_heads=4,
                      head_dim=32, d_ff=1024, vocab_size=8192,
                      param_dtype="float32", compute_dtype="float32",
                      attn_impl="tri", q_chunk=128, k_chunk=128,
                      remat="none")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_config(args.big)
    print(f"[train_lm] params: {param_count(cfg):,} "
          f"({'~100M' if args.big else '~12M'} config)")

    step_fn, opt = make_train_step(
        cfg, lr=cosine_schedule(3e-4, 20, args.steps), device=dev)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch)
    losses = []

    def wrapped(state, batch):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        return state

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_at(i).items()}

    sup = Supervisor(step_fn=wrapped, ckpt=CheckpointManager(args.ckpt_dir),
                     ckpt_every=100)
    sup.run(state, batch_at, start_step=0, num_steps=args.steps,
            on_step=lambda s, _: print(
                f"step {s:4d}  loss {losses[-1]:.4f}  "
                f"({sup.stats.last*1e3:.0f} ms)")
            if s % 20 == 0 else None)
    print(f"[train_lm] loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{args.steps} steps; final ppl ~ {2.718 ** losses[-1]:.1f}")
    if not losses[-1] < losses[0]:
        raise AssertionError("training must reduce the loss")
    return losses


if __name__ == "__main__":
    main()
