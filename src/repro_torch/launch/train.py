"""Training launcher: data pipeline -> train step -> supervisor
(checkpoint/restart, straggler stats) -> metrics, as
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --smoke --steps 100 --batch 8 --seq 128 [--device cpu]

It runs on the GPU unless ``--device cpu`` asks for the plain versions of
the kernels.  An encoder-decoder's batches carry ``frames`` and a VLM's
``patches``, seeded by the step as the reference's.  The reference's
``--mesh`` (GSPMD sharding over a device mesh) is not ported: the port
trains on one device.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any

import numpy as np
import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..core.device import resolve_device
from ..data import SyntheticLM
from ..models.lm import init_lm, param_count
from ..optim import cosine_schedule
from ..runtime import Supervisor
from . import steps as S

__all__ = ["build_trainer", "make_batch_at", "main"]


def build_trainer(cfg, *, total_steps: int, peak_lr: float = 3e-4,
                  device: Any = None):
    """-> ``(step_fn, state)``: the train step under a cosine schedule and
    a fresh state ``{"params", "opt", "step"}`` on ``device`` (``None``:
    the GPU), with random weights from seed 0 that require grad."""
    dev = resolve_device(device)
    step_fn, opt = S.make_train_step(
        cfg, lr=cosine_schedule(peak_lr, min(100, total_steps // 10),
                                total_steps), device=dev)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    return step_fn, state


def make_batch_at(cfg, data, *, batch: int, seq: int, device: Any = None):
    """-> ``batch_at(i)``: step ``i``'s batch of ``data`` on ``device``
    (``None``: the GPU), with ``frames`` (batch, seq, frontend_dim) for an
    encoder-decoder or ``patches`` (batch, frontend_tokens,
    frontend_dim) for a VLM drawn from ``np.random.default_rng(i)``, as
    the reference's ``batch_at``."""
    dev = resolve_device(device)

    def batch_at(i):
        out = {k: torch.from_numpy(v).to(dev)
               for k, v in data.batch_at(i).items()}
        shape = None
        if cfg.is_encdec:
            key, shape = "frames", (batch, seq, cfg.frontend_dim)
        elif cfg.frontend_dim:
            key, shape = "patches", (batch, cfg.frontend_tokens,
                                     cfg.frontend_dim)
        if shape is not None:
            out[key] = torch.from_numpy(np.random.default_rng(i)
                                        .standard_normal(shape)
                                        .astype(np.float32)).to(dev)
        return out

    return batch_at


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else \
        configs.get(args.arch)
    dev = resolve_device(args.device)
    print(f"[train] arch={cfg.name} params={param_count(cfg):,} "
          f"steps={args.steps} batch={args.batch}x{args.seq}")
    step_fn, state = build_trainer(cfg, total_steps=args.steps, device=dev)

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch)
    metrics_log = []

    def step_and_log(state, batch):
        state, m = step_fn(state, batch)
        metrics_log.append({k: float(v) for k, v in m.items()})
        return state

    batch_at = make_batch_at(cfg, data, batch=args.batch, seq=args.seq,
                             device=dev)

    sup = Supervisor(step_fn=step_and_log,
                     ckpt=CheckpointManager(args.ckpt_dir),
                     ckpt_every=args.ckpt_every)
    t0 = time.time()
    state = sup.run(state, batch_at, start_step=0, num_steps=args.steps,
                    on_step=lambda s, _: (
                        print(f"[train] step {s}: "
                              f"loss={metrics_log[-1]['loss']:.4f} "
                              f"gnorm={metrics_log[-1]['grad_norm']:.3f} "
                              f"{sup.stats.last*1e3:.0f}ms")
                        if s % args.log_every == 0 else None))
    dt = time.time() - t0
    print(f"[train] done: {args.steps} steps in {dt:.1f}s; "
          f"loss {metrics_log[0]['loss']:.4f} -> "
          f"{metrics_log[-1]['loss']:.4f}; "
          f"stragglers={len(sup.stats.stragglers)}")
    return metrics_log


if __name__ == "__main__":
    main()
