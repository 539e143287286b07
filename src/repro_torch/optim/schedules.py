"""Learning-rate schedules: pure functions of the step counter, as
``repro.optim.schedules``.  The step is a Python int or an integer tensor;
the rate is a float32 tensor on the step's device, so a step counter kept
on the GPU gives the rate there with no host sync."""

from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(peak: float, warmup_steps: int):
    """``peak * min(1, (step + 1) / warmup_steps)``."""
    def fn(step):
        s = _step(step)
        return peak * torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak``."""
    def fn(step):
        s = _step(step)
        warm = torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return peak * warm * cos
    return fn
