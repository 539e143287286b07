"""Where the port's entry points run: the GPU unless the caller says
otherwise, and never a silent fallback to the CPU."""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``, which
    raises when no GPU is present (nothing falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
