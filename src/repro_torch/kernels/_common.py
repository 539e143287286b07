"""Checks and conversions shared by the CUDA kernel wrappers."""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.layout import Layout

__all__ = ["DTYPE_SUFFIX", "LAYOUT_CODE", "on_cuda", "check_cuda_tensor",
           "round_to", "stream_of"]

#: storage dtypes the kernels take -> suffix of their C entry points
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: layout codes of record_index.cuh
LAYOUT_CODE = {Layout.AOS: 0, Layout.SOA: 1, Layout.AOSOA: 2}


def on_cuda(t: torch.Tensor) -> bool:
    """Which version an ops function runs: True (the kernel) for a CUDA
    tensor, False (the plain version) for a CPU tensor; any other device
    raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def check_cuda_tensor(t: torch.Tensor, what: str) -> str:
    """Raise unless ``t`` is a contiguous float32/bfloat16 CUDA tensor;
    returns the C entry-point suffix of its dtype."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in DTYPE_SUFFIX:
        raise TypeError(f"{what}: dtype {t.dtype} is not float32 or bfloat16")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor is not contiguous")
    return DTYPE_SUFFIX[t.dtype]


def round_to(value, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (as the reference casts its scalars to
    the working dtype before the kernel), returned as a float for the C
    call."""
    return _round_float(float(value), dtype)


@functools.lru_cache(maxsize=256)
def _round_float(value: float, dtype: torch.dtype) -> float:
    # cached: a wrapper rounds the same few scalars on every launch, and
    # making the tensor costs microseconds of host time
    return float(torch.tensor(value, dtype=dtype))


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for the C launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
