"""Checks and conversions shared by the CUDA kernel wrappers."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..core.layout import Layout, RecordArray

__all__ = ["DTYPE_SUFFIX", "LAYOUT_CODE", "on_cuda", "check_cuda_tensor",
           "check_out", "overlaps", "record_into", "record_out", "round_to",
           "stream_of", "refuse_grad", "plain_vjp"]

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


def refuse_grad(what: str, function: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an input requires grad: a kernel's
    output carries no gradient, so such a call would drop it silently.
    ``function`` names the ``torch.autograd.Function`` to call instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad and the kernel's output "
            f"carries none; call it through {function}")


def plain_vjp(plain, inputs: tuple, needs: tuple, grads: tuple) -> tuple:
    """The backward of a kernel whose gradient is its plain version's:
    recompute ``plain(*inputs)`` under grad mode and return the gradient
    of its outputs against ``grads`` for each input whose ``needs`` entry
    is true (None for the others)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = plain(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [t for t, n in zip(ins, needs) if n]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
    return tuple(next(got) if n else None for n in needs)


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


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when the memory of ``a`` and ``b`` overlaps (their spans from
    the first to one past the last element, within one allocation)."""
    if a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr():
        return False
    if a.numel() == 0 or b.numel() == 0:
        return False

    def span(t):
        lo = t.data_ptr()
        hi = lo + t.element_size() * (1 + sum((n - 1) * abs(s) for n, s in
                                              zip(t.shape, t.stride())))
        return lo, hi

    (a0, a1), (b0, b1) = span(a), span(b)
    return a0 < b1 and b0 < a1


def check_out(out: torch.Tensor, shape, dtype: torch.dtype,
              device: torch.device, what: str, *, apart=(),
              in_place=()) -> None:
    """Raise unless ``out`` is a contiguous tensor of ``shape``, ``dtype``
    and ``device`` that a kernel may write: it may be the very tensor of
    one of ``in_place`` (same address, shape and strides; the kernel reads
    and writes each element in one thread), and it overlaps none of
    ``apart`` and nothing of ``in_place`` otherwise."""
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"{what}: out= takes a tensor, got "
                        f"{type(out).__name__}")
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype \
            or out.device != device:
        raise ValueError(f"{what}: out is {tuple(out.shape)} {out.dtype} "
                         f"on {out.device}, the result is {tuple(shape)} "
                         f"{dtype} on {device}")
    if not out.is_contiguous():
        raise ValueError(f"{what}: out is not contiguous")
    for t in in_place:
        if overlaps(out, t) and not (out.data_ptr() == t.data_ptr()
                                     and out.stride() == t.stride()):
            raise ValueError(f"{what}: out overlaps an input without being "
                             f"it")
    for t in apart:
        if overlaps(out, t):
            raise ValueError(f"{what}: out overlaps an input the kernel "
                             f"reads while it writes")


def record_out(out: Optional[RecordArray], rec: RecordArray,
               what: str) -> torch.Tensor:
    """The storage a record kernel writes: ``out``'s, checked to be a
    record like ``rec`` that is ``rec`` itself or lies apart from it, or
    else a new tensor."""
    if out is None:
        return torch.empty_like(rec.data)
    if not isinstance(out, RecordArray) or out.spec != rec.spec \
            or out.layout is not rec.layout or out.space != rec.space:
        raise ValueError(f"{what}: out must be a record like {rec!r}, got "
                         f"{out!r}")
    check_out(out.data, rec.data.shape, rec.dtype, rec.data.device, what,
              in_place=(rec.data,))
    return out.data


def record_into(out: RecordArray, rec: RecordArray, name: str, value,
                what: str) -> RecordArray:
    """``rec`` with field ``name`` replaced by ``value``, written into
    ``out`` (``rec`` itself, or a record apart from it): a plain
    version's ``out=``."""
    dst = record_out(out, rec, what)
    if dst.data_ptr() != rec.data.data_ptr():
        dst.copy_(rec.data)
    out.write_field(name, value)
    return out


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
