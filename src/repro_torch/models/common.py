"""Model substrate: parameter modules and their initialisation, norms,
RoPE.

Parameters live in an ``nn.Module`` tree whose attribute names follow the
JAX package's parameter-tree paths (``groups.3.p0.attn.wq`` is the JAX
``params["groups"]["p0"]["attn"]["wq"][3]``).  :class:`ParamModule` also
answers ``p["wq"]`` and ``"q_norm" in p``, so the block functions read
like their counterparts in ``repro.models``.  The JAX package's logical
sharding axes have no counterpart here: the port runs one device, and
sharding belongs to the multi-GPU queue.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["ParamModule", "Init", "rms_norm", "layer_norm", "rope_cos_sin",
           "apply_rope", "count_params"]


class ParamModule(nn.Module):
    """An ``nn.Module`` whose parameters and children are also reachable
    as ``p[name]``, with ``name in p`` testing for them."""

    def __getitem__(self, name: str):
        if name in self._parameters or name in self._modules:
            return getattr(self, name)
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class Init:
    """Creates parameters on ``device`` in ``dtype`` from one
    ``torch.Generator`` stream (one per device type: a CUDA generator for
    the card, so weights are made there in their own dtype).  On the
    ``meta`` device (no generator) it makes shapes only and allocates
    nothing.  Parameters are made with ``requires_grad=False``, as
    serving wants them; a trainer turns it on."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def dense(self, p: nn.Module, name: str, shape: Sequence[int], *,
              fan_in: Optional[int] = None, scale: float = 1.0) -> None:
        """Truncated normal in [-2 std, 2 std] with std =
        ``scale / sqrt(fan_in)``, as the reference's ``ParamTree.dense``."""
        shape = tuple(shape)
        if fan_in is None:
            fan_in = shape[0] if shape else 1
        std = scale / math.sqrt(max(fan_in, 1))
        t = torch.empty(shape, dtype=self.dtype, device=self.device)
        if self.device.type != "meta":
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=self.generator)
        p.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def const(self, p: nn.Module, name: str, shape: Sequence[int],
              value: float = 0.0) -> None:
        """A parameter filled with ``value``."""
        t = torch.full(tuple(shape), value, dtype=self.dtype,
                       device=self.device)
        p.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def custom(self, p: nn.Module, name: str, value: torch.Tensor) -> None:
        """A parameter with the given value, cast to the parameter dtype."""
        t = value.to(device=self.device, dtype=self.dtype)
        p.register_parameter(name, nn.Parameter(t, requires_grad=False))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in float32; ``plus_one`` uses the gemma convention
    (scale = 1 + w)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (x * w).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, rot_dim: int, *,
                 base: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape ``(*positions.shape, rot_dim // 2)``,
    float32."""
    inv = 1.0 / (base ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                       device=positions.device) / rot_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               mode: str = "half") -> torch.Tensor:
    """Rotate the leading ``2 * cos.shape[-1]`` dims of the head axis.

    x: ``(..., S, H, D)`` with cos/sin ``(..., S, R/2)`` broadcast over H;
    ``half`` pairs the two halves (llama/neox), ``interleaved`` pairs
    even and odd dims (GPT-J / chatglm)."""
    r2 = cos.shape[-1]
    rot, rest = x[..., : 2 * r2], x[..., 2 * r2:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    if mode == "half":
        x1, x2 = rot[..., :r2], rot[..., r2:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    elif mode == "interleaved":
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).flatten(-2)
    else:
        raise ValueError(f"unknown rope mode {mode!r}")
    out = out.to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def count_params(module: nn.Module) -> int:
    """Number of scalar parameters."""
    return sum(p.numel() for p in module.parameters())
