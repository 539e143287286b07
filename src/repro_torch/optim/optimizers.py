"""AdamW and Adafactor over the port's parameter modules, with the
reference's formulas (``repro.optim.optimizers``).

An :class:`Optimizer` is an ``(init, update)`` pair.  ``init(params)``
makes the state, tensors keyed by parameter name (``params`` is an
``nn.Module`` or a mapping of name -> tensor); ``update(grads, state,
params, step)`` updates the parameters and the state in place, the
counterpart of the reference's donated train state, and returns them.
Every update is computed in float32 from the float32 moments and rounded
once to the parameter's dtype.  ``torch.optim.AdamW`` is not used: it
decays the parameter in place before the step, which rounds a bfloat16
parameter twice.  The reference's ZeRO-1 sharding specs
(``state_pspecs``) belong to its GSPMD mesh and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import torch
from torch import nn

__all__ = ["Optimizer", "AdamW", "Adafactor", "clip_by_global_norm",
           "make_optimizer"]


def _named(params) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _as_step(step, device) -> torch.Tensor:
    return torch.as_tensor(step, device=device)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """Scale the gradients (name -> tensor) so their global L2 norm is at
    most ``max_norm``; returns ``(grads, norm)``, the grads in their own
    dtypes and the norm a float32 scalar tensor."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


@dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params, step) ->
    (params, state)``, both updated in place."""

    init: Callable
    update: Callable


def AdamW(lr: Callable | float, *, b1: float = 0.9, b2: float = 0.95,  # noqa: N802
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    """AdamW with float32 moments and decoupled weight decay applied to
    every parameter inside the step: ``p -= lr_t * (m_hat / (sqrt(v_hat)
    + eps) + wd * p)``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        named = _named(params)
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": {k: zeros(p) for k, p in named.items()},
                "v": {k: zeros(p) for k, p in named.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        named = _named(params)
        dev = next(iter(named.values())).device
        step = _as_step(step, dev)
        t = step.to(torch.float32) + 1.0
        lr_t = lr_fn(step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for k, p in named.items():
            g = grads[k].float()
            m, v = state["m"][k], state["v"][k]
            m32 = m.float() * b1 + (1 - b1) * g
            v32 = v.float() * b2 + (1 - b2) * g * g
            del g
            step_ = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            step_ = step_ + weight_decay * p.float()
            p.copy_(p.float() - lr_t * step_)
            del step_
            m.copy_(m32)
            v.copy_(v32)
        return params, state

    return Optimizer(init, update)


def Adafactor(lr: Callable | float, *, eps: float = 1e-30,  # noqa: N802
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored second moment (Shazeer & Stern, 2018), no first moment:
    row and column accumulators ``vr``/``vc`` for a parameter of two or
    more dims, a full ``v`` otherwise; ``beta = 1 - t^-0.8`` and the
    update's RMS clipped to ``clip_threshold``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {k: one(p) for k, p in _named(params).items()}

    @torch.no_grad()
    def update(grads, state, params, step):
        named = _named(params)
        dev = next(iter(named.values())).device
        step = _as_step(step, dev)
        t = step.to(torch.float32) + 1.0
        beta = 1.0 - t ** (-0.8)
        lr_t = lr_fn(step)
        for k, p in named.items():
            g = grads[k].float()
            s = state[k]
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rfac = torch.rsqrt(
                    vr / torch.mean(vr, dim=-1, keepdim=True) + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g * rfac[..., None] * cfac[..., None, :]
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                s["v"].copy_(v)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p32 = p.float()
            p.copy_(p32 - lr_t * (u + weight_decay * p32))
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    """``"adamw"`` or ``"adafactor"``."""
    if name == "adamw":
        return AdamW(lr, **kw)
    if name == "adafactor":
        return Adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
