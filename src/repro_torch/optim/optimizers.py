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

A tensor of more than ``_BLOCK`` elements is updated (and clipped) in
blocks of rows of its leading axis, so that no float32 temporary holds
more than one block: arctic-480b's ``wi`` of (128, 7168, 2, 4864) is 36
GB in float32.  Each element gets the arithmetic it would get whole;
only the sums over a whole tensor (the global norm, Adafactor's RMS and
a matrix's column means) add their blocks' sums in another order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import torch
from torch import nn

__all__ = ["Optimizer", "AdamW", "Adafactor", "clip_by_global_norm",
           "clip_by_global_norm_", "make_optimizer"]


def _named(params) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _as_step(step, device) -> torch.Tensor:
    return torch.as_tensor(step, device=device)


#: elements above which a tensor is worked on in blocks of leading rows
_BLOCK = 1 << 26


def _blocks(t: torch.Tensor, *, whole: bool = False) -> list:
    """Indices of ``t`` in blocks of rows of its leading axis, each of at
    most ``_BLOCK`` elements (at least one row); ``[...]`` (all of it)
    for a small or 0-d tensor, or with ``whole``."""
    if whole or t.dim() == 0 or t.numel() <= _BLOCK:
        return [...]
    rows = max(1, _BLOCK * t.shape[0] // t.numel())
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """Scale the gradients (name -> tensor) so their global L2 norm is at
    most ``max_norm``; returns ``(grads, norm)``, new grads in their own
    dtypes and the norm a float32 scalar tensor."""
    return clip_by_global_norm_({k: g.clone() for k, g in grads.items()},
                                max_norm)


def clip_by_global_norm_(grads: Mapping[str, torch.Tensor],
                         max_norm: float):
    """:func:`clip_by_global_norm` in place: the train step's form, which
    holds no second set of gradients.  A tensor that two names share is
    scaled once."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g[r].float()))
                        for g in grads.values() for r in _blocks(g)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in {id(g): g for g in grads.values()}.values():
        for r in _blocks(g):
            g[r] = (g[r].float() * scale).to(g.dtype)
    return grads, gn


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
            m, v = state["m"][k], state["v"][k]
            for r in _blocks(p):
                g = grads[k][r].float()
                m32 = m[r].float() * b1 + (1 - b1) * g
                v32 = v[r].float() * b2 + (1 - b2) * g * g
                del g
                step_ = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
                step_ = step_ + weight_decay * p[r].float()
                p[r] = p[r].float() - lr_t * step_
                del step_
                m[r] = m32
                v[r] = v32
        return params, state

    return Optimizer(init, update)


def _stacks(named: Mapping[str, torch.Tensor]) -> dict[str, list[str]]:
    """The reference's leaves: its tree stacks the layer groups (and an
    encoder's layers) on a leading axis, so the port's
    ``groups.3.p0.attn.wq`` is row 3 of its leaf ``groups.p0.attn.wq``.
    Returns leaf name -> the port's names in it, in row order (a name
    without an index is a leaf alone)."""
    out: dict[str, list[str]] = {}
    for name in named:
        key = ".".join(part for part in name.split(".")
                       if not part.isdigit())
        out.setdefault(key, []).append(name)
    return out


def Adafactor(lr: Callable | float, *, eps: float = 1e-30,  # noqa: N802
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored second moment (Shazeer & Stern, 2018), no first moment:
    row and column accumulators ``vr``/``vc`` for a leaf of two or more
    dims, a full ``v`` otherwise; ``beta = 1 - t^-0.8`` and the update's
    RMS clipped to ``clip_threshold``.  The leaves are the reference's
    (:func:`_stacks`): a stacked leaf ``(G, *shape)`` factors over its
    last two dims and takes one RMS over its G rows, and the state is
    keyed by the leaf's name (``groups.p0.ln_mix``: ``vr`` (G,), ``vc``
    (d,) for a stack of vectors)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        named = _named(params)
        state = {}
        for key, names in _stacks(named).items():
            p = named[names[0]]
            shape = p.shape if names[0] == key else (len(names), *p.shape)
            f32 = dict(dtype=torch.float32, device=p.device)
            state[key] = ({"vr": torch.zeros(shape[:-1], **f32),
                           "vc": torch.zeros(shape[:-2] + shape[-1:], **f32)}
                          if len(shape) >= 2
                          else {"v": torch.zeros(shape, **f32)})
        return state

    @torch.no_grad()
    def update(grads, state, params, step):
        named = _named(params)
        dev = next(iter(named.values())).device
        step = _as_step(step, dev)
        t = step.to(torch.float32) + 1.0
        beta = 1.0 - t ** (-0.8)
        lr_t = lr_fn(step)

        def update_of(p, g, st, r, vr_mean):
            """The unclipped update of rows ``r`` of part ``p``."""
            g = g[r].float()
            if p.dim() < 2:
                return g * torch.rsqrt(st["v"] + eps)
            rows = ... if p.dim() == 2 else r    # a matrix: one vc, one mean
            rfac = torch.rsqrt(st["vr"][r] / vr_mean[rows] + eps)
            return g * rfac[..., None] * torch.rsqrt(
                st["vc"][rows] + eps)[..., None, :]

        for key, names in _stacks(named).items():
            s = state[key]
            # (parameter, gradient, its state): a stack of matrices row by
            # row (a row's vr and vc are views of the leaf's); a stack of
            # vectors or scalars as one (G, ...) copy, written back below
            ps = [named[n] for n in names]
            if names[0] == key:
                parts = [(ps[0], grads[key], s)]
            elif ps[0].dim() >= 2:
                parts = [(p, grads[n], {k: v[i] for k, v in s.items()})
                         for i, (n, p) in enumerate(zip(names, ps))]
            else:
                parts = [(torch.stack(ps), torch.stack([grads[n]
                                                        for n in names]), s)]
            # the moments, block by block: the leading axes of three or
            # more dims index independent matrices; a matrix's row blocks
            # add up its column means
            work = []
            for p, g, st in parts:
                blocks = _blocks(p, whole=p.dim() < 2)
                cols = 0.0
                for r in blocks:
                    g2 = g[r].float() ** 2 + eps
                    if p.dim() < 2:
                        st["v"].copy_(beta * st["v"] + (1 - beta) * g2)
                        continue
                    st["vr"][r] = beta * st["vr"][r] + (1 - beta) * \
                        torch.mean(g2, dim=-1)
                    if p.dim() == 2:
                        cols = cols + torch.sum(g2, dim=-2)
                    else:
                        st["vc"][r] = beta * st["vc"][r] + (1 - beta) * \
                            torch.mean(g2, dim=-2)
                    del g2
                if p.dim() == 2:
                    st["vc"].copy_(beta * st["vc"]
                                   + (1 - beta) * (cols / p.shape[0]))
                vr_mean = (torch.mean(st["vr"], dim=-1, keepdim=True)
                           if p.dim() >= 2 else None)
                work += [(p, g, st, r, vr_mean) for r in blocks]
            numel = sum(p.numel() for p, _, _ in parts)
            kept, msq = None, 0.0
            for piece in work:
                u = update_of(*piece)
                msq = msq + torch.mean(torch.square(u)) * (u.numel() / numel)
                # one piece's update is kept, several pieces' made again
                kept = u if len(work) == 1 else None
                del u
            rms = torch.sqrt(msq + 1e-12)
            for piece in work:
                u = kept if kept is not None else update_of(*piece)
                u = u / torch.clamp(rms / clip_threshold, min=1.0)
                p, r = piece[0], piece[3]
                p32 = p[r].float()
                p[r] = p32 - lr_t * (u + weight_decay * p32)
            if names[0] != key and ps[0].dim() < 2:
                for dst, src in zip(ps, parts[0][0]):
                    dst.copy_(src)
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    """``"adamw"`` or ``"adafactor"``."""
    if name == "adamw":
        return AdamW(lr, **kw)
    if name == "adafactor":
        return Adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
