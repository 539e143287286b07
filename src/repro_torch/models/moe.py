"""Mixture-of-Experts block: top-k routing with capacity-bucketed dispatch,
as ``repro.models.moe`` (``init_moe``, ``moe_capacity``,
``_dispatch_slots``, ``moe_block``).

Tokens are sorted by expert and bucketed into a dense ``(E, C, d)``
buffer, the expert FFNs run as two batched products over the expert axis
(``torch.bmm``; the experts' weights are one record-of-experts tensor
each, expert-major), and each (token, k) pair's output is gathered back
and weighted by its router weight.  Pairs beyond an expert's capacity
are dropped; the router is softmax-then-top-k.

Every step stays on the device with no read back to the host, so a
decode step that routes is captured into a CUDA graph as it is:
- top-k (``_top_k``) is a stable descending sort, so ties go to the
  lower expert index, as ``lax.top_k`` breaks them (a zero router ties
  every expert);
- the bucket buffer is a gather: slot ``(e, p)`` holds the ``p``-th pair
  of expert ``e``'s run in the stably sorted pairs, or zeros past the
  run's end; the reference's scatter with ``mode="drop"`` fills the
  same slots with the same pairs;
- a dropped pair reads a zero row appended to the experts' outputs (the
  reference's ``mode="fill"`` gather);
- the experts' token counts are a comparison against ``arange(E)``.

The router logits, the softmax and the gate weights are float32; the
bucket buffer, the expert products and the weighted pair outputs are in
the compute dtype, where the reference rounds them.

The reference's ``make_moe_a2a`` (expert parallelism with an all-to-all
over a mesh) is not ported here: the port runs one device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import Init, ParamModule

__all__ = ["init_moe", "moe_capacity", "moe_block"]


def init_moe(init: Init, parent: ParamModule, *, d_model: int, d_ff: int,
             n_experts: int, name: str = "moe") -> None:
    """The router ``(d, E)`` and the experts' ``wi (E, d, 2, f)`` and ``wo
    (E, f, d)`` as child ``name`` of ``parent``, fan-in scaled."""
    p = ParamModule()
    init.dense(p, "router", (d_model, n_experts), fan_in=d_model)
    init.dense(p, "wi", (n_experts, d_model, 2, d_ff), fan_in=d_model)
    init.dense(p, "wo", (n_experts, d_ff, d_model), fan_in=d_ff)
    parent.add_module(name, p)


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert: ``capacity_factor * top_k * n_tokens / n_experts``
    rounded up to a multiple of 8, at least 8."""
    c = int(capacity_factor * top_k * n_tokens / n_experts)
    return max(8, ((c + 7) // 8) * 8)


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The router's choice: the indices of each row's ``k`` largest
    probabilities, largest first, ties to the lower expert index (a
    stable descending sort; ``lax.top_k``'s order)."""
    return torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[:, :k]


def _dispatch_slots(gate_idx: torch.Tensor, E: int, C: int):
    """Sort (token, k) pairs by expert and bucket them to capacity ``C``.

    Returns (slot (T*K,) into a flat (E*C) buffer, ``E*C`` meaning
    dropped; the keep mask; the stable sort order; each expert's run
    start in the sorted pairs, (E,))."""
    flat_e = gate_idx.reshape(-1)
    TK = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(E, dtype=sorted_e.dtype, device=flat_e.device)
    starts = torch.searchsorted(sorted_e, experts)          # left side
    pos_in_e = torch.arange(TK, device=flat_e.device) - starts[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return slot, keep, order, starts


def moe_block(p, x2d: torch.Tensor, *, top_k: int = 2,
              capacity_factor: float = 1.25, dropless: bool = False,
              dtype: Optional[torch.dtype] = None):
    """x2d (T, d) -> (out (T, d), aux ()).

    ``dropless=True`` sizes every expert's bucket to ``T * top_k`` (no
    drops): the decode step's form, where T is the batch.  ``aux`` is the
    Switch load-balance loss ``E * sum_e f_e p_e / top_k`` (f: the share
    of pairs routed to e, p: the mean router probability), float32."""
    T, d = x2d.shape
    E = p["router"].shape[-1]
    C = T * top_k if dropless else moe_capacity(T, E, top_k,
                                                capacity_factor)
    cdt = dtype or x2d.dtype
    dev = x2d.device

    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gate_idx = _top_k(probs, top_k)                            # (T, K)
    gate_w = probs.gather(1, gate_idx)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    # -- aux loss ----------------------------------------------------------
    me = probs.mean(dim=0)
    one_hot = (gate_idx[..., None] == torch.arange(E, device=dev)).float()
    ce = one_hot.sum(dim=1).mean(dim=0)
    aux = E * torch.sum(me * ce) / top_k

    # -- dispatch: each bucket slot gathers its pair's token ---------------
    slot, keep, order, starts = _dispatch_slots(gate_idx, E, C)
    TK = T * top_k
    ends = torch.cat([starts[1:], torch.full_like(starts[:1], TK)])
    j = starts[:, None] + torch.arange(C, device=dev)          # (E, C)
    filled = j < ends[:, None]
    src_tok = order[j.clamp(max=TK - 1)] // top_k
    buf = torch.where(filled[..., None], x2d[src_tok].to(cdt),
                      torch.zeros((), dtype=cdt, device=dev))  # (E, C, d)

    # -- expert compute: two products batched over the expert axis ---------
    f = p["wo"].shape[1]
    wi = p["wi"].to(cdt).reshape(E, d, 2 * f)
    h = torch.bmm(buf, wi).reshape(E, C, 2, f)
    h = F.silu(h[:, :, 0]) * h[:, :, 1]
    eo = torch.bmm(h, p["wo"].to(cdt)).reshape(E * C, d)

    # -- combine: each pair reads its slot (a dropped one the zero row),
    # back in (token, k) order, weighted and summed over k ---------------
    eo = torch.cat([eo, eo.new_zeros((1, d))])
    unsort = torch.argsort(order, stable=True)
    pair_out = eo[slot[unsort]].reshape(T, top_k, d)
    out = torch.sum(pair_out * gate_w[..., None].to(cdt), dim=1)
    return out.to(x2d.dtype), aux.float()
