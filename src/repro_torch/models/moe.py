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

``make_moe_a2a`` is the reference's GShard-style expert parallelism on
the port's ``Mesh``: the experts split over the innermost data axis and
their ``d_ff`` over "model", the tokens over the data axes, and two
all-to-alls carry each data shard's buckets to the experts' shards and
back (``core/collectives.py``).  One process drives every shard, so the
block runs in stages over all shards with the collectives between them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import collectives as coll
from ..core.mesh import Mesh, Placement, ShardedArray
from .common import Init, ParamModule

__all__ = ["init_moe", "moe_capacity", "moe_block", "make_moe_a2a",
           "place_experts"]


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


def _route(router: torch.Tensor, x2d: torch.Tensor, top_k: int):
    """The router on tokens (T, d) -> (probs (T, E), gate_idx (T, K),
    gate_w (T, K) renormalised, aux): float32 logits and softmax, the
    top-k by ``_top_k``, and the Switch load-balance loss ``E * sum_e
    f_e p_e / top_k`` (f: the share of pairs routed to e, p: the mean
    router probability)."""
    E = router.shape[-1]
    logits = x2d.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gate_idx = _top_k(probs, top_k)                            # (T, K)
    gate_w = probs.gather(1, gate_idx)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    one_hot = (gate_idx[..., None] == torch.arange(
        E, device=x2d.device)).float()
    ce = one_hot.sum(dim=1).mean(dim=0)
    aux = E * torch.sum(me * ce) / top_k
    return probs, gate_idx, gate_w, aux


def _bucket(x2d: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
            C: int, top_k: int, dtype: torch.dtype) -> torch.Tensor:
    """The bucket buffer (E, C, d) in ``dtype``: slot ``(e, p)`` gathers
    the token of the ``p``-th pair in expert ``e``'s run of the stably
    sorted pairs, zeros past the run's end."""
    TK = order.numel()
    dev = x2d.device
    ends = torch.cat([starts[1:], torch.full_like(starts[:1], TK)])
    j = starts[:, None] + torch.arange(C, device=dev)          # (E, C)
    filled = j < ends[:, None]
    src_tok = order[j.clamp(max=TK - 1)] // top_k
    return torch.where(filled[..., None], x2d[src_tok].to(dtype),
                       torch.zeros((), dtype=dtype, device=dev))


def _combine(eo: torch.Tensor, slot: torch.Tensor, order: torch.Tensor,
             gate_w: torch.Tensor, top_k: int) -> torch.Tensor:
    """The experts' outputs (E*C, d) back per token (T, d): each pair
    reads its slot (a dropped one a zero row), in (token, k) order,
    weighted by its gate and summed over k."""
    d = eo.shape[-1]
    eo = torch.cat([eo, eo.new_zeros((1, d))])
    unsort = torch.argsort(order, stable=True)
    pair_out = eo[slot[unsort]].reshape(-1, top_k, d)
    return torch.sum(pair_out * gate_w[..., None].to(eo.dtype), dim=1)


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
    _, gate_idx, gate_w, aux = _route(p["router"], x2d, top_k)
    slot, keep, order, starts = _dispatch_slots(gate_idx, E, C)
    buf = _bucket(x2d, order, starts, C, top_k, cdt)           # (E, C, d)

    # -- expert compute: two products batched over the expert axis ---------
    f = p["wo"].shape[1]
    wi = p["wi"].to(cdt).reshape(E, d, 2 * f)
    h = torch.bmm(buf, wi).reshape(E, C, 2, f)
    h = F.silu(h[:, :, 0]) * h[:, :, 1]
    eo = torch.bmm(h, p["wo"].to(cdt)).reshape(E * C, d)
    out = _combine(eo, slot, order, gate_w, top_k)
    return out.to(x2d.dtype), aux.float()


# ---------------------------------------------------------------------------
# GShard-style expert parallelism: explicit all-to-alls over a mesh
# ---------------------------------------------------------------------------

def _ep_layout(mesh: Mesh, dp_axes):
    """(the data axes of size > 1, the expert axis (the innermost of
    them, or None), the "model" axis or None)."""
    dp = tuple(a for a in dp_axes if mesh.shape.get(a, 1) > 1)
    model = "model" if mesh.shape.get("model", 1) > 1 else None
    return dp, (dp[-1] if dp else None), model


def _expert_specs(ep_axis, model):
    return {"wi": (ep_axis, None, None, model), "wo": (ep_axis, model, None)}


def _divides(n: int, extent: int, what: str, axis) -> None:
    if extent % n:
        raise ValueError(f"make_moe_a2a: {what} of {extent} is not "
                         f"divisible by mesh axis {axis!r} ({n})")


def _place(w: torch.Tensor, name: str, mesh: Mesh, spec) -> ShardedArray:
    pl = Placement(mesh, spec)
    for extent, ax in zip(w.shape, spec):
        if ax is not None:
            _divides(mesh.shape[ax], extent, f"{name}'s extent", ax)
    return ShardedArray([coll.to_device(w[pl.slices(w.shape, i)], dev)
                         for i, dev in enumerate(mesh.devices)], pl, w.shape)


def place_experts(p, mesh: Mesh, *, dp_axes) -> dict:
    """The router (global) and the experts' ``wi``/``wo`` as
    ``ShardedArray``s in the reference's layout: ``wi`` ``(ep, None,
    None, "model")``, ``wo`` ``(ep, "model", None)``, ``ep`` the
    innermost data axis of size > 1 (outer data axes hold replicas).  A
    shard on the weights' own device is a view of them (nothing is
    copied on one card); on another device it is a copy."""
    _, ep_axis, model = _ep_layout(mesh, dp_axes)
    out = {"router": p["router"]}
    for name, spec in _expert_specs(ep_axis, model).items():
        out[name] = _place(p[name], name, mesh, spec)
    return out


def make_moe_a2a(mesh: Mesh, *, dp_axes, top_k: int,
                 capacity_factor: float, residual_tp: bool):
    """The MoE block with expert parallelism over the data axes and the
    experts' ``d_ff`` over "model", as the reference's ``make_moe_a2a``:
    returns ``fn(params, x2d) -> (y (T, d), aux ())``.

    ``params`` holds the router (d, E) and the experts' ``wi`` (E, d, 2,
    f) and ``wo`` (E, f, d), global (each shard reads its block of them:
    a view on one card) or placed by :func:`place_experts`.  ``x2d`` (T,
    d) is global; its rows split over the data axes, ``T_l`` to a
    shard.  In stages over all shards:

    1. per data shard, the router, ``_top_k`` and the buckets (E, C_l, d)
       at ``C_l = moe_capacity(T_l, ...)``, as ``moe_block`` at ``T_l``;
    2. ``all_to_all`` over the expert axis (split E, concat C): each
       shard holds its E/ep experts' buckets from every data shard;
    3. the expert products with the shard's experts and ``d_ff`` block;
    4. the reverse ``all_to_all``;
    5. the combine, a partial sum over the ``d_ff`` blocks;
    6. ``psum`` over "model" (``psum_scatter`` over d_model when
       ``residual_tp``), and the aux the ``pmean`` over the data axes
       and "model" of the per-shard estimates.

    ``y`` is gathered back to ``x2d``'s device.  So expert parallelism
    computes ``moe_block`` on each data shard's tokens.  A token count, E,
    ``d_ff`` or (with ``residual_tp``) ``d_model`` that the mesh does
    not divide raises."""
    dp, ep_axis, model = _ep_layout(mesh, dp_axes)
    dpn = math.prod(mesh.shape[a] for a in dp)
    ep = mesh.shape[ep_axis] if ep_axis else 1
    tp = mesh.shape[model] if model else 1
    specs = _expert_specs(ep_axis, model)
    data_of = [coll.axis_index(mesh, dp, i) if dp else 0
               for i in range(mesh.size)]

    def shards_of(w, name):
        if isinstance(w, ShardedArray):
            if w.mesh is not mesh or w.placement.spec != specs[name]:
                raise ValueError(f"make_moe_a2a: {name} placed as "
                                 f"{w.placement.spec}, expected "
                                 f"{specs[name]} on this mesh")
            return list(w.shards)
        return list(_place(w, name, mesh, specs[name]).shards)

    def fn(params, x2d):
        T, d = x2d.shape
        E = params["router"].shape[-1]
        _divides(dpn, T, "the token count", dp)
        _divides(ep, E, "the expert count", ep_axis)
        _divides(tp, params["wo"].shape[1], "d_ff", model)
        if residual_tp and model:
            _divides(tp, d, "d_model", model)
        wi, wo = shards_of(params["wi"], "wi"), shards_of(params["wo"], "wo")
        T_l = T // dpn
        C_l = moe_capacity(T_l, E, top_k, capacity_factor)

        # 1. route and bucket each data shard's tokens, once per device
        routed = {}
        for i, dev in enumerate(mesh.devices):
            k = data_of[i]
            if (k, dev) not in routed:
                x_l = coll.to_device(x2d[k * T_l:(k + 1) * T_l], dev)
                _, gate_idx, gate_w, aux = _route(
                    coll.to_device(params["router"], dev), x_l, top_k)
                slot, _, order, starts = _dispatch_slots(gate_idx, E, C_l)
                routed[(k, dev)] = (_bucket(x_l, order, starts, C_l, top_k,
                                            x_l.dtype), slot, order, gate_w,
                                    aux)
        parts = [routed[(data_of[i], dev)]
                 for i, dev in enumerate(mesh.devices)]
        bufs = [r[0] for r in parts]
        # 2. each shard gets its experts' buckets from every data shard:
        # (E, C_l, d) -> (E/ep, C_l * ep, d)
        if ep_axis:
            bufs = coll.all_to_all(bufs, mesh, ep_axis, 0, 1)
        # 3. the shard's experts over its d_ff block
        outs = []
        for buf, wi_l, wo_l in zip(bufs, wi, wo):
            wi_l = wi_l.to(buf.dtype)
            h = F.silu(torch.bmm(buf, wi_l[:, :, 0])) * torch.bmm(
                buf, wi_l[:, :, 1])
            outs.append(torch.bmm(h, wo_l.to(h.dtype)))
        # 4. back to the data shards: (E/ep, C_l * ep, d) -> (E, C_l, d)
        if ep_axis:
            outs = coll.all_to_all(outs, mesh, ep_axis, 1, 0)
        # 5. the combine: partial sums over the d_ff blocks
        ys = [_combine(o.reshape(E * C_l, d), r[1], r[2], r[3], top_k)
              for o, r in zip(outs, parts)]
        # 6. the block's one big collective, and the aux's mean
        if model:
            ys = (coll.psum_scatter(ys, mesh, model, scatter_dimension=1)
                  if residual_tp else coll.psum(ys, mesh, model))
        auxs = [r[4] for r in parts]
        for a in dp:
            auxs = coll.pmean(auxs, mesh, a)
        if model:
            auxs = coll.pmean(auxs, mesh, model)
        y = torch.cat([_gather_row(ys, mesh, dp, data_of, k, model,
                                   residual_tp, x2d.device)
                       for k in range(dpn)])
        return y, coll.to_device(auxs[0], x2d.device)

    return fn


def _gather_row(ys, mesh: Mesh, dp, data_of, k: int, model,
                residual_tp: bool, device) -> torch.Tensor:
    """Data shard ``k``'s output (T_l, d) on ``device``: from the shard
    at model coordinate 0, or with ``residual_tp`` its d_model blocks
    from the shards along "model" in order."""
    first = [i for i in range(mesh.size) if data_of[i] == k and all(
        c == 0 for a, c in zip(mesh.axis_names, mesh.coords(i))
        if a not in dp)][0]
    if not (residual_tp and model):
        return coll.to_device(ys[first], device)
    group = next(g for g in coll.axis_groups(mesh, model) if first in g)
    return torch.cat([coll.to_device(ys[i], device) for i in group], dim=1)
