"""LM assembly: init, the training loss, prefill and decode for the archs
the port serves, built from the uniform layer blocks, as
``repro.models.lm``.

The parameters are an ``nn.Module`` tree named like the JAX tree:
``embed``, ``groups[g].p{i}`` (the JAX package stacks the groups on a
leading axis instead), ``tail{i}.layer``, ``final.ln`` and ``head``
(absent with tied embeddings).  Caches mirror the JAX cache pytree with a
list per group where JAX stacks: ``{"groups": [{"p0": entry, ...}, ...],
"tail": [entry, ...], "pos": int tensor}``; an entry is KV storage for an
attention layer (a ring of ``min(window, max_seq)`` slots for a local
one), ``(ssd_state, conv_state)`` for a Mamba layer and ``(h,
conv_state)`` for an RG-LRU layer.

``cfg.remat == "full"`` recomputes each layer group in the backward
(``torch.utils.checkpoint``, one call per group), as the reference's
``jax.checkpoint`` of its scanned group body.  The encoder of
encoder-decoder archs is in ROADMAP queue 5.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from .blocks import (fill_attn_cache, init_layer, init_norm, layer_decode,
                     layer_forward, make_attn_cache, make_layer_cache,
                     norm_apply)
from .common import Init, ParamModule, count_params
from .config import ModelConfig

__all__ = ["NEG_INF", "init_lm", "param_count", "embed_tokens", "lm_logits",
           "ce_loss", "decoder_pass", "assemble_input", "forward_loss",
           "init_caches", "prefill", "decode_step"]

NEG_INF = -1e30


def _refuse_arch(cfg: ModelConfig) -> None:
    if cfg.is_encdec or cfg.frontend_dim:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and VLM archs are ROADMAP queue 5 "
            f"(encoder-decoder and VLM serving)")


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device: Any = None) -> ParamModule:
    """Random weights for ``cfg`` from ``generator``, made on ``device``
    (``None``: the GPU) in the config's parameter dtype.  The generator's
    device must be ``device``'s type."""
    _refuse_arch(cfg)
    return _build_lm(cfg, Init(generator, cfg.param_torch_dtype,
                               resolve_device(device)))


def param_count(cfg: ModelConfig) -> int:
    """Number of scalar parameters of ``cfg``'s model, counted from a
    model built on the ``meta`` device: nothing is allocated, as the
    reference's ``eval_shape``."""
    _refuse_arch(cfg)
    return count_params(_build_lm(cfg, Init(None, cfg.param_torch_dtype,
                                            "meta")))


def _build_lm(cfg: ModelConfig, init: Init) -> ParamModule:
    lm = ParamModule()
    Vp, d = cfg.padded_vocab(), cfg.d_model
    init.dense(lm, "embed", (Vp, d), fan_in=d)
    n_groups, pattern, tail = cfg.layer_groups()
    groups = nn.ModuleList()
    for _ in range(n_groups):
        g = ParamModule()
        for i, kind in enumerate(pattern):
            init_layer(init, g, cfg, kind, name=f"p{i}")
        groups.append(g)
    lm.add_module("groups", groups)
    for i, kind in enumerate(tail):
        t = ParamModule()
        init_layer(init, t, cfg, kind, name="layer")
        lm.add_module(f"tail{i}", t)
    fin = ParamModule()
    init_norm(init, fin, cfg, "ln", d)
    lm.add_module("final", fin)
    if not cfg.tie_embeddings:
        init.dense(lm, "head", (Vp, d), fan_in=d)
    return lm


def _layers(params, cfg: ModelConfig):
    """(layer params, kind, ("groups", g, "p{i}") | ("tail", i)) in the
    reference's scan order."""
    n_groups, pattern, tail = cfg.layer_groups()
    for g in range(n_groups):
        for i, kind in enumerate(pattern):
            yield params["groups"][g][f"p{i}"], kind, ("groups", g, f"p{i}")
    for i, kind in enumerate(tail):
        yield params[f"tail{i}"]["layer"], kind, ("tail", i)


def embed_tokens(params, tokens, cfg: ModelConfig):
    """Token embeddings in the compute dtype."""
    h = params["embed"].to(cfg.compute_torch_dtype)[tokens]
    if cfg.scale_embed:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def lm_logits(params, h, cfg: ModelConfig):
    """Logits over the (padded) vocabulary; soft-capped where the config
    says so, padded entries at -1e30."""
    w = (params["head"] if "head" in params else params["embed"]).to(h.dtype)
    logits = h @ w.t()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    Vp = w.shape[0]
    if Vp != cfg.vocab_size:
        mask = torch.arange(Vp, device=h.device) < cfg.vocab_size
        logits = torch.where(mask, logits, NEG_INF)
    return logits


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over positions with label >= 0, in float32."""
    valid = labels >= 0
    lab = torch.clamp(labels, min=0).long()
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, lab[..., None])[..., 0]
    per_tok = (lse - ll) * valid
    n = torch.clamp(valid.sum(), min=1)
    return per_tok.sum() / n


def _group_forward(gp, h, pattern, cfg: ModelConfig, want_cache: bool,
                   use_kernel: bool):
    caches = {}
    for i, kind in enumerate(pattern):
        h, caches[f"p{i}"] = layer_forward(gp[f"p{i}"], h, kind, cfg,
                                           want_cache=want_cache,
                                           use_kernel=use_kernel)
    return h, caches


def decoder_pass(params, h, cfg: ModelConfig, *, want_cache: bool = False,
                 use_kernel: bool = True):
    """-> (h after the final norm, caches | None), caches as
    ``{"groups": [...], "tail": [...]}`` of raw layer emissions.  Under
    grad mode with ``cfg.remat == "full"`` each layer group is recomputed
    in the backward instead of keeping its activations."""
    n_groups, pattern, tail = cfg.layer_groups()
    remat = (cfg.remat == "full" and not want_cache
             and torch.is_grad_enabled())
    groups = []
    for g in range(n_groups):
        gp = params["groups"][g]
        if remat:
            h = checkpoint(
                lambda x, gp=gp: _group_forward(gp, x, pattern, cfg, False,
                                                use_kernel)[0],
                h, use_reentrant=False)
            groups.append(None)
        else:
            h, c = _group_forward(gp, h, pattern, cfg, want_cache,
                                  use_kernel)
            groups.append(c)
    tails = []
    for i, kind in enumerate(tail):
        h, c = layer_forward(params[f"tail{i}"]["layer"], h, kind, cfg,
                             want_cache=want_cache, use_kernel=use_kernel)
        tails.append(c)
    h = norm_apply(params["final"], h, cfg, "ln")
    return h, ({"groups": groups, "tail": tails} if want_cache else None)


def assemble_input(params, batch, cfg: ModelConfig):
    """Token embeddings of ``batch["tokens"]`` (B, S) -> (h, positions).
    Encoder-decoder and VLM inputs are ROADMAP queue 5."""
    _refuse_arch(cfg)
    h = embed_tokens(params, batch["tokens"], cfg)
    return h, torch.arange(h.shape[1], dtype=torch.int32, device=h.device)


def forward_loss(params, batch, cfg: ModelConfig, *,
                 aux_weight: float = 0.01, use_kernel: bool = True):
    """Training objective: CE + ``aux_weight`` * aux, with aux 0 for the
    dense and SSM archs the port runs (the MoE load-balance loss is
    ROADMAP queue 5).  Returns ``(total, {"loss", "aux"})``.  On the GPU
    attention runs on K6 and the SSD on K7 unless ``use_kernel=False``;
    their gradients are the plain versions'."""
    h, _ = assemble_input(params, batch, cfg)
    h, _ = decoder_pass(params, h, cfg, use_kernel=use_kernel)
    logits = lm_logits(params, h, cfg)
    loss = ce_loss(logits, batch["labels"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux}


def init_caches(params, cfg: ModelConfig, batch: int, max_seq: int,
                device: Any = None):
    """Empty decode caches (attention caches sized to ``max_seq``, local
    ones to their window)."""
    n_groups, pattern, tail = cfg.layer_groups()
    dt = cfg.compute_torch_dtype
    one = lambda kind: make_layer_cache(kind, cfg, batch, max_seq, dt, device)
    return {"groups": [{f"p{i}": one(k) for i, k in enumerate(pattern)}
                       for _ in range(n_groups)],
            "tail": [one(k) for k in tail],
            "pos": torch.zeros((), dtype=torch.int32,
                               device=resolve_device(device))}


def _prefill_to_decode_cache(raw, kind, cfg: ModelConfig, batch, max_seq,
                             dtype, device):
    """A layer_forward cache emission as decode-ready storage."""
    if kind in ("A", "L"):
        k, v = raw
        window = cfg.window if kind == "L" else None
        store = make_attn_cache(cfg, batch, max_seq, window, dtype, device)
        # fresh: filled in place, no clone
        return fill_attn_cache(store, k, v, cfg, window, out=store)
    return raw   # Mamba and RG-LRU states are decode-ready


def prefill(params, batch, cfg: ModelConfig, *,
            max_seq: Optional[int] = None, use_kernel: bool = True):
    """Process the prompts ``batch["tokens"]`` (B, S); -> (last-token
    logits (B, Vp), caches).  On the GPU attention runs on K6 and the SSD
    on K7 unless ``use_kernel=False``."""
    _refuse_arch(cfg)
    tokens = batch["tokens"]
    h = embed_tokens(params, tokens, cfg)
    B, S = tokens.shape
    max_seq = max_seq or S
    h, raw = decoder_pass(params, h, cfg, want_cache=True,
                          use_kernel=use_kernel)
    dt, dev = cfg.compute_torch_dtype, h.device
    n_groups, pattern, tail = cfg.layer_groups()
    caches = {
        "groups": [{f"p{i}": _prefill_to_decode_cache(
            raw["groups"][g][f"p{i}"], kind, cfg, B, max_seq, dt, dev)
            for i, kind in enumerate(pattern)} for g in range(n_groups)],
        "tail": [_prefill_to_decode_cache(raw["tail"][i], kind, cfg, B,
                                          max_seq, dt, dev)
                 for i, kind in enumerate(tail)],
        "pos": torch.tensor(S, dtype=torch.int32, device=dev)}
    return lm_logits(params, h[:, -1], cfg), caches


def decode_step(params, caches, tokens_t, cfg: ModelConfig):
    """One token for the whole batch at the caches' position.  tokens_t
    (B,) -> (logits (B, Vp), new caches)."""
    pos = caches["pos"]
    h_t = embed_tokens(params, tokens_t, cfg)
    groups = [dict(g) for g in caches["groups"]]
    tails = list(caches["tail"])
    for p, kind, where in _layers(params, cfg):
        if where[0] == "groups":
            h_t, groups[where[1]][where[2]] = layer_decode(
                p, h_t, kind, cfg, cache=groups[where[1]][where[2]], pos=pos)
        else:
            h_t, tails[where[1]] = layer_decode(
                p, h_t, kind, cfg, cache=tails[where[1]], pos=pos)
    h_t = norm_apply(params["final"], h_t, cfg, "ln")
    return lm_logits(params, h_t, cfg), {"groups": groups, "tail": tails,
                                         "pos": pos + 1}
