"""LM assembly: init, the encoder, the training loss, prefill and decode
for the archs the port serves, built from the uniform layer blocks, as
``repro.models.lm``.

The parameters are an ``nn.Module`` tree named like the JAX tree:
``embed``, ``frontend_proj`` (archs with a modality frontend),
``encoder[e].p0`` and ``enc_final.ln`` (encoder-decoder archs),
``groups[g].p{i}`` (the JAX package stacks the groups, and the encoder's
layers, on a leading axis instead), ``tail{i}.layer``, ``final.ln`` and
``head`` (absent with tied embeddings).  Caches mirror the JAX cache
pytree with a list per group where JAX stacks: ``{"groups": [{"p0":
entry, ...}, ...], "tail": [entry, ...], "pos": int tensor}``; an entry
is KV storage for an attention layer (a ring of ``min(window, max_seq)``
slots for a local one), ``(ssd_state, conv_state)`` for a Mamba layer and
``(h, conv_state)`` for an RG-LRU layer.  An encoder-decoder's attention
entry is ``{"self": storage, "cross": storage}``: the cross cache holds
the encoder output's keys and values, one slot a frame.

A batch is ``{"tokens"}``, plus ``"frames"`` (B, S_enc, frontend_dim)
for an encoder-decoder (the encoder's input) or ``"patches"`` (B,
frontend_tokens, frontend_dim) for a VLM (projected and put before the
text: positions run over both, and decoding starts after both).

``cfg.remat == "full"`` recomputes each layer group, and each encoder
layer, in the backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` of its scanned bodies.

``forward_loss`` and ``prefill`` take ``moe_a2a``, the expert-parallel
MoE FFN of ``models/moe.py``'s ``make_moe_a2a``, where the reference's
``ShardCtx`` carries it: every routed FFN of the decoder that is not
dropless goes through it (a decode step never does).
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
           "ce_loss", "encode", "decoder_pass", "assemble_input",
           "forward_loss", "init_caches", "prefill", "decode_step"]

NEG_INF = -1e30


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device: Any = None) -> ParamModule:
    """Random weights for ``cfg`` from ``generator``, made on ``device``
    (``None``: the GPU) in the config's parameter dtype.  The generator's
    device must be ``device``'s type."""
    return _build_lm(cfg, Init(generator, cfg.param_torch_dtype,
                               resolve_device(device)))


def param_count(cfg: ModelConfig) -> int:
    """Number of scalar parameters of ``cfg``'s model, counted from a
    model built on the ``meta`` device: nothing is allocated, as the
    reference's ``eval_shape``."""
    return count_params(_build_lm(cfg, Init(None, cfg.param_torch_dtype,
                                            "meta")))


def _build_lm(cfg: ModelConfig, init: Init) -> ParamModule:
    lm = ParamModule()
    Vp, d = cfg.padded_vocab(), cfg.d_model
    init.dense(lm, "embed", (Vp, d), fan_in=d)
    if cfg.frontend_dim:
        init.dense(lm, "frontend_proj", (cfg.frontend_dim, d),
                   fan_in=cfg.frontend_dim)
    if cfg.is_encdec:
        lm.add_module("encoder", _group_stack(init, cfg, ("A",),
                                              cfg.enc_layers, cross=False))
        enc_final = ParamModule()
        init_norm(init, enc_final, cfg, "ln", d)
        lm.add_module("enc_final", enc_final)
    n_groups, pattern, tail = cfg.layer_groups()
    lm.add_module("groups", _group_stack(init, cfg, pattern, n_groups,
                                         cross=cfg.is_encdec))
    for i, kind in enumerate(tail):
        t = ParamModule()
        init_layer(init, t, cfg, kind, cross=cfg.is_encdec, name="layer")
        lm.add_module(f"tail{i}", t)
    fin = ParamModule()
    init_norm(init, fin, cfg, "ln", d)
    lm.add_module("final", fin)
    if not cfg.tie_embeddings:
        init.dense(lm, "head", (Vp, d), fan_in=d)
    return lm


def _group_stack(init: Init, cfg: ModelConfig, pattern, n_groups: int, *,
                 cross: bool) -> nn.ModuleList:
    """``n_groups`` groups of layers ``p{i}`` of ``pattern``'s kinds."""
    groups = nn.ModuleList()
    for _ in range(n_groups):
        g = ParamModule()
        for i, kind in enumerate(pattern):
            init_layer(init, g, cfg, kind, cross=cross, name=f"p{i}")
        groups.append(g)
    return groups


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


def _add_aux(total, aux):
    return aux if total is None else total if aux is None else total + aux


def _group_forward(gp, h, pattern, cfg: ModelConfig, want_cache: bool,
                   use_kernel: bool, enc_out=None, moe_a2a=None):
    """One layer group -> (h, the group's aux | None, its caches)."""
    caches, aux_g = {}, None
    for i, kind in enumerate(pattern):
        h, aux, caches[f"p{i}"] = layer_forward(gp[f"p{i}"], h, kind, cfg,
                                                enc_out=enc_out,
                                                want_cache=want_cache,
                                                use_kernel=use_kernel,
                                                moe_a2a=moe_a2a)
        aux_g = _add_aux(aux_g, aux)
    return h, aux_g, caches


def encode(params, frames, cfg: ModelConfig, *, use_kernel: bool = True):
    """The encoder of an encoder-decoder arch: ``frames`` (B, S_enc,
    frontend_dim) from the modality stub, projected by ``frontend_proj``,
    through ``cfg.enc_layers`` non-causal "A" layers and the final
    LayerNorm -> enc_out (B, S_enc, d_model).  Under grad mode with
    ``cfg.remat == "full"`` each layer is recomputed in the backward."""
    cdt = cfg.compute_torch_dtype
    h = frames.to(cdt) @ params["frontend_proj"].to(cdt)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for gp in params["encoder"]:
        fn = (lambda x, gp=gp: layer_forward(gp["p0"], x, "A", cfg,
                                             causal=False,
                                             use_kernel=use_kernel)[0])
        h = checkpoint(fn, h, use_reentrant=False) if remat else fn(h)
    return norm_apply(params["enc_final"], h, cfg, "ln")


def decoder_pass(params, h, cfg: ModelConfig, *, enc_out=None,
                 want_cache: bool = False, use_kernel: bool = True,
                 moe_a2a=None):
    """-> (h after the final norm, aux, caches | None), caches as
    ``{"groups": [...], "tail": [...]}`` of raw layer emissions and aux
    the routed FFNs' load-balance losses summed over groups and tail
    (None where no layer routes); an encoder-decoder's layers read
    ``enc_out`` in their cross-attention, and routed FFNs go through
    ``moe_a2a`` where given.  Under grad mode with
    ``cfg.remat == "full"`` each layer group is recomputed in the
    backward instead of keeping its activations (the same routing)."""
    n_groups, pattern, tail = cfg.layer_groups()
    remat = (cfg.remat == "full" and not want_cache
             and torch.is_grad_enabled())
    groups, aux_total = [], None
    for g in range(n_groups):
        gp = params["groups"][g]
        if remat:
            h, aux = checkpoint(
                lambda x, gp=gp: _group_forward(gp, x, pattern, cfg, False,
                                                use_kernel,
                                                enc_out=enc_out,
                                                moe_a2a=moe_a2a)[:2],
                h, use_reentrant=False)
            groups.append(None)
        else:
            h, aux, c = _group_forward(gp, h, pattern, cfg, want_cache,
                                       use_kernel, enc_out=enc_out,
                                       moe_a2a=moe_a2a)
            groups.append(c)
        aux_total = _add_aux(aux_total, aux)
    tails = []
    for i, kind in enumerate(tail):
        h, aux, c = layer_forward(params[f"tail{i}"]["layer"], h, kind, cfg,
                                  enc_out=enc_out, want_cache=want_cache,
                                  use_kernel=use_kernel, moe_a2a=moe_a2a)
        aux_total = _add_aux(aux_total, aux)
        tails.append(c)
    h = norm_apply(params["final"], h, cfg, "ln")
    return h, aux_total, ({"groups": groups, "tail": tails} if want_cache
                          else None)


def assemble_input(params, batch, cfg: ModelConfig, *,
                   use_kernel: bool = True):
    """The decoder's input -> (h, positions, enc_out): the embeddings of
    ``batch["tokens"]`` (B, S); for an encoder-decoder ``enc_out`` is
    ``encode(batch["frames"])``, for a VLM ``batch["patches"] @
    frontend_proj`` goes before the tokens (where the batch has patches),
    else ``enc_out`` is None.  Positions run over all of ``h``."""
    h = embed_tokens(params, batch["tokens"], cfg)
    enc_out = None
    if cfg.is_encdec:
        enc_out = encode(params, batch["frames"], cfg,
                         use_kernel=use_kernel)
    elif cfg.frontend_dim and "patches" in batch:
        pe = batch["patches"].to(h.dtype) @ params["frontend_proj"].to(
            h.dtype)
        h = torch.cat([pe, h], dim=1)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    return h, positions, enc_out


def forward_loss(params, batch, cfg: ModelConfig, *,
                 aux_weight: float = 0.01, use_kernel: bool = True,
                 moe_a2a=None):
    """Training objective: CE + ``aux_weight`` * aux, aux the routed FFNs'
    load-balance loss summed over the layers (0 where no layer routes;
    through ``moe_a2a`` where given).  A VLM's logits at its patch
    positions are dropped where the labels cover the text alone.
    Returns ``(total, {"loss", "aux"})``.  On the GPU attention runs on
    K6 and the SSD on K7 unless ``use_kernel=False``; their gradients are
    the plain versions'."""
    h, _, enc_out = assemble_input(params, batch, cfg,
                                   use_kernel=use_kernel)
    h, aux, _ = decoder_pass(params, h, cfg, enc_out=enc_out,
                             use_kernel=use_kernel, moe_a2a=moe_a2a)
    logits = lm_logits(params, h, cfg)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:   # a VLM: the patch positions
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    loss = ce_loss(logits, labels)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux}


def init_caches(params, cfg: ModelConfig, batch: int, max_seq: int,
                device: Any = None, *, enc_len: int = 0):
    """Empty decode caches (attention caches sized to ``max_seq``, local
    ones to their window; an encoder-decoder's cross caches to
    ``enc_len`` slots)."""
    n_groups, pattern, tail = cfg.layer_groups()
    dt = cfg.compute_torch_dtype

    def one(kind):
        c = make_layer_cache(kind, cfg, batch, max_seq, dt, device)
        if cfg.is_encdec and kind in ("A", "L"):
            return {"self": c, "cross": make_layer_cache(
                "A", cfg, batch, max(enc_len, 1), dt, device)}
        return c

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


def _cross_cache(p, enc_out, cfg: ModelConfig):
    """A decoder layer's frozen cross-attention cache: ``enc_out``'s keys
    and values under the layer's ``cross.wk``/``cross.wv``, in storage of
    ``enc_out.shape[1]`` slots."""
    dt = cfg.compute_torch_dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wv"].to(dt))
    return _prefill_to_decode_cache((k, v), "A", cfg, enc_out.shape[0],
                                    enc_out.shape[1], dt, enc_out.device)


def prefill(params, batch, cfg: ModelConfig, *,
            max_seq: Optional[int] = None, use_kernel: bool = True,
            moe_a2a=None):
    """Process the prompts ``batch["tokens"]`` (B, S) (with their
    ``frames`` or ``patches``, see the module docstring); -> (last-token
    logits (B, Vp), caches).  ``max_seq`` counts a VLM's patch positions.
    On the GPU attention runs on K6 (the encoder's and the
    cross-attention's too) and the SSD on K7 unless
    ``use_kernel=False``.  The routed FFNs bucket the B*S tokens
    together, through ``moe_a2a`` where given."""
    h, _, enc_out = assemble_input(params, batch, cfg,
                                   use_kernel=use_kernel)
    B, S = h.shape[0], h.shape[1]
    max_seq = max_seq or S
    h, _, raw = decoder_pass(params, h, cfg, enc_out=enc_out,
                             want_cache=True, use_kernel=use_kernel,
                             moe_a2a=moe_a2a)
    dt, dev = cfg.compute_torch_dtype, h.device

    def entry(p, raw_entry, kind):
        c = _prefill_to_decode_cache(raw_entry, kind, cfg, B, max_seq, dt,
                                     dev)
        if cfg.is_encdec and kind in ("A", "L"):
            return {"self": c, "cross": _cross_cache(p, enc_out, cfg)}
        return c

    n_groups, pattern, tail = cfg.layer_groups()
    caches = {"groups": [{} for _ in range(n_groups)], "tail": [],
              "pos": torch.tensor(S, dtype=torch.int32, device=dev)}
    for p, kind, where in _layers(params, cfg):
        if where[0] == "groups":
            caches["groups"][where[1]][where[2]] = entry(
                p, raw["groups"][where[1]][where[2]], kind)
        else:
            caches["tail"].append(entry(p, raw["tail"][where[1]], kind))
    return lm_logits(params, h[:, -1], cfg), caches


def decode_step(params, caches, tokens_t, cfg: ModelConfig, *,
                enc_len: Optional[int] = None):
    """One token for the whole batch at the caches' position.  tokens_t
    (B,) -> (logits (B, Vp), new caches).  An encoder-decoder's layers
    read ``enc_len`` slots of their frozen cross caches (``None``: every
    slot) and write none."""
    pos = caches["pos"]
    h_t = embed_tokens(params, tokens_t, cfg)
    groups = [dict(g) for g in caches["groups"]]
    tails = list(caches["tail"])

    def step(p, kind, h, c):
        if isinstance(c, dict):    # an encoder-decoder's {"self", "cross"}
            h, cs = layer_decode(p, h, kind, cfg, cache=c["self"], pos=pos,
                                 enc_cache=c["cross"], enc_len=enc_len)
            return h, {"self": cs, "cross": c["cross"]}
        return layer_decode(p, h, kind, cfg, cache=c, pos=pos)

    for p, kind, where in _layers(params, cfg):
        if where[0] == "groups":
            h_t, groups[where[1]][where[2]] = step(
                p, kind, h_t, groups[where[1]][where[2]])
        else:
            h_t, tails[where[1]] = step(p, kind, h_t, tails[where[1]])
    h_t = norm_apply(params["final"], h_t, cfg, "ln")
    return lm_logits(params, h_t, cfg), {"groups": groups, "tail": tails,
                                         "pos": pos + 1}
