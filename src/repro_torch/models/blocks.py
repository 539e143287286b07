"""Layer blocks: attention (self and cross), the dense and routed FFNs,
and the uniform layer wrapper that puts mixer, cross-attention and FFN
between pre-norms (and post-norms, under ``sandwich_norm``), for layer
kinds "A" (global attention), "L" (local, sliding-window attention over
a ring cache), "M" (Mamba2) and "R" (RG-LRU), as ``repro.models.blocks``
does.

Every block has three entry points:
  init_*       parameters, as children of an ``nn.Module`` tree
  *_forward    full sequence (prefill), optionally emitting the cache
  *_decode     one token against the cache

The JAX package's ``ShardCtx`` has no counterpart: the port runs one
device.  An MoE FFN (``cfg.n_experts``) routes through
``models/moe.py``, with arctic's dense residual FFN beside it where
``cfg.dense_residual``: a full-sequence layer buckets to capacity and
returns the load-balance loss, a decode step routes dropless.  Prefill
positions are always ``0 .. S-1``: the port prefills a sequence from its
first token (a VLM's from its first patch position).

A decoder layer of an encoder-decoder arch carries a cross-attention
(``cross``, after the mixer's residual): its queries come from the
decoder, its keys and values from the encoder's output, with no RoPE,
no bias, no QK norm and no mask.  Its decode cache is the encoder's
keys and values, written once at prefill and only read by a decode
step (``cross_len`` of its slots valid).

A local layer's cache is a ring of ``W = min(window, max_seq)`` slots:
the token at position ``t`` lives in slot ``t % W`` (every mod here is a
floor mod), and a decode step masks each slot by the position it holds
(``_ring_kpos``).  Positions stay device tensors throughout, so a
captured decode graph replays at every position.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.layout import Layout
from . import kvcache as kvc
from .attention import attention, decode_attention
from .common import (Init, ParamModule, apply_rope, layer_norm, rms_norm,
                     rope_cos_sin)
from .config import ModelConfig
from .moe import init_moe, moe_block
from .ssm import (init_mamba2, init_rglru, mamba2_decode, mamba2_forward,
                  rglru_decode, rglru_forward)

__all__ = ["norm_apply", "init_norm", "init_attention", "attention_forward",
           "make_attn_cache", "fill_attn_cache", "attention_decode",
           "init_ffn", "ffn_forward", "init_layer", "layer_forward",
           "layer_decode", "make_layer_cache"]

#: the position of a ring slot no token was written to (masked by the
#: cache length)
BIG_POS = 1 << 30


def _check_kind(kind: str) -> None:
    if kind not in ("A", "L", "M", "R"):
        raise ValueError(f"unknown layer kind {kind!r}")


def norm_apply(p, x, cfg: ModelConfig, prefix: str):
    """The norm ``prefix`` of ``p``: LayerNorm when it has a bias, else
    RMSNorm."""
    if f"{prefix}_b" in p:
        return layer_norm(x, p[prefix], p[f"{prefix}_b"], eps=cfg.norm_eps)
    return rms_norm(x, p[prefix], eps=cfg.norm_eps,
                    plus_one=cfg.norm_plus_one)


def init_norm(init: Init, p: ParamModule, cfg: ModelConfig, name: str,
              dim: int) -> None:
    """A norm's scale (and bias, for LayerNorm) on ``p``."""
    init.const(p, name, (dim,), 0.0 if cfg.norm_plus_one else 1.0)
    if cfg.norm_kind == "layernorm":
        init.const(p, f"{name}_b", (dim,), 0.0)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def init_attention(init: Init, parent: ParamModule, cfg: ModelConfig, *,
                   cross: bool = False, name: str = "attn") -> None:
    """Attention projections as child ``name`` of ``parent``; a
    cross-attention (``cross``) has no q/k/v bias and no QK norm."""
    d, hd = cfg.d_model, cfg.head_dim
    Hp, Kv = cfg.padded_heads(), cfg.padded_kv_heads()
    p = ParamModule()
    init.dense(p, "wq", (d, Hp, hd), fan_in=d)
    init.dense(p, "wk", (d, Kv, hd), fan_in=d)
    init.dense(p, "wv", (d, Kv, hd), fan_in=d)
    init.dense(p, "wo", (Hp, hd, d), fan_in=Hp * hd)
    if cfg.qkv_bias and not cross:
        init.const(p, "bq", (Hp, hd), 0.0)
        init.const(p, "bk", (Kv, hd), 0.0)
        init.const(p, "bv", (Kv, hd), 0.0)
    if cfg.qk_norm and not cross:
        init.const(p, "q_norm", (hd,), 1.0)
        init.const(p, "k_norm", (hd,), 1.0)
    parent.add_module(name, p)


def _project_qkv(p, x, cfg: ModelConfig, *, rope: Optional[tuple] = None):
    """x (B, S, d) -> q (B,S,Hp,hd), k/v (B,S,Kv,hd)."""
    cdt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin, mode=cfg.rope_mode)
        k = apply_rope(k, cos, sin, mode=cfg.rope_mode)
    return q, k, v


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    rot = int(cfg.head_dim * cfg.rope_fraction)
    return rope_cos_sin(positions, rot, base=cfg.rope_base)


def attention_forward(p, h, cfg: ModelConfig, *, causal: bool = True,
                      window: Optional[int] = None, enc_out=None,
                      want_cache: bool = False, use_kernel: bool = True):
    """Full-sequence attention sub-block (the layer wrapper owns residual
    and norm); ``window`` makes it local, and ``enc_out`` (B, S_enc, d)
    makes it a cross-attention: q from ``h``, k and v from ``enc_out``,
    no RoPE and no mask.  On the GPU the attention itself is the K6
    kernel unless ``use_kernel=False``."""
    B, S, d = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    if enc_out is None:
        q, k, v = _project_qkv(p, h, cfg,
                               rope=_rope_tables(cfg, positions))
        kpos = positions
    else:
        cdt = h.dtype
        q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(cdt))
        k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(cdt))
        v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(cdt))
        kpos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                            device=h.device)
        causal, window = False, None
    out = attention(q, k, v, qpos=positions, kpos=kpos, causal=causal,
                    window=window, impl=cfg.attn_impl, q_chunk=cfg.q_chunk,
                    k_chunk=cfg.k_chunk, use_kernel=use_kernel)
    o = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
    if want_cache:
        return o, (k, v)
    return o


def make_attn_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    window: Optional[int], dtype, device=None):
    """An empty cache for one attention layer: ``max_seq`` positions, or
    a ring of ``min(window, max_seq)`` slots for a local layer."""
    S = min(window, max_seq) if window else max_seq
    return kvc.kv_make(batch, S, cfg.padded_kv_heads(), cfg.head_dim,
                       dtype, cfg.kv_layout, cfg.kv_order, device)


def fill_attn_cache(storage, k, v, cfg: ModelConfig, window: Optional[int],
                    *, out=None):
    """Write prefill k/v (B, S, Kv, hd) into a fresh cache (into ``out``
    when given: ``storage`` itself to fill it in place).  A local layer's
    ring of W slots gets the last W positions, position t in slot t % W,
    or a prompt shorter than W and zeros after it."""
    S = k.shape[1]
    if window:
        W = _cache_seq_len(storage, cfg)
        if S >= W:
            i = torch.arange(W, device=k.device)
            slot_pos = S - W + torch.remainder(i - S, W)
            k, v = k[:, slot_pos], v[:, slot_pos]
        else:
            pad = [0, 0, 0, 0, 0, W - S]
            k, v = F.pad(k, pad), F.pad(v, pad)
    return kvc.kv_write_prefill(storage, k, v, cfg.kv_layout, cfg.kv_order,
                                out=out)


def _cache_seq_len(storage, cfg: ModelConfig) -> int:
    """The sequence length (slots) of KV storage in the config's layout
    and order."""
    if cfg.kv_layout is Layout.AOSOA:
        if cfg.kv_order == "bsh":      # (B, S, Hkv//t, C, t)
            return storage.shape[1]
        return storage.shape[2] * storage.shape[4]  # (B, Hkv, S//t, C, t)
    i = 1 if cfg.kv_order == "bsh" else 2
    if cfg.kv_layout is not Layout.AOS:
        i += 1
    return storage.shape[i]


def _ring_kpos(pos: torch.Tensor, W: int) -> torch.Tensor:
    """The position each of the W ring slots holds once ``pos`` is
    written; a slot never written holds ``BIG_POS`` (masked by the cache
    length).  ``pos`` scalar -> (W,); a per-slot (B,) vector -> (B, W)."""
    i = torch.arange(W, dtype=torch.int32, device=pos.device)
    p = pos[..., None] - torch.remainder(pos[..., None] - i, W)
    return torch.where(p >= 0, p, BIG_POS)


def attention_decode(p, h_t, cache, pos, cfg: ModelConfig, *,
                     window: Optional[int] = None,
                     cross_len: Optional[int] = None, cache_out=None):
    """One-token attention.  h_t (B, d); cache = KV storage (a ring of W
    slots when ``window`` is given: the token goes to slot ``pos % W``);
    pos = the incoming token's position: a scalar (uniform batch) or a
    (B,) vector of per-slot positions (continuous batching).  Returns
    (out, cache); the token's k/v are written into ``cache_out`` when
    given (``cache`` itself: in place), else into a new cache.  With
    ``cross_len`` the cache is a cross-attention's frozen encoder cache
    of that many valid slots: read with no write, no RoPE and no
    bias."""
    B, d = h_t.shape
    q = torch.einsum("bd,dhk->bhk", h_t, p["wq"].to(h_t.dtype))
    if cross_len is None:
        q, cache, cache_len, kpos = _write_token(p, h_t, q, cache, pos, cfg,
                                                 window, cache_out)
    else:
        cache_len = torch.as_tensor(cross_len, dtype=torch.int32,
                                    device=h_t.device).expand(B)
        kpos = None
    k, v = kvc.kv_read(cache, cfg.head_dim, cfg.kv_layout, cfg.kv_order)
    fmt = "bshd" if cfg.kv_order == "bsh" else "bhsd"
    out = decode_attention(q, k, v, cache_len, kpos=kpos, window=window,
                           kv_format=fmt)
    o = torch.einsum("bhk,hkd->bd", out, p["wo"].to(out.dtype))
    return o, cache


def _write_token(p, h_t, q, cache, pos, cfg: ModelConfig, window,
                 cache_out):
    """A self-attention decode step's token: its bias, QK norm and RoPE
    on ``q`` and its k/v, the k/v written at ``pos`` (a ring's slot ``pos
    % W``).  Returns (q, cache, cache_len (B,), each slot's position (B,
    W) for a ring, else None)."""
    B, cdt = h_t.shape[0], h_t.dtype
    pos = torch.as_tensor(pos, dtype=torch.int32, device=h_t.device)
    ragged = pos.dim() == 1
    k_t = torch.einsum("bd,dhk->bhk", h_t, p["wk"].to(cdt))
    v_t = torch.einsum("bd,dhk->bhk", h_t, p["wv"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k_t = k_t + p["bk"].to(cdt)
        v_t = v_t + p["bv"].to(cdt)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k_t = rms_norm(k_t, p["k_norm"], eps=cfg.norm_eps)
    if ragged:   # per-slot rope rows, broadcast over heads only
        cos, sin = _rope_tables(cfg, pos)
        cos, sin = cos[:, None], sin[:, None]
    else:
        cos, sin = _rope_tables(cfg, pos[None])
        cos, sin = cos[None], sin[None]
    q = apply_rope(q[:, None], cos, sin, mode=cfg.rope_mode)[:, 0]
    k_t = apply_rope(k_t[:, None], cos, sin, mode=cfg.rope_mode)[:, 0]
    kpos = None
    slot = pos
    if window:
        W = _cache_seq_len(cache, cfg)
        slot = torch.remainder(pos, W)
        kpos = _ring_kpos(pos, W)
        if not ragged:
            kpos = kpos[None].expand(B, W)
    cache = kvc.kv_write_token(cache, k_t, v_t, slot, cfg.kv_layout,
                               cfg.kv_order, out=cache_out)
    cache_len = (pos + 1).expand(B) if not ragged else pos + 1
    return q, cache, cache_len, kpos


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def init_ffn(init: Init, parent: ParamModule, cfg: ModelConfig,
             name: str = "ffn") -> None:
    """The FFN as child ``name`` of ``parent``: the routed experts
    (``moe``, and ``wi_dense``/``wo_dense`` for a dense residual) where
    the config has experts, else the dense FFN."""
    d, f = cfg.d_model, cfg.d_ff
    p = ParamModule()
    if cfg.n_experts:
        init_moe(init, p, d_model=d, d_ff=f, n_experts=cfg.n_experts,
                 name="moe")
        if cfg.dense_residual:
            init.dense(p, "wi_dense", (d, 2, f), fan_in=d)
            init.dense(p, "wo_dense", (f, d), fan_in=f)
    elif cfg.mlp_kind in ("swiglu", "geglu"):
        init.dense(p, "wi", (d, 2, f), fan_in=d)
        init.dense(p, "wo", (f, d), fan_in=f)
    else:
        init.dense(p, "wi", (d, f), fan_in=d)
        init.const(p, "bi", (f,), 0.0)
        init.dense(p, "wo", (f, d), fan_in=f)
        init.const(p, "bo", (d,), 0.0)
    parent.add_module(name, p)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _glu(x, wi, wo, cfg: ModelConfig):
    h = torch.einsum("...d,dtf->...tf", x, wi.to(x.dtype))
    gate, up = h[..., 0, :], h[..., 1, :]
    g = _gelu(gate) if cfg.mlp_kind == "geglu" else F.silu(gate)
    return (g * up) @ wo.to(x.dtype)


def ffn_forward(p, x, cfg: ModelConfig, *, dropless: bool = False):
    """x (..., d) -> (out (..., d), aux): SwiGLU / GeGLU / MLP with aux
    None, or the routed experts (bucketed to capacity, or ``dropless``)
    plus the dense residual where the config has one, with aux their
    load-balance loss (float32 scalar)."""
    cdt = x.dtype
    if cfg.n_experts:
        lead = x.shape[:-1]
        out, aux = moe_block(p["moe"], x.reshape(-1, cfg.d_model),
                             top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor,
                             dropless=dropless)
        out = out.reshape(*lead, cfg.d_model)
        if cfg.dense_residual:
            out = out + _glu(x, p["wi_dense"], p["wo_dense"], cfg)
        return out, aux
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return _glu(x, p["wi"], p["wo"], cfg), None
    h = x @ p["wi"].to(cdt) + p["bi"].to(cdt)
    h = _gelu(h) if cfg.act == "gelu" else F.silu(h)
    return h @ p["wo"].to(cdt) + p["bo"].to(cdt), None


# ---------------------------------------------------------------------------
# uniform layer wrapper
# ---------------------------------------------------------------------------

def init_layer(init: Init, parent: ParamModule, cfg: ModelConfig, kind: str,
               *, cross: bool = False, name: str = "layer") -> None:
    """One layer of ``kind`` as child ``name`` of ``parent``, with a
    cross-attention (``ln_cross``, ``cross``) when ``cross``."""
    _check_kind(kind)
    p = ParamModule()
    init_norm(init, p, cfg, "ln_mix", cfg.d_model)
    if kind in ("A", "L"):
        init_attention(init, p, cfg, name="attn")
    elif kind == "M":
        init_mamba2(init, p, d_model=cfg.d_model, d_state=cfg.ssm_state,
                    n_heads=cfg.padded_ssm_heads(),
                    head_dim=cfg.ssm_head_dim, d_conv=cfg.d_conv,
                    name="mamba")
    else:
        init_rglru(init, p, d_model=cfg.d_model, lru_width=cfg.lru_width,
                   n_blocks=cfg.rnn_blocks, d_conv=cfg.d_conv, name="rglru")
    if cfg.sandwich_norm:
        init_norm(init, p, cfg, "ln_mix_post", cfg.d_model)
    if cross:
        init_norm(init, p, cfg, "ln_cross", cfg.d_model)
        init_attention(init, p, cfg, cross=True, name="cross")
    if cfg.d_ff:
        init_norm(init, p, cfg, "ln_ffn", cfg.d_model)
        init_ffn(init, p, cfg, name="ffn")
        if cfg.sandwich_norm:
            init_norm(init, p, cfg, "ln_ffn_post", cfg.d_model)
    parent.add_module(name, p)


def _local(kind: str, cfg: ModelConfig):
    """(the window, the config) a layer of ``kind`` runs under: a local
    layer attends over ``cfg.window`` with ``rope_base_local`` where the
    config gives one."""
    if kind != "L":
        return None, cfg
    if cfg.rope_base_local is not None:
        cfg = cfg.with_(rope_base=cfg.rope_base_local)
    return cfg.window, cfg


def _ffn_residual(p, h, cfg: ModelConfig, *, dropless: bool = False):
    """-> (h + the FFN's output, its aux or None)."""
    if not cfg.d_ff:
        return h, None
    out, aux = ffn_forward(p["ffn"], norm_apply(p, h, cfg, "ln_ffn"), cfg,
                           dropless=dropless)
    if cfg.sandwich_norm:
        out = norm_apply(p, out, cfg, "ln_ffn_post")
    return h + out, aux


def layer_forward(p, h, kind: str, cfg: ModelConfig, *, causal: bool = True,
                  enc_out=None, want_cache: bool = False,
                  use_kernel: bool = True):
    """Full-sequence layer (``causal=False``: an encoder layer; with
    ``enc_out`` a decoder layer's cross-attention reads it); returns (h,
    aux | None, cache_entry | None), aux the MoE load-balance loss of a
    routed FFN (bucketed to capacity)."""
    _check_kind(kind)
    window, cfg = _local(kind, cfg)
    x = norm_apply(p, h, cfg, "ln_mix")
    cache = None
    if kind in ("A", "L"):
        out = attention_forward(p["attn"], x, cfg, causal=causal,
                                window=window, want_cache=want_cache,
                                use_kernel=use_kernel)
        if want_cache:
            out, cache = out
    elif kind == "M":
        out, cache = mamba2_forward(p["mamba"], x, chunk=cfg.ssd_chunk,
                                    use_kernel=use_kernel)
    else:
        out, cache = rglru_forward(p["rglru"], x)
    if cfg.sandwich_norm:
        out = norm_apply(p, out, cfg, "ln_mix_post")
    h = h + out
    if enc_out is not None and "cross" in p:
        h = h + attention_forward(p["cross"],
                                  norm_apply(p, h, cfg, "ln_cross"), cfg,
                                  enc_out=enc_out, use_kernel=use_kernel)
    h, aux = _ffn_residual(p, h, cfg)
    return h, aux, cache if want_cache else None


def layer_decode(p, h_t, kind: str, cfg: ModelConfig, *, cache, pos,
                 enc_cache=None, enc_len: Optional[int] = None,
                 cache_out=None):
    """One-token layer step; returns (h_t, new_cache).  ``cache_out`` is
    where the new cache goes (the KV storage, or a Mamba or RG-LRU
    layer's pair with None where a new tensor is made), else a new
    one.  ``enc_cache`` is the layer's frozen cross-attention cache, of
    which ``enc_len`` slots are read (``None``: all of them); it is not
    written.  A routed FFN routes dropless, as the reference's decode."""
    _check_kind(kind)
    window, cfg = _local(kind, cfg)
    x = norm_apply(p, h_t, cfg, "ln_mix")
    if kind in ("A", "L"):
        out, cache = attention_decode(p["attn"], x, cache, pos, cfg,
                                      window=window, cache_out=cache_out)
    elif kind == "M":
        out, cache = mamba2_decode(p["mamba"], x, cache, out=cache_out)
    else:
        out, cache = rglru_decode(p["rglru"], x, cache, out=cache_out)
    if cfg.sandwich_norm:
        out = norm_apply(p, out, cfg, "ln_mix_post")
    h_t = h_t + out
    if enc_cache is not None and "cross" in p:
        out, _ = attention_decode(p["cross"],
                                  norm_apply(p, h_t, cfg, "ln_cross"),
                                  enc_cache, pos, cfg,
                                  cross_len=_cache_seq_len(enc_cache, cfg)
                                  if enc_len is None else enc_len)
        h_t = h_t + out
    return _ffn_residual(p, h_t, cfg, dropless=True)[0], cache


def make_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device=None):
    """A fresh (empty) cache entry for one layer: KV storage (a ring of
    ``min(window, max_seq)`` slots for "L"), or (float32 state, conv
    window) for "M" and "R"."""
    _check_kind(kind)
    if kind in ("A", "L"):
        window = cfg.window if kind == "L" else None
        return make_attn_cache(cfg, batch, max_seq, window, dtype, device)
    dev = resolve_device(device)
    K = cfg.d_conv
    if kind == "R":
        R = cfg.lru_width
        return (torch.zeros((batch, R), dtype=torch.float32, device=dev),
                torch.zeros((batch, K - 1, R), dtype=dtype, device=dev))
    H = cfg.padded_ssm_heads()
    P_, N = cfg.ssm_head_dim, cfg.ssm_state
    return (torch.zeros((batch, H, P_, N), dtype=torch.float32, device=dev),
            torch.zeros((batch, K - 1, H * P_ + 2 * N), dtype=dtype,
                        device=dev))
