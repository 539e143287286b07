"""Layer blocks: attention, the dense FFN, and the uniform layer wrapper
that puts mixer and FFN between pre-norms, for layer kinds "A" (global
attention) and "M" (Mamba2), as ``repro.models.blocks`` does.

Every block has three entry points:
  init_*       parameters, as children of an ``nn.Module`` tree
  *_forward    full sequence (prefill), optionally emitting the cache
  *_decode     one token against the cache

The JAX package's ``ShardCtx`` has no counterpart: the port runs one
device.  Kinds "L" (sliding-window attention and its ring cache) and "R"
(RG-LRU), MoE FFNs and cross-attention raise ``NotImplementedError``
naming their ROADMAP queue.  Prefill positions are always ``0 .. S-1``:
the port prefills a sequence from its first token.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from . import kvcache as kvc
from .attention import attention, decode_attention
from .common import (Init, ParamModule, apply_rope, layer_norm, rms_norm,
                     rope_cos_sin)
from .config import ModelConfig
from .ssm import init_mamba2, mamba2_decode, mamba2_forward

__all__ = ["norm_apply", "init_norm", "init_attention", "attention_forward",
           "make_attn_cache", "fill_attn_cache", "attention_decode",
           "init_ffn", "ffn_forward", "init_layer", "layer_forward",
           "layer_decode", "make_layer_cache"]

_QUEUE = "ROADMAP queue 5"
_LATER = {"L": f"local (sliding-window) attention layers are {_QUEUE} "
               f"(gemma3 local layers and ring cache)",
          "R": f"RG-LRU layers are {_QUEUE} (RG-LRU)"}


def _refuse_kind(kind: str) -> None:
    if kind in _LATER:
        raise NotImplementedError(f"layer kind {kind!r}: {_LATER[kind]}")
    if kind not in ("A", "M"):
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
                   name: str = "attn") -> None:
    """Self-attention projections as child ``name`` of ``parent``
    (cross-attention is ROADMAP queue 5, encoder-decoder serving)."""
    d, hd = cfg.d_model, cfg.head_dim
    Hp, Kv = cfg.padded_heads(), cfg.padded_kv_heads()
    p = ParamModule()
    init.dense(p, "wq", (d, Hp, hd), fan_in=d)
    init.dense(p, "wk", (d, Kv, hd), fan_in=d)
    init.dense(p, "wv", (d, Kv, hd), fan_in=d)
    init.dense(p, "wo", (Hp, hd, d), fan_in=Hp * hd)
    if cfg.qkv_bias:
        init.const(p, "bq", (Hp, hd), 0.0)
        init.const(p, "bk", (Kv, hd), 0.0)
        init.const(p, "bv", (Kv, hd), 0.0)
    if cfg.qk_norm:
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
                      want_cache: bool = False, use_kernel: bool = True):
    """Full-sequence attention sub-block (the layer wrapper owns residual
    and norm).  On the GPU the attention itself is the K6 kernel unless
    ``use_kernel=False``."""
    B, S, d = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    q, k, v = _project_qkv(p, h, cfg, rope=_rope_tables(cfg, positions))
    out = attention(q, k, v, qpos=positions, kpos=positions, causal=causal,
                    impl=cfg.attn_impl, q_chunk=cfg.q_chunk,
                    k_chunk=cfg.k_chunk, use_kernel=use_kernel)
    o = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
    if want_cache:
        return o, (k, v)
    return o


def make_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    device=None):
    """An empty cache for one global-attention layer (the ring cache of
    sliding-window layers is ROADMAP queue 5)."""
    return kvc.kv_make(batch, max_seq, cfg.padded_kv_heads(), cfg.head_dim,
                       dtype, cfg.kv_layout, cfg.kv_order, device)


def fill_attn_cache(storage, k, v, cfg: ModelConfig, *, out=None):
    """Write prefill k/v (B, S, Kv, hd) into a fresh cache (into ``out``
    when given: ``storage`` itself to fill it in place)."""
    return kvc.kv_write_prefill(storage, k, v, cfg.kv_layout, cfg.kv_order,
                                out=out)


def attention_decode(p, h_t, cache, pos, cfg: ModelConfig, *,
                     cache_out=None):
    """One-token global attention.  h_t (B, d); cache = KV storage; pos =
    the incoming token's position: a scalar (uniform batch) or a (B,)
    vector of per-slot positions (continuous batching).  Returns (out,
    cache); the token's k/v are written into ``cache_out`` when given
    (``cache`` itself: in place), else into a new cache."""
    B, d = h_t.shape
    cdt = h_t.dtype
    pos = torch.as_tensor(pos, dtype=torch.int32, device=h_t.device)
    ragged = pos.dim() == 1
    q = torch.einsum("bd,dhk->bhk", h_t, p["wq"].to(cdt))
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
    cache = kvc.kv_write_token(cache, k_t, v_t, pos, cfg.kv_layout,
                               cfg.kv_order, out=cache_out)
    cache_len = (pos + 1).expand(B) if not ragged else pos + 1
    k, v = kvc.kv_read(cache, cfg.head_dim, cfg.kv_layout, cfg.kv_order)
    fmt = "bshd" if cfg.kv_order == "bsh" else "bhsd"
    out = decode_attention(q, k, v, cache_len, kv_format=fmt)
    o = torch.einsum("bhk,hkd->bd", out, p["wo"].to(out.dtype))
    return o, cache


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def init_ffn(init: Init, parent: ParamModule, cfg: ModelConfig,
             name: str = "ffn") -> None:
    """The dense FFN as child ``name`` of ``parent``."""
    if cfg.n_experts:
        raise NotImplementedError(f"MoE FFNs are {_QUEUE} (MoE)")
    d, f = cfg.d_model, cfg.d_ff
    p = ParamModule()
    if cfg.mlp_kind in ("swiglu", "geglu"):
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


def ffn_forward(p, x, cfg: ModelConfig):
    """x (..., d) -> (..., d): SwiGLU / GeGLU / MLP."""
    cdt = x.dtype
    if cfg.mlp_kind in ("swiglu", "geglu"):
        h = torch.einsum("...d,dtf->...tf", x, p["wi"].to(cdt))
        gate, up = h[..., 0, :], h[..., 1, :]
        g = _gelu(gate) if cfg.mlp_kind == "geglu" else F.silu(gate)
        return (g * up) @ p["wo"].to(cdt)
    h = x @ p["wi"].to(cdt) + p["bi"].to(cdt)
    h = _gelu(h) if cfg.act == "gelu" else F.silu(h)
    return h @ p["wo"].to(cdt) + p["bo"].to(cdt)


# ---------------------------------------------------------------------------
# uniform layer wrapper
# ---------------------------------------------------------------------------

def init_layer(init: Init, parent: ParamModule, cfg: ModelConfig, kind: str,
               *, name: str = "layer") -> None:
    """One decoder layer of ``kind`` as child ``name`` of ``parent``."""
    _refuse_kind(kind)
    if cfg.sandwich_norm:
        raise NotImplementedError(f"sandwich norms (gemma3) are {_QUEUE} "
                                  f"(gemma3 local layers and ring cache)")
    p = ParamModule()
    init_norm(init, p, cfg, "ln_mix", cfg.d_model)
    if kind == "A":
        init_attention(init, p, cfg, name="attn")
    else:
        init_mamba2(init, p, d_model=cfg.d_model, d_state=cfg.ssm_state,
                    n_heads=cfg.padded_ssm_heads(),
                    head_dim=cfg.ssm_head_dim, d_conv=cfg.d_conv,
                    name="mamba")
    if cfg.d_ff:
        init_norm(init, p, cfg, "ln_ffn", cfg.d_model)
        init_ffn(init, p, cfg, name="ffn")
    parent.add_module(name, p)


def layer_forward(p, h, kind: str, cfg: ModelConfig, *,
                  want_cache: bool = False, use_kernel: bool = True):
    """Full-sequence layer; returns (h, cache_entry | None)."""
    _refuse_kind(kind)
    x = norm_apply(p, h, cfg, "ln_mix")
    cache = None
    if kind == "A":
        out = attention_forward(p["attn"], x, cfg, causal=True,
                                want_cache=want_cache, use_kernel=use_kernel)
        if want_cache:
            out, cache = out
    else:
        out, state = mamba2_forward(p["mamba"], x, chunk=cfg.ssd_chunk,
                                    use_kernel=use_kernel)
        cache = state if want_cache else None
    h = h + out
    if cfg.d_ff:
        h = h + ffn_forward(p["ffn"], norm_apply(p, h, cfg, "ln_ffn"), cfg)
    return h, cache


def layer_decode(p, h_t, kind: str, cfg: ModelConfig, *, cache, pos,
                 cache_out=None):
    """One-token layer step; returns (h_t, new_cache).  ``cache_out`` is
    where the new cache goes (the KV storage, or a Mamba layer's pair
    with None where a new tensor is made), else a new one."""
    _refuse_kind(kind)
    x = norm_apply(p, h_t, cfg, "ln_mix")
    if kind == "A":
        out, cache = attention_decode(p["attn"], x, cache, pos, cfg,
                                      cache_out=cache_out)
    else:
        out, cache = mamba2_decode(p["mamba"], x, cache, out=cache_out)
    h_t = h_t + out
    if cfg.d_ff:
        h_t = h_t + ffn_forward(p["ffn"], norm_apply(p, h_t, cfg, "ln_ffn"),
                                cfg)
    return h_t, cache


def make_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device=None):
    """A fresh (empty) cache entry for one layer."""
    _refuse_kind(kind)
    if kind == "A":
        return make_attn_cache(cfg, batch, max_seq, dtype, device)
    H = cfg.padded_ssm_heads()
    P_, N, K = cfg.ssm_head_dim, cfg.ssm_state, cfg.d_conv
    dev = resolve_device(device)
    return (torch.zeros((batch, H, P_, N), dtype=torch.float32, device=dev),
            torch.zeros((batch, K - 1, H * P_ + 2 * N), dtype=dtype,
                        device=dev))
