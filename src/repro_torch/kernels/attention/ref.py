"""Plain PyTorch versions of flash attention (GQA / causal / window /
decode), the same math as the K6 kernel in float32."""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "mha_ref", "decode_ref"]

NEG_INF = -1e30


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            q_offset: int = 0, scale: Optional[float] = None,
            kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  GQA via head repetition.

    ``kv_len`` (per batch, int) masks cache positions >= len (decode)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    group = Hq // Hkv
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask[None, None], s, NEG_INF)
    if kv_len is not None:
        valid = k_pos[None, :] < kv_len[:, None]          # (B, Skv)
        s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               kv_len: torch.Tensor, *, window: Optional[int] = None,
               scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: q (B, Hq, 1, D) against a cache of capacity S;
    positions >= kv_len are masked; the window is measured from
    kv_len - 1."""
    if window is None:
        return mha_ref(q, k_cache, v_cache, causal=False, scale=scale,
                       kv_len=kv_len)
    B, Hq, _, D = q.shape
    Skv = k_cache.shape[2]
    k_pos = torch.arange(Skv, device=q.device)
    cur = kv_len - 1
    valid = (k_pos[None] <= cur[:, None]) & (k_pos[None] > cur[:, None]
                                             - window)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    group = Hq // k_cache.shape[1]
    k = torch.repeat_interleave(k_cache, group, dim=1)
    v = torch.repeat_interleave(v_cache, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
