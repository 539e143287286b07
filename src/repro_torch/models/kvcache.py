"""KV cache with polymorphic layout — the paper's C1 applied to serving.

The cache is a record with fields (k, v) of size head_dim over the space
(batch, seq, kv_heads) ("bsh") or (batch, kv_heads, seq) ("bhs"), stored
in the port's ``RecordArray`` layouts:

* AoS   -> ``(*space, 2*hd)``: k and v side by side per cell;
* SoA   -> ``(2*hd, *space)``: each component plane contiguous;
* AoSoA -> the last space dim tiled by ``aosoa_tile``: "bsh" tiles the KV
  heads, "bhs" the sequence, so a token write there addresses
  ``(pos // tile, pos % tile)`` across two storage axes.

Storage shapes equal the JAX package's (``repro.models.kvcache``), so a
cache converts between the two bit for bit.  Writes return a new tensor
and leave their input alone, as the JAX functions do, unless given
``out=``: then they write into it (the cache itself, as the decode graph
does under ``regions=True``, where the executor hands the layer's node its
cache's static buffer) and clone nothing, as the reference's
``dynamic_update_slice`` does under donation.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.device import resolve_device
from ..core.layout import Layout, RecordArray, RecordSpec, Vector, \
    relayout_data

__all__ = ["kv_spec", "kv_make", "kv_read", "kv_write_prefill",
           "kv_write_token"]


def kv_spec(head_dim: int) -> RecordSpec:
    """The cache record: fields k and v of ``head_dim`` components."""
    return RecordSpec.create(Vector("k", head_dim), Vector("v", head_dim))


def _space(batch: int, seq: int, kv_heads: int, order: str):
    return (batch, seq, kv_heads) if order == "bsh" else (batch, kv_heads, seq)


def kv_make(batch: int, seq: int, kv_heads: int, head_dim: int,
            dtype=torch.bfloat16, layout: Layout = Layout.AOS,
            order: str = "bsh", device: Any = None) -> torch.Tensor:
    """Zeroed cache storage on ``device`` (``None``: the GPU)."""
    shape = RecordArray.storage_shape(kv_spec(head_dim),
                                      _space(batch, seq, kv_heads, order),
                                      layout)
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


def kv_read(storage: torch.Tensor, head_dim: int,
            layout: Layout = Layout.AOS,
            order: str = "bsh") -> tuple[torch.Tensor, torch.Tensor]:
    """(k, v), each (B, S, Hkv, hd) for "bsh" / (B, Hkv, S, hd) for "bhs"
    (views for AoS and SoA, copies for AoSoA)."""
    rec = RecordArray(storage, kv_spec(head_dim), layout)
    return rec.field("k"), rec.field("v")


def _target(storage: torch.Tensor, out) -> torch.Tensor:
    """Where a write lands: a clone of ``storage``, or ``out`` holding
    ``storage``'s values (nothing to copy when it is ``storage``)."""
    if out is None:
        return storage.clone()
    if out.shape != storage.shape or out.dtype != storage.dtype \
            or out.device != storage.device:
        raise ValueError(f"kv cache write: out is {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}, the cache "
                         f"{tuple(storage.shape)} {storage.dtype} on "
                         f"{storage.device}")
    if out.data_ptr() != storage.data_ptr():
        out.copy_(storage)
    return out


def kv_write_prefill(storage: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, layout: Layout = Layout.AOS,
                     order: str = "bsh", *, out=None) -> torch.Tensor:
    """The cache with its first S_in positions written from prefill k/v
    (B, S_in, Hkv, hd), into ``out`` when given (``storage`` itself to
    write in place).  Without ``out``, AoSoA stages through the AoS view,
    since the written region need not be tile-aligned; with it, the
    tiled dim's whole tiles and then its partial tile are written."""
    hd = k.shape[-1]
    kv = torch.cat([k, v], dim=-1).to(storage.dtype)
    if order == "bhs":
        kv = kv.transpose(1, 2)                      # (B, Hkv, S_in, 2hd)
    spec = kv_spec(hd)
    if layout is Layout.AOSOA:
        if out is None:
            aos = relayout_data(storage, spec, Layout.AOSOA,
                                Layout.AOS).clone()
            aos[tuple(slice(0, n) for n in kv.shape)] = kv
            return relayout_data(aos, spec, Layout.AOS, Layout.AOSOA)
        dst = _target(storage, out)
        # the tiled (last) space dim's prefix: its whole tiles, then the
        # part of the next one
        lead = tuple(slice(0, n) for n in kv.shape[:-2])
        full, rem = divmod(kv.shape[-2], dst.shape[-1])
        if full:
            dst[lead + (slice(0, full),)] = kv[..., :full * dst.shape[-1], :] \
                .unflatten(-2, (full, dst.shape[-1])).transpose(-1, -2)
        if rem:
            dst[lead + (full, slice(None), slice(0, rem))] = \
                kv[..., full * dst.shape[-1]:, :].transpose(-1, -2)
        return dst
    dst = _target(storage, out)
    if layout is Layout.SOA:
        kv = torch.movedim(kv, -1, 0)
    dst[tuple(slice(0, n) for n in kv.shape)] = kv
    return dst


def _aosoa_tilefold(kv: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, Hkv, C) token slab -> (B, Hkv//tile, C, tile) AoSoA slab."""
    B, H, C = kv.shape
    return kv.reshape(B, H // tile, tile, C).transpose(-1, -2)


def kv_write_token(storage: torch.Tensor, k_t: torch.Tensor,
                   v_t: torch.Tensor, pos, layout: Layout = Layout.AOS,
                   order: str = "bsh", *, out=None) -> torch.Tensor:
    """The cache with one token's k/v (B, Hkv, hd) written at sequence
    slot ``pos``: a scalar (the whole batch at one position) or a (B,)
    vector of per-slot positions (continuous batching); into ``out`` when
    given (``storage`` itself to write in place)."""
    kv = torch.cat([k_t, v_t], dim=-1).to(storage.dtype)
    B, H, C = kv.shape
    pos = torch.as_tensor(pos, device=storage.device).long()
    if pos.dim() == 0:
        pos = pos.expand(B)
    b = torch.arange(B, device=storage.device)
    h = torch.arange(H, device=storage.device)
    out = _target(storage, out)
    if order == "bsh":
        if layout is Layout.AOS:                     # (B, S, Hkv, 2hd)
            out[b, pos] = kv
        elif layout is Layout.SOA:                   # (2hd, B, S, Hkv)
            out[:, b, pos] = torch.movedim(kv, -1, 0)
        else:                                        # (B, S, n, 2hd, t)
            out[b, pos] = _aosoa_tilefold(kv, storage.shape[-1])
        return out
    if layout is Layout.AOS:                         # (B, Hkv, S, 2hd)
        out[b[:, None], h[None, :], pos[:, None]] = kv
    elif layout is Layout.SOA:                       # (2hd, B, Hkv, S)
        out[:, b[:, None], h[None, :], pos[:, None]] = torch.movedim(
            kv, -1, 0)
    else:                                            # (B, Hkv, S//t, 2hd, t)
        tile = storage.shape[-1]
        out[b[:, None], h[None, :], (pos // tile)[:, None], :,
            (pos % tile)[:, None]] = kv
    return out
