"""Plain PyTorch versions of Mamba-2 SSD (state-space duality,
arXiv:2405.21060).

``ssd_naive``            token-by-token linear recurrence (ground truth);
``ssd_intra_chunk_ref``  the K7 kernel's function: per chunk the
                         quadratic dual form and the chunk's outgoing state;
``ssd_inter_chunk``      the state scan across chunks, ``y_inter`` and the
                         ``D`` skip around either of the two;
``ssd_chunked``          both, the whole chunked dual form;
``ssd_decode_step``      one recurrent step for serving.

Shapes (n_groups = 1):
  x  (B, S, H, P)   dt (B, S, H)    A (H,) negative
  Bm (B, S, N)      C  (B, S, N)    D (H,) skip
  y  (B, S, H, P)   state (B, H, P, N)
"""

from __future__ import annotations

import torch

__all__ = ["ssd_naive", "ssd_intra_chunk_ref", "ssd_inter_chunk",
           "ssd_chunked", "ssd_decode_step"]

f32 = torch.float32


def ssd_naive(x, dt, A, Bm, C, D=None, init_state=None):
    """Token-by-token recurrence; returns ``(y, final_state)``."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    state = (torch.zeros((B_, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    A = A.to(f32)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].to(f32), dt[:, t].to(f32)
        bt, ct = Bm[:, t].to(f32), C[:, t].to(f32)
        da = torch.exp(dtt * A)
        upd = (dtt[..., None] * xt)[..., None] * bt[:, None, None, :]
        state = state * da[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, ct))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), state


def ssd_intra_chunk_ref(x, dt, A, Bm, C, *, chunk: int = 64):
    """The K7 kernel's function: ``(y_intra (B, S, H, P) in x's dtype,
    s_chunk (B, S/chunk, H, P, N) float32)``."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} must tile by chunk {chunk}")
    nc = S // chunk
    xc = x.reshape(B_, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(B_, nc, chunk, H).to(f32)
    bc = Bm.reshape(B_, nc, chunk, N).to(f32)
    cc = C.reshape(B_, nc, chunk, N).to(f32)
    cs = torch.cumsum(dtc * A.to(f32), dim=2)                # (B, nc, L, H)
    seg = cs.movedim(3, 2)[..., :, None] - cs.movedim(3, 2)[..., None, :]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # masked before the exponential: above the diagonal seg > 0 may overflow
    decay = torch.exp(torch.where(mask, seg, 0.0)) * mask     # (B,nc,H,L,L)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    scores = cb[:, :, None] * decay
    dx = dtc[..., None] * xc
    y = torch.einsum("bchij,bcjhp->bcihp", scores, dx)
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)
    s_chunk = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bc, dtc * decay_to_end,
                           xc)
    return y.reshape(B_, S, H, P).to(x.dtype), s_chunk


def ssd_inter_chunk(y_intra, s_chunk, x, dt, A, C, D=None, init_state=None,
                    *, chunk: int = 64):
    """The state scan across chunks and the inter-chunk output, as
    ``ssd_pallas`` computes them around the kernel; returns ``(y in x's
    dtype, final_state float32)``."""
    B_, S, H, P = x.shape
    N = C.shape[-1]
    nc = S // chunk
    dtc = dt.reshape(B_, nc, chunk, H).to(f32)
    cs = torch.cumsum(dtc * A.to(f32), dim=2)
    total = torch.exp(cs[:, :, -1, :])                        # (B, nc, H)
    state = (torch.zeros((B_, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * total[:, c, :, None, None] + s_chunk[:, c]
    entering = torch.stack(entering, dim=1)                   # (B,nc,H,P,N)
    cc = C.reshape(B_, nc, chunk, N).to(f32)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", cc, entering,
                           torch.exp(cs))
    y = y_intra.to(f32) + y_inter.reshape(B_, S, H, P)
    if D is not None:
        y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), state


def ssd_chunked(x, dt, A, Bm, C, D=None, init_state=None, chunk: int = 64):
    """The whole chunked dual form in plain PyTorch; ``(y, final_state)``.
    The intra-chunk part stays float32 up to the sum with ``y_inter``."""
    x32 = x.to(f32)
    y_intra, s_chunk = ssd_intra_chunk_ref(x32, dt, A, Bm, C, chunk=chunk)
    y, state = ssd_inter_chunk(y_intra, s_chunk, x32, dt, A, C, D,
                               init_state, chunk=chunk)
    return y.to(x.dtype), state


def ssd_decode_step(state, xt, dtt, A, bt, ct, D=None, *, out=None):
    """Single-token recurrent step for serving (constant memory).

    state (B, H, P, N); xt (B, H, P); dtt (B, H); bt/ct (B, N).  The new
    state goes into ``out`` when given (a float32 tensor of the state's
    shape; ``state`` itself to update in place: each element is read
    before it is written)."""
    state = state.to(f32)
    da = torch.exp(dtt.to(f32) * A.to(f32))
    upd = (dtt.to(f32)[..., None] * xt.to(f32))[..., None] \
        * bt.to(f32)[:, None, None, :]
    state = torch.add(state * da[..., None, None], upd, out=out)
    yt = torch.einsum("bhpn,bn->bhp", state, ct.to(f32))
    if D is not None:
        yt = yt + xt.to(f32) * D.to(f32)[None, :, None]
    return state, yt.to(xt.dtype)
