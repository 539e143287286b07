"""State-space and linear-recurrence blocks, as ``repro.models.ssm``
builds them: Mamba-2 (SSD) and RG-LRU (RecurrentGemma).

Mamba-2 follows arXiv:2405.21060 with n_groups = 1: separate projections
for z / x / B / C / dt, a causal depthwise conv over the x / B / C
streams, SSD in the chunked dual form and a per-head gated RMSNorm.  The
SSD goes through ``kernels/ssd/ops.py``'s ``ssd``: its intra-chunk part on
the K7 kernel for a CUDA tensor, or on its plain version for a CPU tensor
or with ``use_kernel=False``, then the state scan across chunks in torch
ops.  The one-token decode step stays plain torch, as the JAX package's
``ssd_decode_step`` is plain jnp.

RG-LRU follows the Griffin paper (arXiv:2402.19427): block-diagonal input
and recurrence gates, a = exp(-c softplus(Lambda) r_t) and h_t = a_t
h_{t-1} + sqrt(1 - a_t^2) (i_t x_t).  The JAX package runs the recurrence
with ``lax.associative_scan``, outside any Pallas kernel; here it is a
log-depth doubling scan in float32 torch ops (ceil(log2 S) passes, the
same combine), whose tree differs from XLA's, so the two agree to
float32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.ssd.ops import ssd, ssd_decode_step
from .common import Init, ParamModule

__all__ = ["RG_LRU_C", "causal_conv1d", "conv_state_update",
           "init_mamba2", "mamba2_forward", "mamba2_decode", "init_rglru",
           "linear_scan", "rglru_forward", "rglru_decode"]

f32 = torch.float32

#: the RG-LRU's gate constant c (Griffin)
RG_LRU_C = 8.0


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                  prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, C), w (C, K): depthwise causal conv in float32.
    ``prefix`` (B, K-1, C) is the left halo (decode state); zeros
    otherwise."""
    B, S, C = x.shape
    K = w.shape[-1]
    if prefix is None:
        prefix = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([prefix, x], dim=1)
    out = torch.zeros((B, S, C), dtype=f32, device=x.device)
    for k in range(K):
        out = out + xp[:, k:k + S].float() * w[:, k].float()
    return out.to(x.dtype)


def conv_state_update(state: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """Roll one token into the (B, K-1, C) conv state."""
    return torch.cat([state[:, 1:], xt[:, None]], dim=1)


def init_mamba2(init: Init, parent: ParamModule, *, d_model: int,
                d_state: int, n_heads: int, head_dim: int, d_conv: int = 4,
                name: str = "mamba", pad_heads: int = 0) -> None:
    """Add the Mamba-2 parameters as child ``name`` of ``parent``.
    ``n_heads`` includes ``pad_heads`` zero heads (none at tp = 1)."""
    H, P, N = n_heads, head_dim, d_state
    p = ParamModule()
    init.dense(p, "wz", (d_model, H, P), fan_in=d_model)
    init.dense(p, "wx", (d_model, H, P), fan_in=d_model)
    init.dense(p, "wB", (d_model, N), fan_in=d_model)
    init.dense(p, "wC", (d_model, N), fan_in=d_model)
    init.dense(p, "wdt", (d_model, H), fan_in=d_model)
    # dt bias ~ softplus^-1 of dt in [1e-3, 1e-1]
    init.custom(p, "dt_bias",
                torch.log(torch.expm1(torch.logspace(-3, -1, H))))
    init.custom(p, "A_log", torch.log(torch.linspace(1.0, 16.0, H)))
    init.const(p, "D", (H,), 1.0)
    init.dense(p, "conv_x", (H * P, d_conv), fan_in=d_conv)
    init.dense(p, "conv_B", (N, d_conv), fan_in=d_conv)
    init.dense(p, "conv_C", (N, d_conv), fan_in=d_conv)
    init.const(p, "norm", (H, P), 1.0)
    init.dense(p, "wo", (H, P, d_model), fan_in=H * P)
    if pad_heads:
        with torch.no_grad():
            for nm in ("wz", "wx", "wdt"):
                p[nm][:, H - pad_heads:] = 0.0
            p["wo"][H - pad_heads:] = 0.0
    parent.add_module(name, p)


def _gated_head_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Per-head gated RMSNorm: norm(y * silu(z)) over the head_dim axis."""
    g = y.float() * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _conv_weights(p) -> torch.Tensor:
    return torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=0)


def mamba2_forward(p, x: torch.Tensor, *, chunk: int = 128,
                   init_state=None, conv_prefix=None,
                   use_kernel: bool = True):
    """x (B, S, d) -> (y (B, S, d), (ssd_state, conv_state)).

    The sequence is padded to a chunk multiple with dt = 0 (identity
    decay, no state contribution), so the final state is exact."""
    B, S, d = x.shape
    H, P = p["wz"].shape[1], p["wz"].shape[2]
    N = p["wB"].shape[1]
    K = p["conv_x"].shape[-1]
    cdt = x.dtype

    z = torch.einsum("bsd,dhp->bshp", x, p["wz"].to(cdt))
    xh = torch.einsum("bsd,dhp->bshp", x, p["wx"].to(cdt))
    Bm = x @ p["wB"].to(cdt)
    C = x @ p["wC"].to(cdt)
    dt = x @ p["wdt"].to(cdt)

    streams = torch.cat([xh.reshape(B, S, H * P), Bm, C], dim=-1)
    conv_out = F.silu(causal_conv1d(streams, _conv_weights(p),
                                    prefix=conv_prefix))
    if conv_prefix is None:
        conv_prefix = torch.zeros((B, K - 1, streams.shape[-1]),
                                  dtype=streams.dtype, device=x.device)
    new_conv_state = torch.cat([conv_prefix, streams], dim=1)[:, -(K - 1):]
    xh = conv_out[..., : H * P].reshape(B, S, H, P)
    Bm = conv_out[..., H * P: H * P + N]
    C = conv_out[..., H * P + N:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        zpad = lambda a: F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])
        xh, Bm, C, dt = zpad(xh), zpad(Bm), zpad(C), zpad(dt)
    y, state = ssd(xh, dt, A, Bm, C, D=p["D"].float(), init_state=init_state,
                   chunk=chunk, use_kernel=use_kernel)
    if pad:
        y = y[:, :S]
    y = _gated_head_norm(y, z, p["norm"])
    out = torch.einsum("bshp,hpd->bsd", y, p["wo"].to(y.dtype))
    return out, (state, new_conv_state)


def mamba2_decode(p, xt: torch.Tensor, state, *, out=None):
    """One-token step.  xt (B, d); state = (ssd_state (B,H,P,N),
    conv_state (B, K-1, HP+2N)).  ``out`` = (ssd_out, conv_out): the new
    SSD state goes into ``ssd_out`` when it is given (``ssd_state`` itself:
    in place); the conv window's shift is always a new tensor."""
    ssd_state, conv_state = state
    B, d = xt.shape
    H, P = p["wz"].shape[1], p["wz"].shape[2]
    N = p["wB"].shape[1]
    cdt = xt.dtype

    z = torch.einsum("bd,dhp->bhp", xt, p["wz"].to(cdt))
    xh = torch.einsum("bd,dhp->bhp", xt, p["wx"].to(cdt)).reshape(B, H * P)
    Bm = xt @ p["wB"].to(cdt)
    C = xt @ p["wC"].to(cdt)
    dt = xt @ p["wdt"].to(cdt)

    stream_t = torch.cat([xh, Bm, C], dim=-1)
    full = torch.cat([conv_state, stream_t[:, None]], dim=1)   # (B, K, C)
    conv_t = F.silu(torch.einsum("bkc,ck->bc", full.float(),
                                 _conv_weights(p).float()))
    new_conv_state = full[:, 1:]
    xh = conv_t[:, : H * P].reshape(B, H, P).to(cdt)
    Bm = conv_t[:, H * P: H * P + N].to(cdt)
    C = conv_t[:, H * P + N:].to(cdt)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    new_ssd, yt = ssd_decode_step(ssd_state, xh, dt, A, Bm, C,
                                  D=p["D"].float(),
                                  out=None if out is None else out[0])
    yt = _gated_head_norm(yt, z, p["norm"])
    out = torch.einsum("bhp,hpd->bd", yt, p["wo"].to(yt.dtype))
    return out, (new_ssd, new_conv_state)


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

def init_rglru(init: Init, parent: ParamModule, *, d_model: int,
               lru_width: int, n_blocks: int, d_conv: int = 4,
               name: str = "rglru") -> None:
    """Add the RG-LRU parameters as child ``name`` of ``parent``: the two
    input projections, the conv, the block-diagonal gates over
    ``n_blocks`` blocks and Lambda, set so that a = exp(-c softplus(L))
    spans [0.9, 0.999]."""
    R, Hb = lru_width, n_blocks
    W = R // Hb
    p = ParamModule()
    init.dense(p, "wx", (d_model, R), fan_in=d_model)
    init.dense(p, "wy", (d_model, R), fan_in=d_model)
    init.dense(p, "conv", (R, d_conv), fan_in=d_conv)
    init.dense(p, "gate_a", (Hb, W, W), fan_in=W)
    init.const(p, "gate_a_b", (R,), 0.0)
    init.dense(p, "gate_x", (Hb, W, W), fan_in=W)
    init.const(p, "gate_x_b", (R,), 0.0)
    a0 = torch.linspace(0.9, 0.999, R, dtype=f32)
    init.custom(p, "lam", torch.log(torch.expm1(-torch.log(a0) / RG_LRU_C)))
    init.dense(p, "wo", (R, d_model), fan_in=R)
    parent.add_module(name, p)


def _block_diag(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x (..., R) through the block-diagonal weight (Hb, W, W) plus the
    bias (R,)."""
    Hb, W, _ = w.shape
    xs = x.reshape(*x.shape[:-1], Hb, W)
    out = torch.einsum("...hw,hwv->...hv", xs, w.to(x.dtype))
    return out.reshape(*x.shape[:-1], Hb * W) + b.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _rglru_gates(p, xc: torch.Tensor):
    """The decay a and the gated input of the recurrence, float32; xc
    (..., R)."""
    r = torch.sigmoid(_block_diag(xc, p["gate_a"], p["gate_a_b"]).float())
    i = torch.sigmoid(_block_diag(xc, p["gate_x"], p["gate_x_b"]).float())
    log_a = -RG_LRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xc.float())
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1
                ) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along ``dim`` from h_{-1} = 0: the inclusive
    scan of the reference's combine ``(al, bl), (ar, br) -> (al ar, bl ar
    + br)`` by recursive doubling, ceil(log2 S) passes of whole-tensor ops
    (no op per step; nothing written in place, so autograd
    differentiates it)."""
    S = a.shape[dim]
    d = 1
    while d < S:
        a_prev = torch.cat([torch.ones_like(a.narrow(dim, 0, d)),
                            a.narrow(dim, 0, S - d)], dim=dim)
        b_prev = torch.cat([torch.zeros_like(b.narrow(dim, 0, d)),
                            b.narrow(dim, 0, S - d)], dim=dim)
        b = b_prev * a + b
        a = a_prev * a
        d *= 2
    return b


def rglru_forward(p, x: torch.Tensor, *, init_state=None, conv_prefix=None):
    """x (B, S, d) -> (y (B, S, d), (h_state (B, R) float32, conv_state
    (B, K-1, R))).  ``init_state`` is a carried h, ``conv_prefix`` the
    conv's left halo (decode state).  The conv state is the last K-1 rows
    of the prefix and the input, so a prompt shorter than K-1 keeps the
    zeros before it."""
    B, S, d = x.shape
    R = p["wx"].shape[1]
    K = p["conv"].shape[-1]
    cdt = x.dtype

    xb = x @ p["wx"].to(cdt)
    yb = _gelu(x @ p["wy"].to(cdt))
    xc = causal_conv1d(xb, p["conv"], prefix=conv_prefix)
    if conv_prefix is None:
        conv_prefix = torch.zeros((B, K - 1, R), dtype=cdt, device=x.device)
    new_conv_state = torch.cat([conv_prefix, xb], dim=1)[:, -(K - 1):]

    a, gated = _rglru_gates(p, xc)
    if init_state is not None:
        # the carried state folded in as a virtual step 0
        a = torch.cat([torch.ones((B, 1, R), dtype=a.dtype,
                                  device=x.device), a], dim=1)
        gated = torch.cat([init_state.float()[:, None], gated], dim=1)
    h = linear_scan(a, gated, dim=1)
    if init_state is not None:
        h = h[:, 1:]
    out = (h.to(cdt) * yb) @ p["wo"].to(cdt)
    return out, (h[:, -1], new_conv_state)


def rglru_decode(p, xt: torch.Tensor, state, *, out=None):
    """One-token step.  xt (B, d); state = (h (B, R) float32, conv_state
    (B, K-1, R)).  ``out`` = (h_out, conv_out): the new h goes into
    ``h_out`` when it is given (``h`` itself: in place); the conv window's
    shift is always a new tensor."""
    h, conv_state = state
    cdt = xt.dtype
    xb = xt @ p["wx"].to(cdt)
    yb = _gelu(xt @ p["wy"].to(cdt))
    full = torch.cat([conv_state, xb[:, None]], dim=1)          # (B, K, R)
    xc = torch.einsum("bkr,rk->br", full.float(), p["conv"].float()).to(cdt)
    a, gated = _rglru_gates(p, xc)
    h_new = torch.add(a * h.float(), gated,
                      out=None if out is None else out[0])
    y = (h_new.to(cdt) * yb) @ p["wo"].to(cdt)
    return y, (h_new, full[:, 1:])
