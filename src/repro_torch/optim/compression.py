"""Error-feedback int8 gradient compression, as
``repro.optim.compression``: per-tensor max-abs scaling, with the
quantisation residual carried into the next step's gradient so that the
accumulated update is unbiased (Seide et al. 2014; Karimireddy et al.
2019).  ``compressed_psum`` is the data-parallel mean-reduce with int8
payloads and error feedback, over the axes of the port's ``Mesh``.  The
collective moves 1 byte a gradient and one float32 scale a tensor instead
of 4 bytes a gradient."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import collectives as coll
from ..core.mesh import Mesh, ShardedArray

__all__ = ["ErrorFeedbackState", "quantize_int8", "dequantize_int8",
           "compressed_psum"]


@dataclass(frozen=True)
class ErrorFeedbackState:
    """The residuals, one float32 tensor per gradient, by name."""

    residual: dict

    @classmethod
    def init(cls, grads: dict) -> "ErrorFeedbackState":
        """Zero residuals shaped like ``grads`` (name -> tensor, or name
        -> one tensor per mesh shard for :func:`compressed_psum`)."""
        def zeros(g):
            return torch.zeros(g.shape, dtype=torch.float32,
                               device=g.device)

        return cls({k: zeros(g) if isinstance(g, torch.Tensor)
                    else [zeros(s) for s in _shards(g)]
                    for k, g in grads.items()})


def _shards(g) -> list:
    return list(g.shards if isinstance(g, ShardedArray) else g)


def _scale(x: torch.Tensor) -> torch.Tensor:
    """The max-abs scale of float32 ``x``: max(|x|, 1e-12) / 127."""
    return torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8, scale float32 scalar); x_hat = q * scale."""
    x = x.float()
    scale = _scale(x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q * scale in float32."""
    return q.float() * scale


def compressed_psum(grads: dict, mesh: Mesh, axis_name, *,
                    ef: ErrorFeedbackState) -> tuple[dict, ErrorFeedbackState]:
    """Mean-reduce ``grads`` over ``axis_name`` (a mesh axis or a tuple of
    them) with int8 payloads and error feedback, as the reference's
    ``compressed_psum`` inside ``shard_map``.  ``grads`` and
    ``ef.residual`` map a name to one tensor per mesh shard (a list in
    the mesh's order, or a ``ShardedArray``).  Returns ``(mean, ef')``:
    per name, the mean on every shard (equal within a group) and each
    shard's new residual.

    Per tensor, in stages over all shards: the residual added in
    float32; the shared scale, the ``pmax`` of the shards' max-abs
    scales; each shard requantised to int8 against it (its residual what
    that loses, rounded once); the ``psum`` of the payloads in int32
    (exact); that sum times ``smax / n``, once for the shards of a group
    that share a device (they share the sum)."""
    n = coll.axis_size(mesh, axis_name)
    mean, resid = {}, {}
    for name, g in grads.items():
        gs = [s.float() + r for s, r in zip(_shards(g),
                                            _shards(ef.residual[name]))]
        smax = coll.pmax([_scale(s) for s in gs], mesh, axis_name)
        q2 = [torch.clamp(torch.round(s / m), -127, 127).to(torch.int8)
              for s, m in zip(gs, smax)]
        # g - q * smax rounded once (a fused multiply-add, as XLA
        # compiles the reference's)
        resid[name] = [torch.addcmul(s, q.float(), m, value=-1)
                       for s, q, m in zip(gs, q2, smax)]
        total = coll.psum([q.to(torch.int32) for q in q2], mesh, axis_name)
        shared, mean[name] = {}, []
        for t, m in zip(total, smax):
            key = (id(t), id(m))
            if key not in shared:
                shared[key] = t.float() * (m / n)
            mean[name].append(shared[key])
    return mean, ErrorFeedbackState(resid)
