"""Error-feedback int8 gradient compression, as
``repro.optim.compression``: per-tensor max-abs scaling, with the
quantisation residual carried into the next step's gradient so that the
accumulated update is unbiased (Seide et al. 2014; Karimireddy et al.
2019).  The collective around it (``compressed_psum``) waits for the
port's mesh (ROADMAP queue 5)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["ErrorFeedbackState", "quantize_int8", "dequantize_int8"]


@dataclass(frozen=True)
class ErrorFeedbackState:
    """The residuals, one float32 tensor per gradient, by name."""

    residual: dict

    @classmethod
    def init(cls, grads: dict) -> "ErrorFeedbackState":
        """Zero residuals shaped like ``grads`` (name -> tensor)."""
        return cls({k: torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device)
                    for k, g in grads.items()})


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8, scale float32 scalar); x_hat = q * scale."""
    x = x.float()
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q * scale in float32."""
    return q.float() * scale
