"""Optimizers, learning-rate schedules and int8 gradient compression with
its mean-reduce over a mesh (``compressed_psum``), as ``repro.optim``
(its GSPMD helpers are not here: ROADMAP "Not ported")."""

from .compression import (ErrorFeedbackState, compressed_psum,
                          dequantize_int8, quantize_int8)
from .optimizers import (AdamW, Adafactor, Optimizer, clip_by_global_norm,
                         make_optimizer)
from .schedules import cosine_schedule, linear_warmup

__all__ = [
    "AdamW", "Adafactor", "Optimizer", "clip_by_global_norm",
    "make_optimizer", "cosine_schedule", "linear_warmup",
    "ErrorFeedbackState", "quantize_int8", "dequantize_int8",
    "compressed_psum",
]
