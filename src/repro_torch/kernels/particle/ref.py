"""Plain PyTorch version of the particle update."""

import torch

from ...core.layout import RecordArray
from .._common import record_into


def particle_update_ref(particles: RecordArray, dt, *,
                        out=None) -> RecordArray:
    """``x += v * dt`` with ``dt`` cast to the working dtype, any layout;
    into ``out`` as the kernel wrapper takes it (``particles`` itself to
    update in place)."""
    x = particles.field("x")
    v = particles.field("v")
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
    if out is None:
        return particles.set_field("x", x + v * dt)
    return record_into(out, particles, "x", x + v * dt,
                       "particle_update")
