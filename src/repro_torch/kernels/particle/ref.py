"""Plain PyTorch version of the particle update."""

import torch

from ...core.layout import RecordArray


def particle_update_ref(particles: RecordArray, dt) -> RecordArray:
    """``x += v * dt`` with ``dt`` cast to the working dtype, any layout."""
    x = particles.field("x")
    v = particles.field("v")
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
    return particles.set_field("x", x + v * dt)
