"""Public particle update (layout polymorphic: AoS / SoA / AoSoA).

A CUDA record goes to the CUDA kernel (or the wrapper raises), a CPU
record to the plain PyTorch version; ``use_kernel=False`` asks for the
plain version on either device.
"""

from ...core.layout import dispatch_with_relayout
from ...tuning.tiles import resolve_tile
from .._common import on_cuda
from .kernel import (DEFAULT_BLOCK, PARTICLE_SPEC, PREFERRED_LAYOUT,
                     SUPPORTED_LAYOUTS, TILE_KERNEL, check_block,
                     particle_update_cuda)
from .ref import particle_update_ref

__all__ = ["PARTICLE_SPEC", "particle_update", "particle_update_ref"]


def _plain(particles, dt, *, block, out=None):
    return particle_update_ref(particles, dt, out=out)


def particle_update(particles, dt, *, block=None, use_kernel: bool = True,
                    out=None):
    """``x += v * dt`` over a particle RecordArray (paper Table 3) — one
    kernel body for AoS / SoA / AoSoA — into ``out`` when given
    (``particles`` itself to update in place).  ``block=None`` resolves
    through the ambient tile scope; the kernel path requires ``block`` to
    tile the particles, on both devices."""
    block = resolve_tile(TILE_KERNEL, block, DEFAULT_BLOCK,
                         shape=particles.space)
    if not use_kernel:
        return particle_update_ref(particles, dt, out=out)
    check_block(particles.space[0], block)
    fn = particle_update_cuda if on_cuda(particles.data) else _plain
    return dispatch_with_relayout(fn, particles, dt,
                                  supported=SUPPORTED_LAYOUTS,
                                  preferred=PREFERRED_LAYOUT, block=block,
                                  out=out)
