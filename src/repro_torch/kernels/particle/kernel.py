"""Particle update CUDA kernel (paper §7.2, Table 3) — wrapper of
``csrc/particle.cu``.

K3 :func:`particle_update_cuda` replaces ``particle_update_pallas``
(``repro/kernels/particle/kernel.py``): ``x += v * dt`` for N particles
with 3-d position and velocity in ONE record buffer, AoS ``(n, 6)``, SoA
``(6, n)`` or AoSoA ``(n_tiles, 6, tile)``; v is copied through.  The
kernel body is written once against the record accessor
(``csrc/record_index.cuh``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.layout import (Layout, RecordArray, RecordSpec, Vector,
                            aosoa_tile)
from ...tuning.tiles import register_tile_kernel
from .. import _build
from .._common import (LAYOUT_CODE, check_cuda_tensor, record_out, round_to,
                       stream_of)

PARTICLE_SPEC = RecordSpec.create(Vector("x", 3), Vector("v", 3))
SUPPORTED_LAYOUTS = (Layout.AOS, Layout.SOA, Layout.AOSOA)
PREFERRED_LAYOUT = Layout.AOSOA
TILE_KERNEL = "particle"
DEFAULT_BLOCK = 512

_SIG = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {"particle_update_f32": _SIG, "particle_update_bf16": _SIG}


def tile_candidates(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Particles-per-block sizes that tile ``n`` particles exactly."""
    (n,) = shape
    return tuple(b for b in (128, 256, 512, 1024, 2048, 4096)
                 if b <= n and n % b == 0)


register_tile_kernel(TILE_KERNEL, tile_candidates)


def check_block(n: int, block: int) -> None:
    """The reference's contract: ``block`` particles per program must tile
    the ``n`` particles exactly."""
    if block < 1 or n % block:
        raise ValueError(f"n={n} must tile by block={block}")


def particle_update_cuda(particles: RecordArray, dt, *, block: int = 512,
                         out: Optional[RecordArray] = None) -> RecordArray:
    """``x += v * dt`` on a ``PARTICLE_SPEC`` record on the GPU, any of the
    three layouts; ``dt`` is rounded to the working dtype first.  ``out``
    is a record of the same spec, space and layout to write (``particles``
    itself to update in place: each thread reads a particle before it
    writes it, and ``csrc/particle.cu`` promises no ``__restrict__``)."""
    sfx = check_cuda_tensor(particles.data, "particle_update")
    if particles.spec != PARTICLE_SPEC \
            or particles.layout not in SUPPORTED_LAYOUTS \
            or len(particles.space) != 1:
        raise ValueError(f"particle_update: expects a 1-d PARTICLE_SPEC "
                         f"record, got {particles!r}")
    (n,) = particles.space
    check_block(n, block)
    tile = aosoa_tile(n) if particles.layout is Layout.AOSOA else 1
    dst = record_out(out, particles, "particle_update")
    lib = _build.load("particle", _SIGNATURES)
    with torch.cuda.device(particles.data.device):
        code = getattr(lib, f"particle_update_{sfx}")(
            particles.data.data_ptr(), dst.data_ptr(),
            round_to(dt, particles.dtype), n, LAYOUT_CODE[particles.layout],
            tile, block, stream_of(particles.data))
    _build.check(lib, code, "particle_update")
    particle_update_cuda.launches += 1
    if out is not None:
        return out
    return RecordArray(dst, particles.spec, particles.layout)


particle_update_cuda.launches = 0
