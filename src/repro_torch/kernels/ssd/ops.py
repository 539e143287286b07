"""Public SSD op: the intra-chunk part on the K7 kernel for a CUDA tensor
(or the wrapper raises) or its plain version for a CPU tensor, then the
inter-chunk state scan in torch ops.  ``use_kernel=False`` asks for the
plain version on either device.  On the card the kernel runs inside
``SsdIntraChunkFn``, whose gradient is the plain version's."""

from __future__ import annotations

import torch

from ...tuning.tiles import resolve_tile
from .._common import on_cuda
from .kernel import DEFAULT_CHUNK, TILE_KERNEL, SsdIntraChunkFn
from .ref import (ssd_chunked, ssd_decode_step, ssd_inter_chunk,
                  ssd_intra_chunk_ref, ssd_naive)

__all__ = ["ssd", "ssd_intra_chunk", "ssd_chunked", "ssd_decode_step",
           "ssd_naive"]


def ssd_intra_chunk(x, dt, A, Bm, C, *, chunk: int, use_kernel: bool = True):
    """K7's function on the kernel (CUDA tensor) or its plain version."""
    if use_kernel and on_cuda(x):
        return SsdIntraChunkFn.apply(
            x.contiguous(), dt.to(torch.float32).contiguous(),
            A.to(torch.float32).contiguous(), Bm.contiguous(),
            C.contiguous(), chunk)
    return ssd_intra_chunk_ref(x, dt, A, Bm, C, chunk=chunk)


def ssd(x, dt, A, Bm, C, D=None, init_state=None, *, chunk=None,
        use_kernel: bool = True):
    """Mamba-2 SSD: the intra-chunk quadratic part (K7) and the
    inter-chunk state scan; returns ``(y, final_state)``.

    ``chunk=None`` resolves the chunk length through the ambient tile
    scope (kernel ``"ssd"``); an explicit ``chunk`` always wins, and
    outside any scope the kernel default applies."""
    chunk = resolve_tile(TILE_KERNEL, chunk, DEFAULT_CHUNK,
                         shape=(x.shape[1],))
    y_intra, s_chunk = ssd_intra_chunk(x, dt, A, Bm, C, chunk=chunk,
                                       use_kernel=use_kernel)
    return ssd_inter_chunk(y_intra, s_chunk, x, dt, A, C, D, init_state,
                           chunk=chunk)
