"""Public SAXPY functions (flat arrays + layout-polymorphic record form).

Each follows its input's device: a CUDA tensor goes to the CUDA kernel (or
the wrapper raises), a CPU tensor to the plain PyTorch version.
``use_kernel=False`` asks for the plain version on either device.
"""

from ...core.layout import dispatch_with_relayout
from ...tuning.tiles import resolve_tile
from .._common import on_cuda
from .kernel import (DEFAULT_BLOCK, PREFERRED_LAYOUT, SAXPY_SPEC,
                     SUPPORTED_LAYOUTS, TILE_KERNEL, check_record_block,
                     saxpy_cuda, saxpy_record_cuda)
from .ref import saxpy_record_ref, saxpy_ref

__all__ = ["SAXPY_SPEC", "saxpy", "saxpy_record", "saxpy_ref",
           "saxpy_record_ref"]


def saxpy(a, x, y, *, block: int = 1024, bounds_check: bool = True,
          use_kernel: bool = True, out=None):
    """``a * x + y`` over flat tensors (paper Table 2's iterator-overhead
    probe; ``bounds_check`` picks the BC or NBC kernel variant), into
    ``out`` when given (``y`` itself for ``y += a * x``)."""
    if use_kernel and on_cuda(x):
        return saxpy_cuda(a, x, y, block=block, bounds_check=bounds_check,
                          out=out)
    return saxpy_ref(a, x, y, out=out)


def _plain_record(rec, a, *, block, out=None):
    return saxpy_record_ref(rec, a, out=out)


def saxpy_record(rec, a, *, block=None, use_kernel: bool = True, out=None):
    """``y = a*x + y`` on a RecordArray with fields ``x``/``y`` — one kernel
    body under AoS, SoA and AoSoA — into ``out`` when given (``rec``
    itself to update in place).  ``block=None`` resolves through the
    ambient tile scope (``repro_torch.tuning.tiles``); the kernel path
    requires ``block`` to tile the record's cells, on both devices."""
    block = resolve_tile(TILE_KERNEL, block, DEFAULT_BLOCK, shape=rec.space)
    if not use_kernel:
        return saxpy_record_ref(rec, a, out=out)
    check_record_block(rec.space[0], block)
    fn = saxpy_record_cuda if on_cuda(rec.data) else _plain_record
    return dispatch_with_relayout(fn, rec, a, supported=SUPPORTED_LAYOUTS,
                                  preferred=PREFERRED_LAYOUT, block=block,
                                  out=out)
