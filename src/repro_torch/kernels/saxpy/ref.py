"""Plain PyTorch versions of the SAXPY kernels (flat + record forms).

``out=`` takes what the kernel wrappers take, checked the same way, so
that the CPU path writes where the card's does: ``y`` (or the record)
itself for an update in place, or a tensor apart from the inputs."""

import torch

from ...core.layout import RecordArray
from .._common import check_out, record_into


def saxpy_ref(a, x: torch.Tensor, y: torch.Tensor, *,
              out=None) -> torch.Tensor:
    """``a * x + y`` with ``a`` cast to the working dtype."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    if out is None:
        return a * x + y
    check_out(out, x.shape, x.dtype, x.device, "saxpy", apart=(x,),
              in_place=(y,))
    return torch.add(a * x, y, out=out)


def saxpy_record_ref(rec: RecordArray, a, *, out=None) -> RecordArray:
    """``y = a*x + y`` on a ``SAXPY_SPEC`` record, any layout."""
    y = saxpy_ref(a, rec.field("x"), rec.field("y"))
    if out is None:
        return rec.set_field("y", y)
    return record_into(out, rec, "y", y, "saxpy_record")
