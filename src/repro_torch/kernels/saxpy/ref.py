"""Plain PyTorch versions of the SAXPY kernels (flat + record forms)."""

import torch

from ...core.layout import RecordArray


def saxpy_ref(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` with ``a`` cast to the working dtype."""
    return torch.as_tensor(a, dtype=x.dtype, device=x.device) * x + y


def saxpy_record_ref(rec: RecordArray, a) -> RecordArray:
    """``y = a*x + y`` on a ``SAXPY_SPEC`` record, any layout."""
    return rec.set_field("y", saxpy_ref(a, rec.field("x"), rec.field("y")))
