"""Public NaN-ignoring max and min: the local reduction of the
``MaxReducer`` and the ``MinReducer``.

The route follows what the input shows: a CUDA float32 tensor with
elements whose view merges into rows of contiguous elements
(:func:`~.kernel.kernel_geometry`) goes to the kernel, everything else to
the plain PyTorch version, as does a tensor that requires grad under
grad mode (the kernel's result carries no gradient).  Both give the same
result.
"""

import torch

from .kernel import kernel_geometry, nan_ignoring_extremum_cuda
from .ref import nan_ignoring_extremum_ref

__all__ = ["nan_ignoring_extremum", "nan_ignoring_extremum_ref",
           "kernel_geometry", "route"]


def route(x) -> str:
    """``"kernel"`` where :func:`nan_ignoring_extremum` launches the
    kernel for ``x``, ``"torch"`` where it takes the plain version."""
    x = torch.as_tensor(x)
    if kernel_geometry(x.device.type, x.dtype, x.shape, x.stride()) \
            is None or (x.requires_grad and torch.is_grad_enabled()):
        return "torch"
    return "kernel"


def nan_ignoring_extremum(x, *, largest: bool, out=None):
    """The max (``largest``) or min of every element of ``x``, a quiet NaN
    ignored and the all-NaN tensor reduced to NaN, into ``out`` (a 0-d
    tensor of ``x``'s dtype) when given."""
    x = torch.as_tensor(x)
    if route(x) == "kernel":
        return nan_ignoring_extremum_cuda(x, largest=largest, out=out)
    return nan_ignoring_extremum_ref(x, largest=largest, out=out)
