"""Plain PyTorch version of the NaN-ignoring max and min: the torch route
of ``core/graph.py``'s ``MaxReducer`` and ``MinReducer``, which the CPU,
integer, boolean and other float tensors and the views that do not merge
take (``kernel.kernel_geometry``)."""

import torch


def nan_ignoring_extremum_ref(x, *, largest: bool, out=None):
    """Ripple's ``max`` (``largest``) or ``min`` of every element of
    ``x``: a quiet NaN is ignored, and the all-NaN tensor reduces to NaN.
    ``out`` (a 0-d tensor of ``x``'s dtype) receives the result."""
    reduce_all = torch.amax if largest else torch.amin
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        m = reduce_all(x)
        return m if out is None else out.copy_(m)
    nan = torch.isnan(x)
    m = reduce_all(x.masked_fill(nan, float("-inf" if largest else "inf")))
    return torch.where(nan.all(), torch.full_like(m, float("nan")), m,
                       out=out)
