"""Plain PyTorch version of the FORCE flux-difference stencil."""

from ...core.layout import RecordArray
from ...physics import euler
from .._common import check_out


def flux_difference_ref(state_haloed: RecordArray, lam_x, lam_y, *,
                        out=None) -> RecordArray:
    """Sum of FORCE flux differences over both dims; un-haloed result in
    the input's layout, written into ``out`` when given (a record apart
    from the input, as the kernel wrapper takes it)."""
    U = euler.stack_state(state_haloed)
    res = euler.unstack_state(euler.flux_difference(U, lam_x, lam_y),
                              state_haloed)
    if out is None:
        return res
    if not isinstance(out, RecordArray) or out.spec != res.spec \
            or out.layout is not res.layout:
        raise ValueError(f"flux_difference: out must be a record like "
                         f"{res!r}, got {out!r}")
    check_out(out.data, res.data.shape, res.dtype, res.device,
              "flux_difference", apart=(state_haloed.data,))
    out.data.copy_(res.data)
    return out
