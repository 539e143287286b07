"""Plain PyTorch version of the FORCE flux-difference stencil."""

from ...core.layout import RecordArray
from ...physics import euler


def flux_difference_ref(state_haloed: RecordArray, lam_x,
                        lam_y) -> RecordArray:
    """Sum of FORCE flux differences over both dims; un-haloed result in
    the input's layout."""
    U = euler.stack_state(state_haloed)
    out = euler.flux_difference(U, lam_x, lam_y)
    return euler.unstack_state(out, state_haloed)
