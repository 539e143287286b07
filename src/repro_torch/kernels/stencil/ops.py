"""Public FORCE flux-difference stencil + its graph builder.

The CUDA kernel streams strips of rows through registers, one warp a
strip of 32 columns, and computes each face once; it reads cells in
per-axis storage (AoS or SoA).  An AoSoA input is relayouted to the
kernel's preferred layout on the way in and back on the way out — the
same boundary conversion the executor's layout solver emits.  A CUDA
record goes to the kernel (or the wrapper raises), a CPU record to the
plain version.
"""

from typing import Optional

from ...core.graph import Graph, concurrent_padded_access, in_place
from ...core.layout import dispatch_with_relayout
from ...core.tensor import DistTensor
from ...tuning.tiles import resolve_tile
from .._common import on_cuda
from .kernel import (DEFAULT_BLOCK, PREFERRED_LAYOUT, SUPPORTED_LAYOUTS,
                     TILE_KERNEL, check_block, flux_difference_cuda)
from .ref import flux_difference_ref

__all__ = ["flux_difference", "flux_difference_ref", "fitting_block",
           "make_flux_difference_graph"]


def flux_difference(state_haloed, lam_x, lam_y, *, block=None,
                    use_kernel: bool = True, out=None):
    """Sum of FORCE flux differences over both dims of a haloed 2-D Euler
    record (paper Table 4): ``(nx+2, ny+2)`` space in, ``(nx, ny)`` out,
    layout polymorphic.  ``block=None`` resolves the reference's
    ``(bx, by)`` tile through the ambient tile scope; the kernel path
    requires it to divide the interior, on both devices;
    ``use_kernel=False`` asks for the plain version on either device.
    ``out`` (a record of the interior in the input's layout, apart from
    the input) receives the result."""
    interior = tuple(s - 2 for s in state_haloed.space)
    block = resolve_tile(TILE_KERNEL, block, DEFAULT_BLOCK, shape=interior)
    if not use_kernel:
        return flux_difference_ref(state_haloed, lam_x, lam_y, out=out)
    check_block(interior, block)
    fn = flux_difference_cuda if on_cuda(state_haloed.data) \
        else flux_difference_ref
    return dispatch_with_relayout(fn, state_haloed, lam_x, lam_y,
                                  supported=SUPPORTED_LAYOUTS,
                                  preferred=PREFERRED_LAYOUT, out=out)


def fitting_block(interior: tuple[int, int]) -> tuple[int, int]:
    """The tile a graph node takes when ``block=None``: the kernel default
    where it tiles the interior, else per dim the largest divisor of the
    interior up to the default's.  K4's geometry is its own, so the tile
    only has to meet the contract (:func:`~.kernel.check_block`); the
    result is the same on any tile."""
    try:
        check_block(interior, DEFAULT_BLOCK)
        return DEFAULT_BLOCK
    except ValueError:
        return tuple(max(d for d in range(1, min(cap, n) + 1) if n % d == 0)
                     for n, cap in zip(interior, DEFAULT_BLOCK))


def make_flux_difference_graph(
    u: DistTensor,
    out: DistTensor,
    lam_x,
    lam_y,
    *,
    overlap: bool = True,
    use_kernel: bool = True,
    block=None,
    graph: Optional[Graph] = None,
) -> Graph:
    """One-node Ripple graph: FORCE flux difference over a (possibly
    2-D-partitioned) Euler record ``u`` with halo ``(1, 1)`` into ``out``.
    ``graph=`` appends the node to an existing graph.  The node follows
    its record's device (the kernel on the GPU, the plain version on the
    CPU), once per shard on a mesh; ``use_kernel=False`` asks for the
    plain version on either device.

    With ``overlap=True`` on a mesh, the executor copies every halo block
    (edge strips and corners) up front and runs the node on each shard's
    interior while they fly, then on the per-(axis, side) boundary strips,
    which are 1 cell thin.  An explicit ``block`` must tile every one of
    those extents; ``block=None`` takes the tile scope's or
    :func:`fitting_block`'s per call.  Under ``regions=True`` the node
    writes ``out``'s static buffer (K4's ``out=``)."""

    @in_place                   # it never reads its second arg
    def flux_node(rec, _out, out=None):
        tile = block
        if tile is None:
            interior = tuple(s - 2 for s in rec.space)
            if fitting_block(interior) != DEFAULT_BLOCK:
                tile = fitting_block(interior)
        return flux_difference(rec, lam_x, lam_y, block=tile,
                               use_kernel=use_kernel, out=out)

    g = graph if graph is not None else Graph(name="flux_difference")
    g.split(flux_node, concurrent_padded_access(u), out, overlap=overlap)
    return g
