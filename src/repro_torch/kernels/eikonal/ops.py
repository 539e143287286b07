"""Public eikonal FIM sweep + its graph builder.

A CUDA tensor goes to the K5 kernel (or the wrapper raises), a CPU tensor
to the plain PyTorch version; ``use_kernel=False`` asks for the plain
version on either device.
"""

from typing import Optional

from ...core.graph import Graph, exclusive_padded_access
from ...core.tensor import DistTensor
from ...tuning.tiles import resolve_tile
from .._common import on_cuda
from .kernel import (DEFAULT_BLOCK, TILE_KERNEL, eikonal_fim_cuda,
                     godunov_update)
from .ref import eikonal_fim_ref, eikonal_global_jacobi

__all__ = ["eikonal_fim_sweep", "eikonal_fim_ref", "eikonal_global_jacobi",
           "godunov_update", "make_eikonal_graph", "single_sweep_block"]


def eikonal_fim_sweep(phi_haloed, source_mask, h, *, inner: int = 4,
                      block=None, use_kernel: bool = True, out=None):
    """``inner`` FIM Jacobi sweeps per tile, the tile held in registers,
    over a haloed ``(nx+2, ny+2)`` level-set tensor (paper Table 5);
    returns the updated ``(nx, ny)`` interior.

    ``block=None`` resolves the ``(bx, by)`` tile through the ambient tile
    scope (``repro_torch.tuning.tiles``); an explicit ``block`` always
    wins, and outside any scope the kernel default applies.  The tile must
    divide the interior, on both devices.  ``out`` (an ``(nx, ny)`` tensor
    apart from both inputs) receives the interior."""
    interior = tuple(s - 2 for s in phi_haloed.shape)
    block = resolve_tile(TILE_KERNEL, block, DEFAULT_BLOCK, shape=interior)
    fn = eikonal_fim_cuda if use_kernel and on_cuda(phi_haloed) \
        else eikonal_fim_ref
    kw = {} if out is None else {"out": out}
    return fn(phi_haloed, source_mask, h, inner=inner, block=block, **kw)


def single_sweep_block(interior: tuple[int, int]) -> tuple[int, int]:
    """A tile for one sweep, whose result no tile changes: per dim the
    largest divisor of the interior up to :data:`DEFAULT_BLOCK`'s."""
    return tuple(max(d for d in range(1, min(cap, n) + 1) if n % d == 0)
                 for n, cap in zip(interior, DEFAULT_BLOCK))


def make_eikonal_graph(
    phi: DistTensor,
    mask: DistTensor,
    h: float,
    *,
    inner: int = 1,
    overlap: bool = True,
    use_kernel: bool = True,
    block=None,
    graph: Optional[Graph] = None,
) -> Graph:
    """One outer FIM sweep as a Ripple graph node: ``phi`` (halo ``(1, 1)``,
    possibly 2-D partitioned) updated, ``mask`` riding as an unpadded
    output-aligned arg (the overlapped lowering cuts it per boundary
    strip).  Run the
    graph repeatedly — or wrap it in ``conditional`` with a residual
    reduction — for the paper's convergence loop.

    ``inner > 1`` runs frozen-halo sweeps per ``block`` tile, which makes
    the result depend on the tile decomposition (the paper's FIM ghost-zone
    trade); ``inner=1`` is a pure radius-1 stencil whose result no tile
    changes, so it ignores ``block`` and sweeps on a tile from
    :func:`single_sweep_block`, which tiles every shard and boundary
    strip a mesh gives it.  With ``inner > 1`` the caller picks a
    ``block`` that tiles every extent the node sees (on a mesh, each
    shard; with ``overlap=True``, each strip too).  The node follows its
    tensors' device as :func:`eikonal_fim_sweep` does, once per shard;
    under ``regions=True`` it writes ``phi``'s static buffer (K5's
    ``out=``; it reads ``phi`` through its padded copy).  ``graph=``
    appends the node to an existing graph."""

    def sweep(p_haloed, m, out=None):
        tile = block
        if inner == 1:
            tile = single_sweep_block(tuple(s - 2 for s in p_haloed.shape))
        return eikonal_fim_sweep(p_haloed, m, h, inner=inner, block=tile,
                                 use_kernel=use_kernel, out=out)

    g = graph if graph is not None else Graph(name="eikonal_sweep")
    g.split(sweep, exclusive_padded_access(phi), mask, writes=(0,),
            overlap=overlap)
    return g
