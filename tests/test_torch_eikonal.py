"""The port's eikonal FIM package and the Table 5 solve against the JAX
package, on the CPU.

On a CPU tensor each ops function computes its plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode and its jnp oracle, as
its own tests do.  Tolerances, as (atol, rtol): float32 1e-5; bfloat16
(2e-3, 1.6e-2), a few bfloat16 steps at the fronts' magnitude, the limit
the kernel is held to on the card (the plain versions of both packages
round after every operation and agree bit for bit here).  Inputs come
from ``numpy.default_rng``.  K5
itself runs only on a GPU: ``test_torch_cuda.py`` holds it against its
plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch import workloads
from repro_torch.interop import state_from_reference

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-3, 1.6e-2)}


def _inputs(shape, dtype, seed=0):
    """A haloed phi with values spread over a few cells' distance (both
    Godunov branches, pinned sources among them) and a ~5 % source mask.
    Each package gets its own copy: on the CPU ``jnp.asarray`` takes a
    64-byte-aligned numpy buffer without copying it, so a tensor from
    ``torch.from_numpy`` of the same array would be JAX's buffer too."""
    rng = np.random.default_rng(seed)
    nx, ny = shape
    phi = rng.uniform(0.0, 8.0 / nx, (nx + 2, ny + 2)).astype(np.float32)
    mask = rng.random(shape) < 0.05
    return ((jnp.array(phi, copy=True).astype(getattr(jnp, dtype)),
             jnp.array(mask, copy=True)),
            (torch.from_numpy(phi.copy()).to(getattr(torch, dtype)),
             torch.from_numpy(mask.copy())))


def _close(got, want, tol):
    atol, rtol = tol
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_godunov_update_matches_reference(dtype):
    from repro.kernels.eikonal.kernel import godunov_update as ref_fn
    from repro_torch.kernels.eikonal.kernel import godunov_update

    (rp, rm), (pp, pm) = _inputs((32, 128), dtype, seed=1)
    got = godunov_update(pp, pm, 1.0 / 32)
    assert got.dtype == pp.dtype and tuple(got.shape) == (32, 128)
    _close(got, ref_fn(rp, rm, 1.0 / 32), TOL[dtype])


@pytest.mark.parametrize("inner", [1, 2, 4])
@pytest.mark.parametrize("block", [(8, 64), (16, 128)])
@pytest.mark.parametrize("shape", [(32, 128), (64, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_eikonal_fim_matches_reference(dtype, shape, block, inner):
    """The batched-tile plain version against the JAX Pallas kernel
    (interpret mode) and the JAX oracle, which loops over the tiles."""
    from repro.kernels.eikonal.kernel import eikonal_fim_pallas
    from repro.kernels.eikonal.ops import eikonal_fim_sweep as ref_sweep
    from repro_torch.kernels.eikonal.ops import (eikonal_fim_ref,
                                                 eikonal_fim_sweep)

    (rp, rm), (pp, pm) = _inputs(shape, dtype)
    h = 1.0 / shape[0]
    got = eikonal_fim_sweep(pp, pm, h, inner=inner, block=block)
    assert got.dtype == pp.dtype and tuple(got.shape) == shape
    assert torch.equal(got, eikonal_fim_ref(pp, pm, h, inner=inner,
                                            block=block))
    _close(got, eikonal_fim_pallas(rp, rm, h, inner=inner, block=block,
                                   interpret=True), TOL[dtype])
    _close(got, ref_sweep(rp, rm, h, inner=inner, block=block,
                          use_pallas=False), TOL[dtype])


def test_eikonal_tiles_are_semantic():
    """With inner > 1 the tile changes the result in both packages alike
    (the frozen halo), so parity above is not a tile-blind identity."""
    from repro_torch.kernels.eikonal.ops import eikonal_fim_sweep

    _, (pp, pm) = _inputs((32, 128), "float32")
    a = eikonal_fim_sweep(pp, pm, 1 / 32, inner=4, block=(8, 64))
    b = eikonal_fim_sweep(pp, pm, 1 / 32, inner=4, block=(16, 128))
    assert not torch.equal(a, b)
    a = eikonal_fim_sweep(pp, pm, 1 / 32, inner=1, block=(8, 64))
    b = eikonal_fim_sweep(pp, pm, 1 / 32, inner=1, block=(16, 128))
    assert torch.equal(a, b)


def test_eikonal_block_contract_fails_in_both():
    from repro.kernels.eikonal.kernel import eikonal_fim_pallas
    from repro_torch.kernels.eikonal.ops import eikonal_fim_sweep

    (rp, rm), (pp, pm) = _inputs((32, 16), "float32")
    with pytest.raises(AssertionError):
        eikonal_fim_pallas(rp, rm, 1 / 32, block=(16, 12))
    for use_kernel in (True, False):
        with pytest.raises(ValueError, match="must tile"):
            eikonal_fim_sweep(pp, pm, 1 / 32, block=(16, 12),
                              use_kernel=use_kernel)


def test_eikonal_global_jacobi_matches_reference():
    from repro.kernels.eikonal.ref import eikonal_global_jacobi as ref_fn
    from repro_torch.kernels.eikonal.ops import eikonal_global_jacobi

    inp = workloads.eikonal_inputs(32)
    want = ref_fn(jnp.asarray(inp["phi"]), jnp.asarray(inp["mask"]),
                  1 / 32, 20)
    got = eikonal_global_jacobi(torch.from_numpy(inp["phi"]),
                                torch.from_numpy(inp["mask"]), 1 / 32, 20)
    _close(got, want, TOL["float32"])


def test_tile_registry_matches_reference():
    from repro.kernels.eikonal import kernel as rk
    from repro.tuning import tiles as rt
    from repro_torch.kernels.eikonal import kernel as pk
    from repro_torch.tuning import tiles as pt

    for shape in ((32, 128), (64, 256), (4096, 4096), (24, 64)):
        assert pt.tile_candidates("eikonal", shape) == \
            rt.tile_candidates("eikonal", shape)
    assert pk.DEFAULT_BLOCK == rk.DEFAULT_BLOCK


# -- the graph builders -------------------------------------------------------

def _ref_eikonal_graph(n, inner, block, loop):
    """``workloads.build_eikonal_graph`` written with the JAX package's
    ``Graph`` API (``loop=False``: the sweep graph alone)."""
    from repro.kernels.eikonal.ops import make_eikonal_graph

    phi = ref.DistTensor("phi", (n, n), halo=(1, 1),
                         boundary=ref.Boundary.TRANSMISSIVE)
    mask = ref.DistTensor("mask", (n, n), dtype=bool)
    sweep = make_eikonal_graph(phi, mask, 1.0 / n, inner=inner, block=block,
                               overlap=False)
    if not loop:
        return sweep
    phi_prev = ref.DistTensor("phi_prev", (n, n))
    change = ref.DistTensor("change", (n, n))
    res = ref.make_reduction_result("res", init=float("inf"))
    body = ref.Graph(name="fim_iteration")
    body.split(lambda p, _prev: p, phi, phi_prev)
    body.then(sweep)
    body.then_split(lambda p, q, _d: jnp.abs(p - q), phi, phi_prev, change)
    body.then_reduce(change, res, ref.MaxReducer())
    body.conditional(lambda s: s["res"] > 0)
    return ref.Graph(name="eikonal_solve").emplace(body)


def _init(ex, n):
    inp = workloads.eikonal_inputs(n)
    return {k: np.asarray(v) for k, v in ex.init_state(
        phi=jnp.asarray(inp["phi"]), mask=jnp.asarray(inp["mask"])).items()}


@pytest.mark.parametrize("inner,block", [(1, None), (4, (8, 32))])
def test_eikonal_graph_steps_match_reference(inner, block):
    from repro_torch.kernels.eikonal.ops import make_eikonal_graph

    n, steps = 32, 6
    rex = ref.Executor(_ref_eikonal_graph(n, inner, block, loop=False))
    init = _init(rex, n)
    want = np.asarray(rex.run(rex.init_state(**init), steps)["phi"])
    phi = port.DistTensor("phi", (n, n), halo=(1, 1),
                          boundary=port.Boundary.TRANSMISSIVE)
    mask = port.DistTensor("mask", (n, n), dtype=torch.bool)
    pex = port.Executor(make_eikonal_graph(phi, mask, 1.0 / n, inner=inner,
                                           block=block, overlap=False),
                        device="cpu")
    got = pex.run(state_from_reference(init, "cpu"), steps)["phi"]
    _close(got, want, TOL["float32"])


def test_eikonal_solve_matches_reference():
    """The whole conditional loop at n = 64, (8, 64) tiles: the same state
    as the JAX executor's ``lax.while_loop``, and within 3h of the exact
    distance in the band within 0.1 of the circle."""
    n, block = 64, (8, 64)
    rex = ref.Executor(_ref_eikonal_graph(n, 4, block, loop=True))
    init = _init(rex, n)
    want = {k: np.asarray(v) for k, v in rex(rex.init_state(**init)).items()}
    g, _, converging = workloads.build_eikonal_graph(n, block=block,
                                                     max_iters=4 * n)
    pex = port.Executor(g, device="cpu")
    got = pex(state_from_reference(init, "cpu"))
    assert set(got) == set(want)
    for k in ("phi", "phi_prev", "change", "res"):
        _close(got[k], want[k], TOL["float32"])
    assert float(got["res"]) == 0.0 and converging.iterations > 1
    dist = workloads.eikonal_distance(n)
    band = dist < 0.1
    assert np.abs(got["phi"].numpy() - dist)[band].max() <= 3.0 / n


def test_eikonal_solve_stops_past_max_iters():
    g, _, converging = workloads.build_eikonal_graph(32, block=(8, 32),
                                                     max_iters=3)
    ex = port.Executor(g, device="cpu")
    inp = workloads.eikonal_inputs(32)
    init = {k: torch.from_numpy(v) for k, v in inp.items()}
    with pytest.raises(RuntimeError, match="after 3 iterations"):
        ex(ex.init_state(**init))
    converging.max_iters = None   # the predicate starts afresh
    ex(ex.init_state(**init))
    assert converging.iterations > 3


@pytest.mark.parametrize("inner,use_kernel,launches",
                         [(4, None, 1), (1, None, 1), (4, False, 0),
                          (1, False, 0)])
def test_eikonal_graph_reaches_the_kernel_by_default(monkeypatch, inner,
                                                     use_kernel, launches):
    """A sweep graph built with the defaults sends a GPU tensor to K5 for
    every ``inner`` (a single sweep on a dividing tile); only
    ``use_kernel=False`` asks for the plain version."""
    from repro_torch.kernels.eikonal import ops

    calls = []

    def fake_cuda(p, m, h, *, inner, block, out=None):
        calls.append((inner, block))
        return ops.eikonal_fim_ref(p, m, h, inner=inner, block=block,
                                   out=out)

    monkeypatch.setattr(ops, "on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "eikonal_fim_cuda", fake_cuda)
    phi = port.DistTensor("phi", (24, 40), halo=(1, 1))
    mask = port.DistTensor("mask", (24, 40), dtype=torch.bool)
    kw = {} if use_kernel is None else {"use_kernel": use_kernel}
    g = ops.make_eikonal_graph(phi, mask, 1 / 24, inner=inner,
                               block=(12, 20), **kw)
    ex = port.Executor(g, device="cpu")
    ex(ex.init_state(phi=torch.rand(24, 40)))
    assert len(calls) == launches
    if calls:
        assert calls[0] == (inner, (12, 20) if inner > 1 else (8, 40))


def test_single_sweep_block_divides_the_interior():
    from repro_torch.kernels.eikonal.ops import single_sweep_block

    assert single_sweep_block((4096, 4096)) == (8, 128)
    assert single_sweep_block((30, 300)) == (6, 100)
    assert single_sweep_block((7, 97)) == (7, 97)


def _owned(n_tiles, per_block, tile, per_warp, n_warps, per_lane, n_lanes):
    """How many times K5's geometry covers each index of one dim: tile
    ``b * per_block + t`` of size ``tile``, split into ``n_warps`` strips of
    ``per_warp`` (rows) or ``n_lanes`` lanes of ``per_lane`` (columns);
    slots past the tile own nothing."""
    blocks = np.arange(n_tiles // per_block)[:, None, None, None, None]
    t = np.arange(per_block)[None, :, None, None, None]
    w = np.arange(n_warps)[None, None, :, None, None]
    lane = np.arange(n_lanes)[None, None, None, :, None]
    k = np.arange(per_warp * per_lane)[None, None, None, None, :]
    local = w * per_warp * n_lanes + lane * per_lane + k
    idx = (blocks * per_block + t) * tile + local
    idx = np.broadcast_to(idx, np.broadcast_shapes(
        blocks.shape, t.shape, w.shape, lane.shape, k.shape))
    local = np.broadcast_to(local, idx.shape)
    return np.bincount(idx[local < tile], minlength=n_tiles * tile)


@pytest.mark.parametrize("n", [64, 256, 4096])
def test_eikonal_kernel_geometry_owns_every_cell_once(n):
    """K5's geometry for every tuning tile: each interior cell owned by
    exactly one (block, tile, warp, lane, slot), and every tile inside the
    kernel's budget.  Ownership is a product of a row map (blocks along
    dim 0, tiles a block, warps a tile, rows a warp) and a column map
    (blocks along dim 1, lanes, columns a lane), so each is checked on its
    own."""
    from repro_torch.kernels.eikonal.kernel import (
        MAX_CELLS_PER_LANE, MAX_SMEM_BYTES, MAX_THREADS, ROWS_PER_WARP,
        fim_geometry, tile_candidates)

    for tile in tile_candidates((n, n)):
        geo = fim_geometry((n, n), tile)
        bx, by = geo.block
        assert geo.block == tile
        gy_tiles = geo.grid[1] * geo.tiles_per_block
        assert gy_tiles * bx == n and geo.grid[0] * by == n
        rows = _owned(gy_tiles, geo.tiles_per_block, bx, geo.rows_per_warp,
                      geo.warps_per_tile, 1, 1)
        cols = _owned(geo.grid[0], 1, by, 1, 1, geo.cols_per_lane, 32)
        assert (rows == 1).all() and (cols == 1).all(), tile
        # the budget: an instance of the kernel, one register and one bit
        # a cell, 512 threads a block, shared memory within the card's
        assert geo.rows_per_warp == ROWS_PER_WARP[geo.cols_per_lane]
        assert geo.cells_per_lane <= MAX_CELLS_PER_LANE
        assert 32 <= geo.threads <= MAX_THREADS
        assert geo.smem_bytes <= MAX_SMEM_BYTES
        assert (geo.smem_bytes == 0) == (geo.warps_per_tile == 1)
        assert geo.grid[1] <= 65535
        # no warp holds only slots past its tile
        assert (geo.warps_per_tile - 1) * geo.rows_per_warp < bx


def test_eikonal_kernel_geometry_main_path():
    """The main path's (8, 128) tile at 4096^2: two warps a tile, 4 rows of
    4 columns a lane, 4 tiles a block, 16 KB of shared memory for the rows
    the warps pass each other."""
    from repro_torch.kernels.eikonal.kernel import fim_geometry

    geo = fim_geometry((4096, 4096), (8, 128))
    assert (geo.cols_per_lane, geo.rows_per_warp, geo.warps_per_tile,
            geo.tiles_per_block, geo.grid) == (4, 4, 2, 4, (32, 128))
    assert geo.threads == 256 and geo.smem_bytes == 16384
    with pytest.raises(ValueError, match="must tile"):
        fim_geometry((4096, 4096), (8, 96))
