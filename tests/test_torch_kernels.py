"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each ops function computes its plain PyTorch version; the
JAX side runs its Pallas kernels as its own tests do (``use_pallas=True``,
interpret mode).  Tolerances are those of ``tests/test_kernel_golden.py``:
float32 1e-5, flux float32 1e-4, bfloat16 2e-2.  The CUDA kernels
themselves run only on a GPU: ``test_torch_cuda.py`` holds them against
their plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port

LAYOUTS = ["AOS", "SOA", "AOSOA"]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype, f32=1e-5, bf16=2e-2):
    return f32 if dtype == "float32" else bf16


def _jnp(x: np.ndarray, dtype: str):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _torch(x: np.ndarray, dtype: str):
    return torch.from_numpy(np.array(x)).to(getattr(torch, dtype))


def _close(got, want, tol):
    g = got.data if isinstance(got, port.RecordArray) else got
    w = want.data if isinstance(want, ref.RecordArray) else want
    np.testing.assert_allclose(g.float().numpy(),
                               np.asarray(w, np.float32), rtol=tol, atol=tol)


def _record_pair(spec_r, spec_p, fields, layout, dtype):
    r = ref.RecordArray.from_fields(
        spec_r, {k: _jnp(v, dtype) for k, v in fields.items()},
        ref.Layout[layout])
    p = port.RecordArray.from_fields(
        spec_p, {k: _torch(v, dtype) for k, v in fields.items()},
        port.Layout[layout])
    return r, p


# -- K1 flat saxpy ------------------------------------------------------------

@pytest.mark.parametrize("n", [2048, 1000])
@pytest.mark.parametrize("bounds_check", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_saxpy_matches_reference(n, bounds_check, dtype):
    from repro.kernels.saxpy.ops import saxpy as ref_saxpy
    from repro_torch.kernels.saxpy.ops import saxpy

    rng = np.random.default_rng(n)
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    want = ref_saxpy(1.75, _jnp(x, dtype), _jnp(y, dtype), block=256,
                     bounds_check=bounds_check)
    got = saxpy(1.75, _torch(x, dtype), _torch(y, dtype), block=256,
                bounds_check=bounds_check)
    assert got.dtype == getattr(torch, dtype) and got.shape == (n,)
    _close(got, want, _tol(dtype))


# -- K2 record saxpy, K3 particle update ---------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_saxpy_record_matches_reference(layout, dtype):
    from repro.kernels.saxpy.kernel import SAXPY_SPEC as RS
    from repro.kernels.saxpy.ops import saxpy_record as ref_fn
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC as PS, saxpy_record

    rng = np.random.default_rng(7)
    fields = {"x": rng.standard_normal(1024), "y": rng.standard_normal(1024)}
    r, p = _record_pair(RS, PS, fields, layout, dtype)
    want = ref_fn(r, 2.5, block=256)
    got = saxpy_record(p, 2.5, block=256)
    assert got.layout.name == layout and got.dtype == p.dtype
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_particle_update_matches_reference(layout, dtype):
    from repro.kernels.particle.ops import PARTICLE_SPEC as RS
    from repro.kernels.particle.ops import particle_update as ref_fn
    from repro_torch.kernels.particle.ops import (PARTICLE_SPEC as PS,
                                                  particle_update)

    rng = np.random.default_rng(8)
    fields = {"x": rng.standard_normal((512, 3)),
              "v": rng.standard_normal((512, 3))}
    r, p = _record_pair(RS, PS, fields, layout, dtype)
    want = ref_fn(r, 0.25, block=256)
    got = particle_update(p, 0.25, block=256)
    assert got.layout.name == layout and got.dtype == p.dtype
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("kernel", ["saxpy_record", "particle"])
def test_record_block_contract_fails_in_both(kernel):
    """A block that does not tile the cells fails in the reference and in
    the port, on the kernel path only."""
    if kernel == "saxpy_record":
        from repro.kernels.saxpy.kernel import SAXPY_SPEC as RS
        from repro.kernels.saxpy.ops import saxpy_record as ref_fn
        from repro_torch.kernels.saxpy.ops import (SAXPY_SPEC as PS,
                                                   saxpy_record as fn)
        fields = {"x": np.ones(768), "y": np.ones(768)}
    else:
        from repro.kernels.particle.ops import PARTICLE_SPEC as RS
        from repro.kernels.particle.ops import particle_update as ref_fn
        from repro_torch.kernels.particle.ops import (PARTICLE_SPEC as PS,
                                                      particle_update as fn)
        fields = {"x": np.ones((768, 3)), "v": np.ones((768, 3))}
    r, p = _record_pair(RS, PS, fields, "SOA", "float32")
    with pytest.raises(AssertionError):
        ref_fn(r, 0.5, block=512)
    with pytest.raises(ValueError, match="tile by block"):
        fn(p, 0.5, block=512)
    fn(p, 0.5, block=512, use_kernel=False)   # the plain path has no tiles


# -- K4 FORCE flux difference ---------------------------------------------------

def _haloed_euler(nx, ny, dtype):
    from repro.physics.euler import shock_bubble_init

    d = shock_bubble_init(nx, ny).astype(getattr(jnp, dtype))
    for ax in (1, 2):
        d = ref.pad_boundary_only(d, axis=ax, width=1,
                                  boundary=ref.Boundary.TRANSMISSIVE)
    return np.asarray(d.astype(jnp.float32))


@pytest.mark.parametrize("shape", [(32, 16), (32, 128)])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flux_difference_matches_reference(shape, layout, dtype):
    from repro.kernels.stencil.ops import flux_difference as ref_fn
    from repro.physics.euler import EULER_SPEC as RS
    from repro_torch.kernels.stencil.ops import flux_difference
    from repro_torch.physics.euler import EULER_SPEC as PS

    d = _haloed_euler(*shape, dtype)
    r = ref.relayout(ref.RecordArray(_jnp(d, dtype), RS, ref.Layout.SOA),
                     ref.Layout[layout])
    p = port.relayout(port.RecordArray(_torch(d, dtype), PS,
                                       port.Layout.SOA),
                      port.Layout[layout])
    want = ref_fn(r, 0.1, 0.1)
    got = flux_difference(p, 0.1, 0.1)
    assert got.layout.name == layout and got.space == shape
    _close(got, want, _tol(dtype, f32=1e-4))


def test_flux_block_contract_fails_in_both():
    from repro.kernels.stencil.ops import flux_difference as ref_fn
    from repro.physics.euler import EULER_SPEC as RS
    from repro_torch.kernels.stencil.ops import flux_difference
    from repro_torch.physics.euler import EULER_SPEC as PS

    d = _haloed_euler(32, 16, "float32")
    r = ref.RecordArray(jnp.asarray(d), RS, ref.Layout.SOA)
    p = port.RecordArray(_torch(d, "float32"), PS, port.Layout.SOA)
    with pytest.raises(AssertionError):
        ref_fn(r, 0.1, 0.1, block=(16, 12))
    with pytest.raises(ValueError, match="must tile"):
        flux_difference(p, 0.1, 0.1, block=(16, 12))


def _flux_cover(nx, ny):
    """How often K4's geometry writes each interior row and column (a cell
    is written by exactly one warp when both are 1), as
    ``FluxGeometry`` documents the mapping, and the last haloed row and
    column any warp reads."""
    from repro_torch.kernels.stencil.kernel import flux_geometry

    geo = flux_geometry(nx, ny)
    R, W, (gx, gy) = geo.rows_per_strip, geo.warps_per_block, geo.grid
    rows, cols = np.zeros(nx, int), np.zeros(ny, int)
    last_row = last_col = 0
    for s in range(gy):
        x0 = s * R
        if x0 >= nx:
            continue
        nrows = min(R, nx - x0)
        rows[x0:x0 + nrows] += 1
        # the rows of the strip and one past it on each side, and the walk's
        # loads two rows ahead, clamped to nx + 1
        last_row = max(last_row, x0 + nrows + 1, min(x0 + nrows + 3, nx + 1))
    for w in range(gx * W):
        y0 = w * 32
        if y0 >= ny:
            continue
        cols[y0:min(y0 + 32, ny)] += 1
        # lane columns clamped to ny + 1, and lane 31's right neighbour
        last_col = max(last_col, min(y0 + 32, ny + 1), min(y0 + 33, ny + 1))
    return geo, rows, cols, last_row, last_col


def _check_flux_geometry(nx, ny):
    from repro_torch.kernels.stencil.kernel import (MAX_GRID_Y, MAX_ROWS,
                                                    MAX_WARPS)

    geo, rows, cols, last_row, last_col = _flux_cover(nx, ny)
    assert (rows == 1).all() and (cols == 1).all(), (nx, ny)
    assert last_row <= nx + 1 and last_col <= ny + 1
    R, W, (gx, gy) = geo.rows_per_strip, geo.warps_per_block, geo.grid
    assert 1 <= R <= MAX_ROWS and 1 <= W <= MAX_WARPS
    assert 32 <= geo.threads <= 1024 and 1 <= gy <= MAX_GRID_Y
    # no block lies wholly past the interior
    assert (gy - 1) * R < nx and (gx - 1) * W * 32 < ny


def test_flux_geometry_covers_every_tile_interior():
    """Every interior the tile registry offers tiles for, sides 16-4096."""
    sides = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
    for nx in sides:
        for ny in sides:
            _check_flux_geometry(nx, ny)


@pytest.mark.parametrize("shape", [(1, 1), (1, 33), (37, 131), (5, 64),
                                   (3, 129), (64, 257), (4097, 4095)])
def test_flux_geometry_covers_ragged_interiors(shape):
    """Ragged shapes: one cell, one column past a warp, neither axis a
    multiple, one row past a strip, a strip shorter than the geometry's
    with one column past a block, one column past a warp, both."""
    _check_flux_geometry(*shape)


def test_flux_geometry_main_path():
    """4096^2: strips of 4 rows, 4 warps a block, 32 x 1024 blocks."""
    from repro_torch.kernels.stencil.kernel import flux_geometry

    geo = flux_geometry(4096, 4096)
    assert (geo.rows_per_strip, geo.warps_per_block, geo.grid) == \
        (4, 4, (32, 1024))
    with pytest.raises(ValueError, match="empty interior"):
        flux_geometry(0, 4)


# -- physics (the math inside K4) ------------------------------------------------

@pytest.mark.parametrize("fn", ["pressure", "sound_speed", "max_wavespeed",
                                "flux0", "flux1", "force_flux",
                                "flux_difference", "update_dim",
                                "update_full", "shock_bubble_init"])
def test_euler_matches_reference(fn):
    import repro.physics.euler as re
    import repro_torch.physics.euler as pe

    U = re.shock_bubble_init(24, 20)
    U_np = np.asarray(U)
    Ut = torch.from_numpy(np.array(U_np))
    calls = {
        "pressure": lambda m, u: m.pressure(u),
        "sound_speed": lambda m, u: m.sound_speed(u),
        "max_wavespeed": lambda m, u: m.max_wavespeed(u),
        "flux0": lambda m, u: m.flux(u, 0),
        "flux1": lambda m, u: m.flux(u, 1),
        "force_flux": lambda m, u: m.force_flux(u[:, :-1], u[:, 1:], 0, 0.1),
        "flux_difference": lambda m, u: m.flux_difference(u, 0.1, 0.2),
        "update_dim": lambda m, u: m.update_dim(u, 1, 0.1),
        "update_full": lambda m, u: m.update_full(u, 0.1, 0.2),
        # the port builds on the GPU unless asked for the CPU
        "shock_bubble_init": lambda m, u: m.shock_bubble_init(
            24, 20, **({} if m is re else {"device": "cpu"})),
    }
    want = np.asarray(calls[fn](re, U))
    got = calls[fn](pe, Ut).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- device contract -----------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    from repro_torch import workloads
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda
    from repro_torch.kernels.eikonal.ops import (eikonal_fim_ref,
                                                 eikonal_fim_sweep)
    from repro_torch.kernels.particle.kernel import particle_update_cuda
    from repro_torch.kernels.particle.ops import (PARTICLE_SPEC,
                                                  particle_update,
                                                  particle_update_ref)

    p = port.RecordArray.from_fields(
        PARTICLE_SPEC, {"x": torch.ones(256, 3), "v": torch.ones(256, 3)},
        port.Layout.AOS)
    before = particle_update_cuda.launches
    got = particle_update(p, 0.5, block=128)
    assert torch.equal(got.data, particle_update_ref(p, 0.5).data)
    assert particle_update_cuda.launches == before

    phi, mask = torch.rand(18, 34), torch.rand(16, 32) < 0.1
    before = eikonal_fim_cuda.launches
    got = eikonal_fim_sweep(phi, mask, 1 / 16, block=(8, 32))
    assert torch.equal(got, eikonal_fim_ref(phi, mask, 1 / 16,
                                            block=(8, 32)))
    g, _, _ = workloads.build_eikonal_graph(16, block=(8, 16))
    ex = port.Executor(g, device="cpu")
    inp = workloads.eikonal_inputs(16)
    ex(ex.init_state(**{k: torch.from_numpy(v) for k, v in inp.items()}))
    assert eikonal_fim_cuda.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no fallback."""
    from repro_torch.kernels.particle.kernel import particle_update_cuda
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC
    from repro_torch.kernels.saxpy.kernel import saxpy_cuda, saxpy_record_cuda
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda
    from repro_torch.kernels.stencil.kernel import flux_difference_cuda
    from repro_torch.physics.euler import EULER_SPEC

    x = torch.ones(256)
    calls = [
        lambda: saxpy_cuda(1.0, x, x),
        lambda: saxpy_record_cuda(port.RecordArray(
            torch.ones(2, 256), SAXPY_SPEC, port.Layout.SOA), 1.0),
        lambda: particle_update_cuda(port.RecordArray(
            torch.ones(6, 256), PARTICLE_SPEC, port.Layout.SOA), 1.0),
        lambda: flux_difference_cuda(port.RecordArray(
            torch.ones(4, 6, 6), EULER_SPEC, port.Layout.SOA), 0.1, 0.1),
        lambda: eikonal_fim_cuda(torch.ones(10, 10),
                                 torch.zeros(8, 8, dtype=torch.bool), 0.1,
                                 inner=4, block=(8, 8)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()


def test_tile_registry_resolves_like_reference():
    import repro.kernels.stencil.kernel  # noqa: F401  registers "flux"
    from repro.tuning import tiles as rt
    from repro_torch.kernels.stencil import kernel as sk  # registers "flux"
    from repro_torch.tuning import tiles as pt

    assert pt.tile_candidates("flux", (32, 128)) == \
        rt.tile_candidates("flux", (32, 128))
    assert pt.resolve_tile("flux", None, sk.DEFAULT_BLOCK) == (8, 128)
    with pt.tile_scope({"flux": (16, 64)}):
        assert pt.resolve_tile("flux", None, sk.DEFAULT_BLOCK) == (16, 64)
        assert pt.resolve_tile("flux", (8, 8), sk.DEFAULT_BLOCK) == (8, 8)
    with pt.record_tile_use() as rec:
        pt.resolve_tile("flux", None, sk.DEFAULT_BLOCK, shape=(32, 128))
    assert rec == {"flux": {((32, 128), (8, 128))}}


def test_build_digest_covers_every_header(tmp_path, monkeypatch):
    """A library's name digests its source and every ``csrc/*.cuh``: an
    edited header (shared by K6 and K7, or the record accessor of K2-K4)
    names a new library for every source, so no stale build loads."""
    import shutil

    from repro_torch.kernels import _build

    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    headers = sorted(p.name for p in tmp_path.glob("*.cuh"))
    assert {"hopper.cuh", "record_index.cuh"} <= set(headers)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    for name in headers:
        (tmp_path / name).write_text((tmp_path / name).read_text() + "\n")
        after = {n: _build.library_path(n) for n in _build.SOURCES}
        assert all(after[n] != before[n] for n in _build.SOURCES), name
        before = after
    # a new header joins the digest too
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert all(_build.library_path(n) != before[n] for n in _build.SOURCES)
