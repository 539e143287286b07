"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skips without one.  The module imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-5 (flux 1e-4: ~90-operation face fluxes summed in
another order; the SSD 2e-4: up to 128 terms of magnitude ~10 summed in
another order), bfloat16 2e-2 (the kernels compute in float32 and round
once, the plain versions round after every operation).  The eikonal
kernel in bfloat16, which rounds its tile once per sweep, is held to atol
2e-3 with rtol 1.6e-2: a few bfloat16 steps at the fronts' magnitude.
The attention and SSD kernels and their plain versions both compute in
float32 and round once, so a bfloat16 output is held to its float32 atol
and 2^-6 relative (two bfloat16 steps at the least), and the SSD's
float32 chunk states to 2e-5 in either dtype."""

import numpy as np
import pytest
import torch

from repro_torch.core import (Boundary, Executor, Layout, RecordArray,
                              pad_boundary_only)
from repro_torch import workloads
from repro_torch.kernels.eikonal.kernel import tile_candidates

pytestmark = pytest.mark.cuda

DTYPES = ["float32", "bfloat16"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _tol(dtype, f32=1e-5):
    return f32 if dtype == "float32" else 2e-2


# (atol, rtol) of the attention kernel's output and the SSD kernel's
# y_intra and chunk states, by dtype
LM_TOL = {"attention": {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2**-6)},
          "ssd y": {"float32": (2e-4, 2e-4), "bfloat16": (2e-4, 2**-6)},
          "ssd states": {"float32": (2e-5, 2e-5), "bfloat16": (2e-5, 2e-5)}}


def _close(got, want, tol, rtol=None):
    got, want = got.float().cpu(), want.float().cpu()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=tol,
                               rtol=tol if rtol is None else rtol)


def _randn(dev, dtype, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(
        getattr(torch, dtype))


# (n, x offset, y offset) in elements: views x[1:], y[1:] and x aligned
# with y not are off the 16-byte grid, so the kernel runs the whole call
# scalar; n = 2^20 + 3 also leaves a scalar tail after the vectors
@pytest.mark.parametrize("n,x_off,y_off", [
    pytest.param(4096, 0, 0, id="4096"),
    pytest.param(5000, 0, 0, id="5000"),
    pytest.param(2**20 + 3, 1, 1, id="1048579-views"),
    pytest.param(2**20 + 3, 0, 1, id="1048579-mixed")])
@pytest.mark.parametrize("bounds_check", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_saxpy_kernel(dev, n, x_off, y_off, bounds_check, dtype):
    from repro_torch.kernels.saxpy.kernel import saxpy_cuda
    from repro_torch.kernels.saxpy.ops import saxpy, saxpy_ref

    x = _randn(dev, dtype, n + x_off, seed=1)[x_off:]
    y = _randn(dev, dtype, n + y_off, seed=2)[y_off:]
    before = saxpy_cuda.launches
    got = saxpy(1.75, x, y, block=1024, bounds_check=bounds_check)
    assert saxpy_cuda.launches == before + 1
    _close(got, saxpy_ref(1.75, x, y), _tol(dtype))


@pytest.mark.parametrize("layout", list(Layout))
@pytest.mark.parametrize("dtype", DTYPES)
def test_record_kernels(dev, layout, dtype):
    from repro_torch.kernels.particle.ops import (PARTICLE_SPEC,
                                                  particle_update,
                                                  particle_update_ref)
    from repro_torch.kernels.saxpy.ops import (SAXPY_SPEC, saxpy_record,
                                               saxpy_record_ref)

    rec = RecordArray(_randn(dev, dtype, 2, 8192), SAXPY_SPEC,
                      Layout.SOA).with_layout(layout)
    got = saxpy_record(rec, 0.5)
    assert got.layout is layout
    _close(got.data, saxpy_record_ref(rec, 0.5).data, _tol(dtype))
    rec = RecordArray(_randn(dev, dtype, 6, 8192), PARTICLE_SPEC,
                      Layout.SOA).with_layout(layout)
    got = particle_update(rec, 0.25)
    assert got.layout is layout
    _close(got.data, particle_update_ref(rec, 0.25).data, _tol(dtype))


@pytest.mark.parametrize("layout", list(Layout))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(64, 128), (40, 50), (256, 512),
                                   (33, 33), (1, 1), (37, 131)])
def test_flux_kernel(dev, layout, dtype, shape):
    """Whole strips and warps, and ragged edges: 40 x 50 and 37 x 131 are
    no multiples of the 32-row strip or the 32-column warp, 33 x 33 is one
    row past a strip and one column past a warp, 1 x 1 one cell.  λx and
    λy differ, so an x/y swap shows."""
    from repro_torch.kernels.stencil.ops import (flux_difference,
                                                 flux_difference_ref)
    from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init

    u = shock_bubble_init(*shape, device=dev).to(getattr(torch, dtype))
    for ax in (1, 2):
        u = pad_boundary_only(u, axis=ax, width=1,
                              boundary=Boundary.TRANSMISSIVE)
    rec = RecordArray(u, EULER_SPEC, Layout.SOA).with_layout(layout)
    got = flux_difference(rec, 0.1, 0.2, block=shape)
    assert got.layout is layout and got.space == shape
    _close(got.data, flux_difference_ref(rec, 0.1, 0.2).data,
           _tol(dtype, f32=1e-4))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels.saxpy.kernel import saxpy_cuda

    x = torch.ones(256, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        saxpy_cuda(1.0, x.double(), x.double())
    with pytest.raises(ValueError, match="not contiguous"):
        saxpy_cuda(1.0, torch.ones(512, device=dev)[::2], x)
    with pytest.raises(ValueError, match="equal 1-d"):
        saxpy_cuda(1.0, x, torch.ones(128, device=dev))


@pytest.mark.parametrize("schedule", ["dag", "sequential"])
def test_particle_graph_on_the_card_matches_the_cpu(dev, schedule):
    n, steps = 4096, 5
    g, _, _ = workloads.build_particle_graph(n)
    gpu = Executor(g, schedule=schedule)
    cpu = Executor(g, device="cpu", schedule=schedule)
    assert gpu.device.type == "cuda"
    f = workloads.particle_fields(n)
    init = {k: RecordArray.from_fields(
        spec, {name: torch.from_numpy(v) for name, v in f[k].items()}, lay)
        for k, spec, lay in (
            ("ions", gpu.tensors["ions"].spec, Layout.AOS),
            ("electrons", gpu.tensors["electrons"].spec, Layout.AOSOA),
            ("field", gpu.tensors["field"].spec, Layout.SOA))}
    got = gpu.run(gpu.init_state(**init), steps)
    want = cpu.run(cpu.init_state(**init), steps)
    for k in want:
        assert got[k].device.type == "cuda"
        _close(got[k], want[k], 1e-5)
    np.testing.assert_allclose(
        gpu.read(got, gpu.tensors["ions"]).field("x").cpu().numpy(),
        f["ions"]["x"] + steps * workloads.DT * f["ions"]["v"],
        rtol=1e-4, atol=1e-4)


def test_flux_graph_on_the_card_matches_the_cpu(dev):
    from repro_torch.physics.euler import shock_bubble_init

    g, _ = workloads.build_flux_graph(64, 128)
    gpu, cpu = Executor(g), Executor(g, device="cpu")
    u0 = shock_bubble_init(64, 128)
    got = gpu(gpu.init_state(u=u0))
    want = cpu(cpu.init_state(u=u0))
    _close(got["flux"], want["flux"], 1e-4)


def _eikonal_state(dev, n, dtype, iters=8):
    """A mid-solve eikonal state: the workload's circle of sources after
    ``iters`` float32 iterations of the plain sweep (both Godunov
    branches and the tile edges are in play), haloed, in ``dtype``."""
    from repro_torch.kernels.eikonal.ops import eikonal_fim_ref

    inp = workloads.eikonal_inputs(n)
    phi = torch.from_numpy(inp["phi"]).to(dev)
    mask = torch.from_numpy(inp["mask"]).to(dev)

    def halo(p):
        for ax in (0, 1):
            p = pad_boundary_only(p, axis=ax, width=1,
                                  boundary=Boundary.TRANSMISSIVE)
        return p

    for _ in range(iters):
        phi = eikonal_fim_ref(halo(phi), mask, 1 / n, inner=4, block=(8, 64))
    return halo(phi).to(getattr(torch, dtype)), mask


@pytest.mark.parametrize("inner", [1, 4])
@pytest.mark.parametrize("tile", tile_candidates((256, 256)))
@pytest.mark.parametrize("dtype", DTYPES)
def test_eikonal_kernel(dev, dtype, tile, inner):
    """Every tuning tile: one warp a tile, and warps sharing a tile through
    shared memory.  float32 is uncontracted, so bit-equal."""
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda
    from repro_torch.kernels.eikonal.ops import (eikonal_fim_ref,
                                                 eikonal_fim_sweep)

    phi, mask = _eikonal_state(dev, 256, dtype)
    before = eikonal_fim_cuda.launches
    got = eikonal_fim_sweep(phi, mask, 1 / 256, inner=inner, block=tile)
    assert eikonal_fim_cuda.launches == before + 1
    assert got.dtype == phi.dtype and tuple(got.shape) == (256, 256)
    want = eikonal_fim_ref(phi, mask, 1 / 256, inner=inner, block=tile)
    if dtype == "float32":
        assert torch.equal(got, want)
    else:
        _close(got, want, 2e-3, 1.6e-2)


# (interior, tile, phi offset, mask offset): tiles narrower than a warp's
# 32 columns a lane and a ragged width take the kernel's scalar loads and
# stores; on full-width tiles, phi one element off its allocation turns off
# the pair loads, the mask one byte off the mask words and vector stores
EIK_SCALAR_CASES = {"40x50": ((40, 50), (8, 50), 0, 0),
                    "64x96": ((64, 96), (16, 96), 0, 0),
                    "32x32": ((32, 32), (8, 32), 0, 0),
                    "256x256-offset": ((256, 256), (8, 128), 1, 0),
                    "256x256-mask-offset": ((256, 256), (8, 128), 0, 1),
                    "256x256-both-offset": ((256, 256), (64, 256), 1, 1)}


@pytest.mark.parametrize("case", list(EIK_SCALAR_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_eikonal_kernel_scalar_path(dev, dtype, case):
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda
    from repro_torch.kernels.eikonal.ops import eikonal_fim_ref

    (nx, ny), tile, phi_off, mask_off = EIK_SCALAR_CASES[case]
    g = torch.Generator(device=dev).manual_seed(3)
    phi = torch.rand(nx + 2, ny + 2, generator=g, device=dev)
    phi = phi.masked_fill(phi > 0.5, 1e3).to(getattr(torch, dtype))
    buf = torch.empty(phi.numel() + phi_off, dtype=phi.dtype, device=dev)
    phi = buf[phi_off:].view(phi.shape).copy_(phi)
    mask = torch.rand(nx, ny, generator=g, device=dev) < 0.05
    buf = torch.empty(mask.numel() + mask_off, dtype=mask.dtype, device=dev)
    mask = buf[mask_off:].view(mask.shape).copy_(mask)
    for inner in (1, 4):
        got = eikonal_fim_cuda(phi, mask, 1 / 64, inner=inner, block=tile)
        want = eikonal_fim_ref(phi, mask, 1 / 64, inner=inner, block=tile)
        if dtype == "float32":
            assert torch.equal(got, want)
        else:
            _close(got, want, 2e-3, 1.6e-2)


def test_eikonal_graph_on_the_card_matches_the_cpu(dev):
    n = 256
    inp = {k: torch.from_numpy(v) for k, v in
           workloads.eikonal_inputs(n).items()}
    g, _, converging = workloads.build_eikonal_graph(n, max_iters=4 * n)
    gpu, cpu = Executor(g), Executor(g, device="cpu")
    got = gpu(gpu.init_state(**inp))
    gpu_iters = converging.iterations
    want = cpu(cpu.init_state(**inp))
    assert gpu_iters == converging.iterations > 0
    assert got["phi"].device.type == "cuda"
    _close(got["phi"], want["phi"], 1e-5)


def test_eikonal_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda

    phi = torch.ones(66, 130, device=dev)
    mask = torch.zeros(64, 128, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        eikonal_fim_cuda(phi.double(), mask, 0.1)
    with pytest.raises(TypeError, match="not bool"):
        eikonal_fim_cuda(phi, mask.float(), 0.1)
    with pytest.raises(ValueError, match="not contiguous"):
        eikonal_fim_cuda(torch.ones(130, 66, device=dev).t(), mask, 0.1)
    with pytest.raises(ValueError, match="must tile"):
        eikonal_fim_cuda(phi, mask, 0.1, block=(8, 96))
    # more than 256 columns a tile: the launch refuses it
    with pytest.raises(RuntimeError, match="invalid argument"):
        eikonal_fim_cuda(torch.ones(130, 514, device=dev),
                         torch.zeros(128, 512, dtype=torch.bool, device=dev),
                         0.1, block=(128, 512))


# K6 cases: (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, fused KV);
# lengths off the kernel's 64-row tiles exercise its ragged edge
ATTN_CASES = {
    "causal_gqa": (2, 4, 2, 200, 200, 64, True, None, 0, False),
    "full_mha": (1, 3, 3, 96, 130, 128, False, None, 0, False),
    "window": (1, 4, 1, 192, 192, 128, True, 50, 0, False),
    "q_offset": (2, 2, 2, 64, 192, 64, True, None, 128, False),
    "fused_aos": (1, 4, 2, 128, 128, 128, True, None, 0, True),
    "head_dim_256": (1, 2, 1, 70, 70, 256, True, None, 0, False),
    # D short of the padded width: columns past D are zero-filled
    "head_dim_96": (2, 4, 2, 150, 150, 96, True, None, 0, False),
    # served prompt lengths, off the bf16 kernel's 128-row and 64-key tiles
    "served_517": (1, 4, 1, 517, 517, 128, True, None, 0, False),
    "served_1000": (1, 4, 1, 1000, 1000, 128, True, None, 0, False),
    "q_offset_chunk": (1, 4, 1, 300, 1000, 128, True, None, 700, False),
    # gemma3's and recurrentgemma's local layers: head dim 256 with a
    # window, GQA (8 kv heads) and MQA (1)
    "window_d256_gqa8": (1, 16, 8, 300, 300, 256, True, 100, 0, False),
    "window_d256_mqa": (1, 16, 1, 300, 300, 256, True, 64, 0, False),
    # the serving shapes of seamless-m4t-medium's cross-attention (head
    # dim 64, no mask, 4096 encoder keys cut to 700), qwen1.5-4b (MHA
    # 20/20) and chatglm3-6b (GQA 32/2), cut in length
    "cross_d64_full": (1, 16, 16, 300, 700, 64, False, None, 0, False),
    "mha_20": (1, 20, 20, 300, 300, 128, True, None, 0, False),
    "gqa_32_2": (1, 32, 2, 300, 300, 128, True, None, 0, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_kernel(dev, dtype, case):
    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.attention.ops import flash_attention, mha_ref

    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, fused = \
        ATTN_CASES[case]
    q = _randn(dev, dtype, B, Hq, Sq, D, seed=1)
    if fused:
        kv = _randn(dev, dtype, B, Hkv, Skv, 2, D, seed=2)
        args, k, v = (kv, None), kv[..., 0, :], kv[..., 1, :]
    else:
        k = _randn(dev, dtype, B, Hkv, Skv, D, seed=2)
        v = _randn(dev, dtype, B, Hkv, Skv, D, seed=3)
        args = (k, v)
    before = flash_attention_cuda.launches
    got = flash_attention(q, *args, causal=causal, window=window,
                          q_offset=q_offset)
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, mha_ref(q, k, v, causal=causal, window=window,
                        q_offset=q_offset), *LM_TOL["attention"][dtype])


def test_attention_kernel_reads_strided_views(dev):
    """The model's (B, S, H, D) projections go in transposed, and the
    output is written into a (B, S, H, D) buffer, with no copy."""
    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.attention.ops import mha_ref

    q = _randn(dev, "float32", 2, 100, 4, 64, seed=1)
    k = _randn(dev, "float32", 2, 100, 2, 64, seed=2)
    v = _randn(dev, "float32", 2, 100, 2, 64, seed=3)
    out = torch.empty_like(q)
    got = flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), out=out.transpose(1, 2))
    assert got.data_ptr() == out.data_ptr()
    _close(out.transpose(1, 2), mha_ref(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2)), 1e-5)


# K7 cases: (B, S, H, P, N, chunk); 40 is a prompt shorter than one
# 64-position chunk, no multiple of the kernel's 16-row thread tile; the
# chunk lengths of the tile registry, and mamba2-130m's prompts padded to
# its chunk (640 and 1024 positions, all 24 heads).  Chunks of 256 run as
# two 128-row tiles: three chunks (S = 768), N = 64 (one slab), and L =
# 200, whose second tile is masked past row 72.
SSD_CASES = {"mamba2": (1, 512, 4, 64, 128, 128), "smoke": (2, 64, 3, 16,
                                                            16, 16),
             "ragged": (1, 40, 2, 32, 48, 40),
             "L16": (1, 256, 4, 64, 128, 16),
             "L32": (2, 256, 4, 64, 128, 32),
             "L64": (1, 256, 4, 64, 128, 64),
             "L128": (2, 256, 4, 64, 128, 128),
             "prompt_640": (1, 640, 24, 64, 128, 128),
             "prompt_1024": (1, 1024, 24, 64, 128, 128),
             "L256": (1, 768, 4, 64, 128, 256),
             "L256_N64": (2, 512, 3, 32, 64, 256),
             "L200": (1, 400, 2, 64, 128, 200)}


def _ssd_inputs(dev, dtype, B, S, H, P, N):
    g = np.random.default_rng(7)
    f = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32))
    dt = torch.from_numpy(g.uniform(1e-3, 1e-1, (B, S, H)).astype(
        np.float32))
    A = -torch.from_numpy(np.linspace(1.0, 16.0, H).astype(np.float32))
    cast = lambda t: t.to(dev).to(getattr(torch, dtype))
    return (cast(f(B, S, H, P)), dt.to(dev), A.to(dev), cast(f(B, S, N)),
            cast(f(B, S, N)))


@pytest.mark.parametrize("case", list(SSD_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel(dev, dtype, case):
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.kernels.ssd.ops import ssd, ssd_intra_chunk
    from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_intra_chunk_ref

    B, S, H, P, N, chunk = SSD_CASES[case]
    x, dt, A, Bm, C = _ssd_inputs(dev, dtype, B, S, H, P, N)
    before = ssd_intra_chunk_cuda.launches
    y, s = ssd_intra_chunk(x, dt, A, Bm, C, chunk=chunk)
    assert ssd_intra_chunk_cuda.launches == before + 1
    y_want, s_want = ssd_intra_chunk_ref(x, dt, A, Bm, C, chunk=chunk)
    assert y.dtype == x.dtype and s.dtype == torch.float32
    # float32: each output sums up to 128 terms of magnitude up to ~10 in
    # another order than the plain version (5.6e-5 at the mamba2 shape)
    _close(y, y_want, *LM_TOL["ssd y"][dtype])
    _close(s, s_want, *LM_TOL["ssd states"][dtype])
    # the whole SSD against the chunked form, which keeps y_intra float32
    tol = _tol(dtype, f32=2e-4)
    got, state = ssd(x, dt, A, Bm, C, chunk=chunk)
    want, want_state = ssd_chunked(x, dt, A, Bm, C, chunk=chunk)
    _close(got, want, tol)
    _close(state, want_state, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_chunk_256_under_a_tile_scope(dev, dtype):
    """``ssd(...)`` with the chunk from ``tile_scope({"ssd": 256})``
    launches K7 and matches ``ssd_chunked``; K7's outputs stay within their
    limits, and a deliberately wrong K7, one that drops what query tile 1
    takes from key tile 0 (it equals y_intra at chunk 128, and the states
    of each chunk's second half), falls outside them."""
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_intra_chunk_ref
    from repro_torch.tuning.tiles import tile_scope

    x, dt, A, Bm, C = _ssd_inputs(dev, dtype, 1, 512, 4, 64, 128)
    before = ssd_intra_chunk_cuda.launches
    with tile_scope({"ssd": 256}):
        got, state = ssd(x, dt, A, Bm, C)
    assert ssd_intra_chunk_cuda.launches == before + 1
    want, want_state = ssd_chunked(x, dt, A, Bm, C, chunk=256)
    tol = _tol(dtype, f32=2e-4)
    _close(got, want, tol)
    _close(state, want_state, tol)
    y, s = ssd_intra_chunk_cuda(x, dt, A, Bm, C, chunk=256)
    y_want, s_want = ssd_intra_chunk_ref(x, dt, A, Bm, C, chunk=256)
    _close(y, y_want, *LM_TOL["ssd y"][dtype])
    _close(s, s_want, *LM_TOL["ssd states"][dtype])
    y_half, s_half = ssd_intra_chunk_ref(x, dt, A, Bm, C, chunk=128)
    for wrong, want_, lim in ((y_half, y_want, LM_TOL["ssd y"][dtype]),
                              (s_half[:, 1::2], s_want,
                               LM_TOL["ssd states"][dtype])):
        with pytest.raises(AssertionError):
            _close(wrong, want_, *lim)


def test_lm_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda

    q = torch.ones(1, 2, 8, 512, device=dev)
    with pytest.raises(RuntimeError, match="invalid argument"):   # D > 256
        flash_attention_cuda(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_cuda(q, q.bfloat16(), q)
    # bfloat16 on the tensor cores: an s-stride of 132 elements
    kv = torch.ones(1, 2, 8, 128, device=dev, dtype=torch.bfloat16)
    qs = torch.ones(1, 2, 8, 132, device=dev, dtype=torch.bfloat16)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention_cuda(qs[..., :128], kv, kv)
    assert flash_attention_cuda.launches == before
    x, dt, A, Bm, C = _ssd_inputs(dev, "float32", 1, 512, 2, 64, 128)
    with pytest.raises(RuntimeError, match="invalid argument"):   # L > 256
        ssd_intra_chunk_cuda(x, dt, A, Bm, C, chunk=512)
    with pytest.raises(TypeError, match="float32"):
        ssd_intra_chunk_cuda(x, dt.bfloat16(), A, Bm, C, chunk=128)
    # bfloat16 on the tensor cores: N off the multiples of 8, or a base off
    # the 16-byte grid
    x, dt, A, Bm, C = _ssd_inputs(dev, "bfloat16", 1, 256, 2, 64, 132)
    before = ssd_intra_chunk_cuda.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        ssd_intra_chunk_cuda(x, dt, A, Bm[..., :124].contiguous(),
                             C[..., :124].contiguous(), chunk=128)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        ssd_intra_chunk_cuda(x, dt, A, Bm.flatten()[4:4 + 256 * 128].view(
            1, 256, 128), C[..., :128].contiguous(), chunk=128)
    assert ssd_intra_chunk_cuda.launches == before


# -- the measured autotuner on the card --------------------------------------------

def _particle_inputs(dev, n):
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC

    f = workloads.particle_fields(n)
    return {k: RecordArray.from_fields(
        spec, {name: torch.from_numpy(v).to(dev)
               for name, v in f[k].items()}, lay)
        for k, spec, lay in (("ions", PARTICLE_SPEC, Layout.AOS),
                             ("electrons", PARTICLE_SPEC, Layout.AOSOA),
                             ("field", SAXPY_SPEC, Layout.SOA))}


def test_tuned_particle_graph_on_the_card_equals_heuristic(dev, tmp_path,
                                                          monkeypatch):
    """Tuning on the card commits whatever its timings say; the state is
    the heuristic plan's bits whichever layouts and tiles win."""
    from repro_torch.tuning import cache as tune_cache
    from repro_torch.tuning import search as tune_search

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path))
    tune_cache.clear_memo()
    n, steps = 1 << 16, 3
    g, _, _ = workloads.build_particle_graph(n, block=None)
    inputs = _particle_inputs(dev, n)
    tuned = Executor(g, tune="auto", tune_inputs=inputs)
    dec = tuned.plan.tuning
    assert dec.source == "measured" and dec.measured >= 2
    base = Executor(g)
    want = base.run(base.init_state(**inputs), steps)
    got = tuned.run(tuned.init_state(**inputs), steps)
    for name in ("ions", "electrons", "field"):
        t = base.tensors[name]
        for f in t.spec.names:
            assert torch.equal(tuned.read(got, t).field(f),
                               base.read(want, t).field(f)), (name, f)
    assert torch.equal(got["vmax"], want["vmax"])
    before = tune_search.STATS["measurements"]
    assert Executor(g, tune="auto").plan.tuning.source == "cache"
    assert tune_search.STATS["measurements"] == before
    tune_cache.clear_memo()


def _chip_phase_tiles():
    """Every (kernel, tile) the registry offers at the chip phase's
    shapes: K2 and K3 over 2^24 cells, K5 on a 4096 x 4096 interior."""
    from repro_torch.kernels.eikonal.kernel import \
        tile_candidates as eikonal_tiles
    from repro_torch.kernels.particle.kernel import \
        tile_candidates as particle_tiles
    from repro_torch.kernels.saxpy.kernel import \
        tile_candidates as saxpy_tiles

    return ([("saxpy_record", b) for b in saxpy_tiles((1 << 24,))]
            + [("particle_update", b) for b in particle_tiles((1 << 24,))]
            + [("eikonal_fim", t) for t in eikonal_tiles((4096, 4096))])


@pytest.mark.parametrize("kernel,tile", _chip_phase_tiles())
def test_registry_tiles_launch_at_the_chip_phase_shapes(dev, kernel, tile):
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda
    from repro_torch.kernels.eikonal.ops import eikonal_fim_ref
    from repro_torch.kernels.particle.kernel import particle_update_cuda
    from repro_torch.kernels.particle.ops import (PARTICLE_SPEC,
                                                  particle_update_ref)
    from repro_torch.kernels.saxpy.kernel import saxpy_record_cuda
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC, saxpy_record_ref

    if kernel == "eikonal_fim":
        n = 4096
        phi, mask = _eikonal_state(dev, n, "float32", iters=1)
        got = eikonal_fim_cuda(phi, mask, 1 / n, inner=4, block=tile)
        want = eikonal_fim_ref(phi, mask, 1 / n, inner=4, block=tile)
        _close(got, want, 1e-5)
        return
    n = 1 << 24
    wrapper, ref, spec = {
        "saxpy_record": (saxpy_record_cuda, saxpy_record_ref, SAXPY_SPEC),
        "particle_update": (particle_update_cuda, particle_update_ref,
                            PARTICLE_SPEC)}[kernel]
    for lay in (Layout.AOS, Layout.SOA, Layout.AOSOA):
        rec = RecordArray(_randn(dev, "float32", spec.num_components, n),
                          spec, Layout.SOA).with_layout(lay)
        before = wrapper.launches
        got = wrapper(rec, workloads.DT, block=tile)
        assert wrapper.launches == before + 1
        _close(got.data, ref(rec, workloads.DT).data, 1e-5)


# -- region compile: K1-K5 inside captured CUDA graphs ----------------------------

def _region_case(name, dev):
    """``(graph, make_state(ex, seed), run(ex, state), wrappers)`` of one
    main-path graph at a small size, its inputs from ``default_rng``."""
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda
    from repro_torch.kernels.particle.kernel import particle_update_cuda
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC
    from repro_torch.kernels.saxpy.kernel import (saxpy_cuda,
                                                  saxpy_record_cuda)
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC
    from repro_torch.kernels.stencil.kernel import flux_difference_cuda
    from repro_torch.physics.euler import shock_bubble_init

    n, grid = 1 << 16, 128

    def rng(seed):
        return np.random.default_rng(seed)

    if name == "saxpy":
        g, _ = workloads.build_saxpy_graph(n, 2.0)
        return (g, lambda ex, s: ex.init_state(x=torch.from_numpy(
                    rng(s).standard_normal(n, dtype=np.float32))),
                lambda ex, st: ex.run(st, 3), (saxpy_cuda,))
    if name == "particle":
        g, _, _ = workloads.build_particle_graph(n)
        specs = {"ions": (PARTICLE_SPEC, Layout.AOS),
                 "electrons": (PARTICLE_SPEC, Layout.AOSOA),
                 "field": (SAXPY_SPEC, Layout.SOA)}

        def make(ex, s):
            f = workloads.particle_fields(n, s)
            return ex.init_state(**{
                k: RecordArray.from_fields(
                    sp, {fn: torch.from_numpy(v) for fn, v in
                         f[k].items()}, lay)
                for k, (sp, lay) in specs.items()})

        return (g, make, lambda ex, st: ex.run(st, 3),
                (particle_update_cuda, saxpy_record_cuda))
    if name == "flux":
        g, _ = workloads.build_flux_graph(grid, grid, lam_y=0.05)
        u0 = shock_bubble_init(grid, grid, device="cpu")

        def make(ex, s):
            noise = rng(s).standard_normal(tuple(u0.shape), dtype=np.float32)
            return ex.init_state(u=u0 + 0.01 * torch.from_numpy(noise))

        return g, make, lambda ex, st: ex.run(st, 3), (flux_difference_cuda,)
    g, _, _ = workloads.build_eikonal_graph(grid, block=(8, 128),
                                            max_iters=4 * grid)
    inp = workloads.eikonal_inputs(grid)

    def make(ex, s):
        phi = np.where(inp["mask"], 0.0,
                       1e3 * rng(s).uniform(0.5, 1.0, inp["phi"].shape))
        return ex.init_state(phi=phi.astype(np.float32), mask=inp["mask"])

    return g, make, lambda ex, st: ex(st), (eikonal_fim_cuda,)


def _bitwise(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("graph", ["particle", "flux"])
def test_returned_state_contract_at_the_defaults_on_the_card(dev, graph):
    """``Executor(g)`` captures and donates; ``a = ex.run(s0, 1);
    ex.run(s0, 2)`` leaves ``a`` as it was (moved onto a copy before the
    replay writes the buffers), a state passed back is taken without a
    copy, and a second executor of the signature replays the first's
    graphs: all bit for bit ``regions=False``."""
    g, make, _, _ = _region_case(graph, dev)
    ex = Executor(g)
    assert ex.regions and ex.donate
    eager = Executor(g, regions=False)
    s0 = make(ex, 0)
    want1 = eager.run(make(eager, 0), 1)
    want2 = eager.run(make(eager, 0), 2)
    a = ex.run(s0, 1)
    a_was = {k: v.clone() for k, v in a.items()}
    b = ex.run(s0, 2)
    _bitwise(a, a_was)
    _bitwise(a, want1)
    _bitwise(b, want2)
    assert ex.cache_stats()["moved_out"] == len(a)
    c = ex.run(b, 1)
    assert all(c[k] is b[k] for k in b)
    _bitwise(c, eager.run(want2, 1))
    two = Executor(g)
    before = two.cache_stats()["trace_events"]
    _bitwise(two.run(make(two, 0), 1), want1)
    assert two.cache_stats()["trace_events"] == before == 1
    _bitwise(a, want1)


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("graph", ["saxpy", "particle", "flux", "eikonal"])
def test_region_graphs_replay_the_kernels(dev, graph, donate):
    """The first call runs the region eagerly and captures it; later calls
    replay the graph — the kernels' wrappers are not called, yet a state
    from another seed gives the eager result on it, so the ctypes launches
    were recorded, not just run once.  Steady state and a second executor
    make no capture."""
    from repro_torch.core import clear_executable_cache

    clear_executable_cache()
    g, make, run, wrappers = _region_case(graph, dev)
    eager = Executor(g, regions=False)
    ex = Executor(g, regions=True, donate=donate)
    _bitwise(run(ex, make(ex, 0)), run(eager, make(eager, 0)))
    stats = ex.cache_stats()
    assert stats["trace_events"] >= 1
    for seed in (1, 2):
        want = run(eager, make(eager, seed))
        before = [w.launches for w in wrappers]
        got = run(ex, make(ex, seed))
        assert [w.launches for w in wrappers] == before
        _bitwise(got, want)
    # the returned states a new input moved out are counted apart
    assert {k: v for k, v in ex.cache_stats().items()
            if not k.startswith("moved_out")} == \
        {k: v for k, v in stats.items() if not k.startswith("moved_out")}
    del ex, got           # a donating executor's lease ends with it
    second = Executor(g, regions=True, donate=donate)
    _bitwise(run(second, make(second, 1)), run(eager, make(eager, 1)))
    assert second.cache_stats()["trace_events"] == stats["trace_events"]
    clear_executable_cache()


def test_host_syncing_node_fails_at_capture_with_its_name(dev):
    from repro_torch.core import DistTensor, Graph, clear_executable_cache

    u = DistTensor("u", (1024,))
    g = Graph(name="sync_inside")
    g.split(lambda x: x * float(x.sum()), u, writes=(0,))
    name = g.levels[0][0].name
    ex = Executor(g, regions=True)
    with pytest.raises(RuntimeError, match=f"capture failed in node "
                                           f"'{name}'"):
        ex(ex.init_state(u=torch.ones(1024)))
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    x = torch.ones(4, device=dev)
    assert float((x + 1).sum()) == 8.0
    clear_executable_cache()


@pytest.mark.parametrize("shape", ["one piece", "two regions"])
def test_donated_buffers_passed_back_swapped_on_the_card(dev, shape):
    """A donated state's buffers handed back under each other's keys, and
    one of them beside a fresh tensor: the captured graphs read the values
    given, as the eager executor does."""
    from repro_torch.core import DistTensor, Graph, clear_executable_cache

    clear_executable_cache()
    a, b = DistTensor("a", (4096,)), DistTensor("b", (4096,))
    g = Graph(name=f"two keys {shape}")
    if shape == "one piece":
        g.then(lambda x, y: (x - 3.0, y * 2.0 + 1.0), args=(a, b),
               writes=(0, 1))
    else:
        g.split(lambda y: y * 2.0 + 1.0, b, writes=(0,))
        g.sync()
        g.split(lambda x: x - 3.0, a, writes=(0,))
    ex = Executor(g, regions=True, donate=True)
    eager = Executor(g, regions=False)
    x0 = torch.arange(4096.0, device=dev)
    st = ex(ex.init_state(a=x0, b=-x0))
    for inp in ({"a": st["b"], "b": st["a"]},
                {"a": st["b"], "b": torch.full_like(x0, 7.0)}):
        want = eager({k: v.clone() for k, v in inp.items()})
        st = ex(inp)
        _bitwise(st, want)
    clear_executable_cache()


# -- async regions: host callbacks on the pool beside captured graphs ----------

def _read_then_double(seen, sleep_s=0.0):
    """x += 1; a host read of x (sleeping first, so that later steps are
    dispatched meanwhile); x *= 2: each callback must see its own step."""
    import threading
    import time

    from repro_torch.core import DistTensor, ExecutionKind, Graph

    def read(v):
        time.sleep(sleep_s)
        seen.append((float(v[0]), threading.current_thread().name,
                     torch.cuda.current_stream()))

    x = DistTensor("x", (1 << 20,))
    g = Graph(name="async_read")
    g.split(lambda v: v + 1.0, x, writes=(0,))
    g.then(read, exec_kind=ExecutionKind.Cpu, args=(x,))
    g.then_split(lambda v: v * 2.0, x, writes=(0,))
    return g


@pytest.mark.parametrize("donate", [False, True])
def test_async_callbacks_read_snapshots_of_their_step(dev, donate):
    """The next replay overwrites the argument's static buffer in place
    while a callback still sleeps: the callback reads the clone made at
    submit time, under either ``donate``."""
    from repro_torch.core import clear_executable_cache

    clear_executable_cache()
    seen = []
    ex = Executor(_read_then_double(seen, sleep_s=0.01), regions=True,
                  donate=donate)
    st = ex.run(ex.init_state(), 5)
    assert [v for v, _, _ in seen] == [1.0, 3.0, 7.0, 15.0, 31.0]
    assert torch.equal(st["x"], torch.full((1 << 20,), 62.0, device=dev))
    assert ex.async_stats["snapshot_bytes"] == 5 * 4 * (1 << 20)
    assert ex.async_stats["peak_inflight"] >= 2
    clear_executable_cache()


def test_async_callback_reads_on_its_threads_side_stream(dev):
    """A callback runs on a ``ripple-host`` thread under the executor's
    device, on the call's side stream: not the dispatching stream, not
    the legacy default stream, so its read does not queue behind later
    steps."""
    from repro_torch.core import clear_executable_cache

    clear_executable_cache()
    seen = []
    ex = Executor(_read_then_double(seen), regions=True)
    ex.run(ex.init_state(), 3)
    main = torch.cuda.current_stream()
    for _, thread, stream in seen:
        assert thread.startswith("ripple-host")
        assert stream != main and stream != torch.cuda.default_stream()
    clear_executable_cache()


@pytest.mark.parametrize("donate", [False, True])
def test_async_capture_with_a_callback_in_flight(dev, donate):
    """The particle step with a host diagnostic from a cold cache: its
    second piece is captured while the first callback is in flight (the
    dispatcher drains it first), and the state and the log equal the
    synchronous and the eager runs'."""
    import time

    from repro_torch.core import clear_executable_cache
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC

    n = 1 << 16
    f = workloads.particle_fields(n, 0)
    specs = {"ions": (PARTICLE_SPEC, Layout.AOS),
             "electrons": (PARTICLE_SPEC, Layout.AOSOA),
             "field": (SAXPY_SPEC, Layout.SOA)}
    init = {k: RecordArray.from_fields(
        sp, {fn: torch.from_numpy(v) for fn, v in f[k].items()}, lay)
        for k, (sp, lay) in specs.items()}
    runs = {}
    for mode in ("async", "sync", "eager"):
        log = []

        def record(t, v, log=log):
            time.sleep(0.05)
            log.append((t, v))

        g, _, _ = workloads.build_particle_diagnostic_graph(n, record)
        clear_executable_cache()
        ex = (Executor(g, regions=False) if mode == "eager" else
              Executor(g, regions=True, donate=donate,
                       async_regions=mode == "async"))
        st = ex.run(ex.init_state(**init), 4)
        runs[mode] = (st, log, ex)
    st, log, ex = runs["async"]
    assert ex.async_stats["barrier_drains"] == 1
    assert ex.cache_stats()["trace_events"] == 2
    for mode in ("sync", "eager"):
        _bitwise(st, runs[mode][0])
        assert log == runs[mode][1]
    clear_executable_cache()


def test_async_watchdog_on_the_card(dev):
    """A callback hung past ``host_timeout`` raises HostTimeoutError within
    the limit and a little; the next call equals the first, with no new
    capture."""
    import time

    from repro_torch.core import HostTimeoutError, clear_executable_cache
    from repro_torch.runtime.faults import Fault, FaultPlan, fault_scope

    clear_executable_cache()
    seen = []
    ex = Executor(_read_then_double(seen), regions=True, host_timeout=0.3)
    want = ex.run(ex.init_state(), 3)
    caps = ex.cache_stats()["trace_events"]
    plan = FaultPlan([Fault("executor.host", nth=0, kind="delay",
                            delay_s=1.5)])
    t0 = time.perf_counter()
    with fault_scope(plan):
        with pytest.raises(HostTimeoutError):
            ex.run(ex.init_state(), 3)
    assert time.perf_counter() - t0 < 1.0
    _bitwise(ex.run(ex.init_state(), 3), want)
    assert ex.cache_stats()["trace_events"] == caps
    clear_executable_cache()


# -- a mesh of shards on one card ---------------------------------------------

@pytest.mark.parametrize("layout", [Layout.AOS, Layout.SOA])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 2048), (2046, 1), (1, 130),
                                   (37, 1), (1, 1)])
def test_flux_kernel_on_thin_strips(dev, layout, dtype, shape):
    """The boundary strips of the overlapped lowering: 1-row and
    1-column interiors (K4's 4-row strips and 32-column warps mostly
    masked), on the tile a graph node takes for them."""
    from repro_torch.kernels.stencil.ops import (fitting_block,
                                                 flux_difference,
                                                 flux_difference_ref)
    from repro_torch.physics.euler import EULER_SPEC

    g = torch.Generator(device=dev).manual_seed(7)
    u = 1.0 + torch.rand(4, shape[0] + 2, shape[1] + 2, generator=g,
                         device=dev)
    rec = RecordArray(u.to(getattr(torch, dtype)), EULER_SPEC,
                      Layout.SOA).with_layout(layout)
    got = flux_difference(rec, 0.1, 0.2, block=fitting_block(shape))
    assert got.layout is layout and got.space == shape
    _close(got.data, flux_difference_ref(rec, 0.1, 0.2).data,
           _tol(dtype, f32=1e-4))


def _card_mesh(shape, names):
    from repro_torch.core import make_mesh

    return make_mesh(shape, names, devices=["cuda:0"] * int(np.prod(shape)))


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("layout", [Layout.AOS, Layout.SOA])
def test_mesh_flux_on_the_card_is_bitwise_the_unsharded_run(dev, layout,
                                                            overlap):
    """Four shards on cuda:0: K4 once per shard a step (sync), or on each
    shard's interior and its four strips (overlap, the blocks copied on
    the copy stream), equal to the unsharded K4 run bit for bit."""
    from repro_torch.kernels.stencil.kernel import flux_difference_cuda
    from repro_torch.physics.euler import shock_bubble_init

    mesh = _card_mesh((2, 2), ("gx", "gy"))
    g, (_, out) = workloads.build_flux_graph(128, 256, layout=layout,
                                             mesh=mesh, overlap=overlap)
    g0, _ = workloads.build_flux_graph(128, 256, layout=layout)
    u0 = shock_bubble_init(128, 256, device=dev)
    ex = Executor(g, mesh=mesh, regions=False)
    ex0 = Executor(g0, regions=False)
    want = ex0.read(ex0.run(ex0.init_state(u=u0), 3), out).data
    flux_difference_cuda.launches = 0
    got = ex.read(ex.run(ex.init_state(u=u0), 3), out).data
    assert flux_difference_cuda.launches == 3 * 4 * (5 if overlap else 1)
    assert torch.equal(got, want)
    assert not ex.plan.overlap_fallbacks


def test_mesh_eikonal_solve_on_the_card_is_bitwise_the_unsharded_one(dev):
    """K5 once per shard an iteration; shards that are tile multiples
    freeze the same halo cells as the unsharded solve: same iterations,
    phi bit for bit."""
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda

    inp = workloads.eikonal_inputs(256)
    init = {k: torch.from_numpy(v) for k, v in inp.items()}
    runs = {}
    for mesh in (None, _card_mesh((2, 2), ("gx", "gy"))):
        g, (phi, _), conv = workloads.build_eikonal_graph(
            256, inner=4, block=(8, 128), mesh=mesh, max_iters=1024)
        ex = Executor(g, mesh=mesh, regions=False)
        eikonal_fim_cuda.launches = 0
        st = ex(ex.init_state(**init))
        runs[mesh is None] = (ex.read(st, phi), conv.iterations,
                              eikonal_fim_cuda.launches)
    (got, iters, launches), (want, iters0, launches0) = runs[False], \
        runs[True]
    assert iters == iters0 > 0
    assert launches == 4 * iters and launches0 == iters0
    assert torch.equal(got, want)


@pytest.mark.parametrize("unsplit", [False, True])
def test_mesh_euler_solver_on_the_card(dev, unsplit):
    from repro_torch.physics.euler import shock_bubble_init

    u0 = shock_bubble_init(128, 64, device=dev)
    ex0, u = workloads.build_euler_solver(128, 64, unsplit=unsplit)
    want = ex0.run(ex0.init_state(u=u0), 5)
    for mesh, overlap in ((_card_mesh((4,), ("gy",)), False),
                          (_card_mesh((2, 2), ("gx", "gy")), True)):
        ex, u = workloads.build_euler_solver(128, 64, mesh=mesh,
                                             overlap=overlap,
                                             unsplit=unsplit)
        got = ex.run(ex.init_state(u=u0), 5)
        torch.testing.assert_close(ex.read(got, u).data,
                                   ex0.read(want, u).data, rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(got["smax"], want["smax"])


def test_make_mesh_on_the_card(dev):
    from repro_torch.core import make_mesh

    k = torch.cuda.device_count()
    assert make_mesh((k,), ("d",)).devices[-1] == torch.device("cuda", k - 1)
    with pytest.raises(RuntimeError, match="needs"):
        make_mesh((k + 1,), ("d",))
    with pytest.raises(RuntimeError, match="does not exist"):
        make_mesh((1,), ("d",), devices=[f"cuda:{k}"])


# -- outputs written in place: out= on the card, regions on a mesh ------------

@pytest.mark.parametrize("layout", list(Layout))
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_write_out_and_in_place_bit_for_bit(dev, dtype, layout):
    """K1-K3 with ``out`` apart from their inputs and ``out`` the updated
    input itself (their CUDA pointers carry no ``__restrict__``), K4 and K5
    with ``out`` apart: each bit for bit the fresh-output call."""
    from repro_torch.kernels.particle.kernel import particle_update_cuda
    from repro_torch.kernels.particle.ops import PARTICLE_SPEC
    from repro_torch.kernels.saxpy.kernel import (saxpy_cuda,
                                                  saxpy_record_cuda)
    from repro_torch.kernels.saxpy.ops import SAXPY_SPEC

    x = _randn(dev, dtype, 2**20 + 3, seed=1)
    y = _randn(dev, dtype, 2**20 + 3, seed=2)
    want = saxpy_cuda(1.75, x, y)
    out = torch.empty_like(y)
    assert saxpy_cuda(1.75, x, y, out=out) is out
    assert torch.equal(out, want)
    assert saxpy_cuda(1.75, x, y, out=y) is y
    assert torch.equal(y, want)
    for fn, spec, c in ((saxpy_record_cuda, SAXPY_SPEC, 2),
                        (particle_update_cuda, PARTICLE_SPEC, 6)):
        rec = RecordArray(_randn(dev, dtype, c, 2**16, seed=3), spec,
                          Layout.SOA).with_layout(layout)
        want = fn(rec, 0.01)
        apart = RecordArray(torch.empty_like(rec.data), spec, layout)
        assert fn(rec, 0.01, out=apart) is apart
        assert torch.equal(apart.data, want.data)
        assert fn(rec, 0.01, out=rec) is rec
        assert torch.equal(rec.data, want.data)


@pytest.mark.parametrize("dtype", DTYPES)
def test_stencil_kernels_write_out_bit_for_bit(dev, dtype):
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda
    from repro_torch.kernels.stencil.kernel import flux_difference_cuda
    from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init

    u = shock_bubble_init(256, 384, device=dev).to(getattr(torch, dtype))
    for ax in (1, 2):
        u = pad_boundary_only(u, axis=ax, width=1,
                              boundary=Boundary.TRANSMISSIVE)
    for layout in (Layout.AOS, Layout.SOA):
        rec = RecordArray(u, EULER_SPEC, Layout.SOA).with_layout(layout)
        want = flux_difference_cuda(rec, 0.1, 0.05)
        out = RecordArray(torch.empty_like(want.data), EULER_SPEC, layout)
        assert flux_difference_cuda(rec, 0.1, 0.05, out=out) is out
        assert torch.equal(out.data, want.data)
        with pytest.raises(ValueError, match="overlaps an input"):
            flux_difference_cuda(rec, 0.1, 0.05, out=RecordArray(
                rec.data.reshape(-1)[:want.data.numel()].view(
                    want.data.shape), EULER_SPEC, layout))
    g = torch.Generator(device=dev).manual_seed(4)
    phi = torch.rand(258, 514, generator=g, device=dev).to(
        getattr(torch, dtype))
    mask = torch.rand(256, 512, generator=g, device=dev) < 0.05
    want = eikonal_fim_cuda(phi, mask, 1 / 256, inner=4, block=(8, 128))
    out = torch.empty_like(want)
    assert eikonal_fim_cuda(phi, mask, 1 / 256, inner=4, block=(8, 128),
                            out=out) is out
    assert torch.equal(out, want)


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
def test_region_capture_on_a_one_card_mesh(dev, overlap, donate):
    """Four shards of cuda:0 under ``regions=True``: the step is one
    captured graph holding every shard's K4 (and, overlapped, the copy
    stream's block copies as branches), bit for bit the eager mesh run;
    later calls replay it without calling the wrapper."""
    from repro_torch.core import clear_executable_cache
    from repro_torch.kernels.stencil.kernel import flux_difference_cuda
    from repro_torch.physics.euler import shock_bubble_init

    clear_executable_cache()
    mesh = _card_mesh((2, 2), ("gx", "gy"))
    g, (_, out) = workloads.build_flux_graph(128, 256, mesh=mesh,
                                             overlap=overlap)
    u0 = shock_bubble_init(128, 256, device=dev)
    eager = Executor(g, mesh=mesh, regions=False)
    want = eager.read(eager.run(eager.init_state(u=u0), 3), out).data
    ex = Executor(g, mesh=mesh, regions=True, donate=donate)
    got = ex.read(ex.run(ex.init_state(u=u0), 3), out).data
    assert torch.equal(got, want)
    stats = ex.cache_stats()
    assert stats["trace_events"] == 1 and stats["copy_backs"] == 0
    flux_difference_cuda.launches = 0
    got = ex.read(ex.run(ex.init_state(u=u0), 3), out).data
    assert flux_difference_cuda.launches == 0
    assert torch.equal(got, want)
    assert ex.cache_stats() == stats
    clear_executable_cache()


# -- K6 and K7 with a gradient: their backward is the plain version's -------

@pytest.mark.parametrize("case", ["causal_gqa", "window", "q_offset"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_fn_gradient_is_the_plain_versions(dev, dtype, case):
    """``FlashAttentionFn``: the forward is K6 (one launch), and the input
    gradients for a given ``grad_out`` equal the plain version's bit for
    bit, since the backward recomputes that same plain function."""
    from functools import partial

    from repro_torch.kernels.attention.kernel import (flash_attention_cuda,
                                                      flash_attention_fn)
    from repro_torch.models.attention import attention

    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, _ = ATTN_CASES[case]
    qpos = torch.arange(q_offset, q_offset + Sq, device=dev)
    kpos = torch.arange(Skv, device=dev)
    plain = partial(attention, qpos=qpos, kpos=kpos, causal=causal,
                    window=window, q_chunk=64, k_chunk=64, use_kernel=False)
    ins = [_randn(dev, dtype, B, S, H, D, seed=i) for i, (S, H) in
           enumerate(((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))]
    grad_out = _randn(dev, dtype, B, Sq, Hq, D, seed=9)
    mine = [t.clone().requires_grad_() for t in ins]
    before = flash_attention_cuda.launches
    out = flash_attention_fn(*mine, plain=plain, causal=causal,
                             window=window, q_offset=q_offset)
    assert flash_attention_cuda.launches == before + 1
    out.backward(grad_out)
    theirs = [t.clone().requires_grad_() for t in ins]
    want = plain(*theirs)
    want.backward(grad_out)
    _close(out.detach(), want.detach(), *LM_TOL["attention"][dtype])
    for a, b in zip(mine, theirs):
        assert torch.equal(a.grad, b.grad)
        assert float(a.grad.float().abs().max()) > 0


@pytest.mark.parametrize("case", ["mamba2", "smoke", "L256"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_fn_gradient_is_the_plain_versions(dev, dtype, case):
    """``SsdIntraChunkFn`` (what ``ssd_intra_chunk`` runs on the card):
    the forward is K7, and the input gradients for given output gradients
    equal ``ssd_intra_chunk_ref``'s bit for bit."""
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.kernels.ssd.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

    B, S, H, P, N, chunk = SSD_CASES[case]
    ins = _ssd_inputs(dev, dtype, B, S, H, P, N)
    gy = _randn(dev, dtype, B, S, H, P, seed=8)
    gs = _randn(dev, "float32", B, S // chunk, H, P, N, seed=9)
    mine = [t.clone().requires_grad_() for t in ins]
    before = ssd_intra_chunk_cuda.launches
    y, s = ssd_intra_chunk(*mine, chunk=chunk)
    assert ssd_intra_chunk_cuda.launches == before + 1
    torch.autograd.backward((y, s), (gy, gs))
    theirs = [t.clone().requires_grad_() for t in ins]
    torch.autograd.backward(ssd_intra_chunk_ref(*theirs, chunk=chunk),
                            (gy, gs))
    for a, b in zip(mine, theirs):
        assert torch.equal(a.grad, b.grad)
        assert float(a.grad.float().abs().max()) > 0


def test_wrappers_refuse_an_input_that_requires_grad(dev):
    """A wrapper handed an input that requires grad under grad mode raises,
    naming the Function to call: no route drops a gradient silently."""
    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda

    q = _randn(dev, "bfloat16", 1, 2, 64, 64, seed=1)
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        flash_attention_cuda(q.clone().requires_grad_(), q, q)
    x, dt, A, Bm, C = _ssd_inputs(dev, "bfloat16", 1, 64, 2, 64, 128)
    with pytest.raises(RuntimeError, match="SsdIntraChunkFn"):
        ssd_intra_chunk_cuda(x, dt, A, Bm.clone().requires_grad_(), C,
                             chunk=64)
    with torch.no_grad():
        flash_attention_cuda(q.clone().requires_grad_(), q, q)
        ssd_intra_chunk_cuda(x, dt, A, Bm.clone().requires_grad_(), C,
                             chunk=64)


def test_gemma3_captured_decode_with_a_wrapping_ring_is_the_eager_one(dev):
    """gemma3-12b's smoke config with window 4 served by the ``Batcher``
    on the card: prompts of 3-6 tokens and 6 new ones wrap every local
    layer's ring.  The decode captured once (``regions=True, donate=True``)
    gives the eager (``regions=False``) run's streams, and its final
    decode state bit for bit."""
    import repro_torch.configs as configs
    from repro_torch.models.lm import init_lm
    from repro_torch.runtime.batcher import Batcher

    cfg = configs.get_smoke("gemma3-12b").with_(window=4)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (3, 6, 5, 4)]

    def serve(opts):
        b = Batcher(cfg, params, batch=2, max_seq=16, executor_opts=opts,
                    log=lambda *_: None)
        reqs = [b.submit(p, max_new_tokens=6) for p in prompts]
        b.run()
        return [r.generated for r in reqs], b

    eager, be = serve({"regions": False})
    got, bc = serve({})
    assert bc.executor.regions and bc.executor.donate
    assert bc.cache_stats()["decode"]["trace_events"] == 1
    assert got == eager
    assert set(bc.state) == set(be.state)
    for k in be.state:
        assert torch.equal(bc.state[k], be.state[k]), k


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_encdec_and_vlm_prefill_run_k6_at_every_attention_layer(dev, arch):
    """The smoke configs' prefill on the card: K6 once per encoder layer,
    decoder self-attention and cross-attention (seamless: 2 + 2 + 2), or
    per layer over patches and text (llava: 2), its logits within 1e-4
    of the plain route's; the uniform loop's streams equal the plain
    route's."""
    import repro_torch.configs as configs
    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.launch.serve import legacy_generate
    from repro_torch.models.lm import init_lm, prefill

    cfg = configs.get_smoke(arch)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 12)).astype(
        np.int32)).to(dev)
    fr = ({"frames": torch.from_numpy(rng.standard_normal(
        (2, 40, cfg.frontend_dim)).astype(np.float32)).to(dev)}
        if cfg.is_encdec else {"patches": torch.from_numpy(
            rng.standard_normal((2, cfg.frontend_tokens, cfg.frontend_dim))
            .astype(np.float32)).to(dev)})
    max_seq = 20 + cfg.frontend_tokens
    flash_attention_cuda.launches = 0
    got, _ = prefill(params, {"tokens": toks, **fr}, cfg, max_seq=max_seq)
    per = cfg.n_layers * (2 if cfg.is_encdec else 1) + cfg.enc_layers
    assert flash_attention_cuda.launches == per
    want, _ = prefill(params, {"tokens": toks, **fr}, cfg, max_seq=max_seq,
                      use_kernel=False)
    _close(got, want, 1e-4)
    a, _, _ = legacy_generate(cfg, params, toks, 6, max_seq, **fr)
    b, _, _ = legacy_generate(cfg, params, toks, 6, max_seq,
                              use_kernel=False, **fr)
    assert (a == b).all()


# -- the MoE FFN on the card ---------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_block_on_the_card_matches_the_cpu(dev, dtype, dropless):
    """``moe_block`` on the card against the same call on the CPU, at
    capacity factor 1.0 (pairs dropped) and dropless: the same routing
    (float32 router on both), the output within the dtype's limit, the
    load-balance loss at 1e-5."""
    from repro_torch.models.common import Init, ParamModule
    from repro_torch.models.moe import init_moe, moe_block

    dt = getattr(torch, dtype)
    p = ParamModule()
    init_moe(Init(torch.Generator().manual_seed(0), dt, "cpu"), p,
             d_model=64, d_ff=128, n_experts=8)
    cpu = {k: v.detach() for k, v in p["moe"].named_parameters()}
    card = {k: v.to(dev) for k, v in cpu.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (96, 64)).astype(np.float32)).to(dt)
    kw = dict(top_k=2, capacity_factor=1.0, dropless=dropless)
    got, aux = moe_block(card, x.to(dev), **kw)
    want, want_aux = moe_block(cpu, x, **kw)
    assert got.dtype == dt and got.device.type == "cuda"
    _close(got, want, _tol(dtype))
    _close(aux, want_aux, 1e-5)


def test_moe_smoke_decode_is_captured_once(dev):
    """phi3.5-moe's smoke config served on the card by the default
    ``Batcher``: the dropless decode step (sort, gathers, batched expert
    products) captured once and replayed, its streams those of the eager
    (``regions=False``) batcher."""
    import repro_torch.configs as configs
    from repro_torch.models.lm import init_lm
    from repro_torch.runtime.batcher import Batcher

    cfg = configs.get_smoke("phi3.5-moe").with_(capacity_factor=1.0)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (3, 16, 5, 12)]

    def serve(opts):
        b = Batcher(cfg, params, batch=2, max_seq=28, executor_opts=opts,
                    log=lambda *_: None)
        reqs = [b.submit(q, max_new_tokens=6) for q in prompts]
        b.run()
        return [r.generated for r in reqs], b

    eager, _ = serve({"regions": False})
    got, bc = serve({})
    assert bc.executor.regions and bc.executor.donate
    assert bc.cache_stats()["decode"]["trace_events"] == 1
    assert got == eager
