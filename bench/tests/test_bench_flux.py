"""The finite-volume cell (``flux.4096``) on the CPU at a small size: the
plain reference against the port's marched graph, the driver end to end
through the harness, faults planted in the port that must each read not
correct, the reference on states whose answer is known, the control,
and the byte counts and readers by hand."""

from __future__ import annotations

import pytest
import torch

from .common import SEED, SMALL, run_small

import repro_torch.kernels.stencil.ops as stencil_ops  # noqa: E402
import repro_torch.workloads as workloads  # noqa: E402
from bench import control, flux_bytes, harness, profile  # noqa: E402
from bench.drivers import flux as driver  # noqa: E402
from bench.reference import flux as ref  # noqa: E402
from repro_torch.core import Executor, Layout, RecordArray  # noqa: E402
from repro_torch.physics.euler import EULER_SPEC  # noqa: E402

CELL = "flux.4096"
FLUX = stencil_ops.flux_difference
RUN = Executor.run


def test_the_reference_is_the_port_march():
    """10 steps at 64 x 128 with lam_x != lam_y: the port's float32
    march against the reference's float64 one, within 2e-6 of each
    field's magnitude (float32 rounding of ~90-operation face fluxes,
    ten steps of it)."""
    nx, ny, lam = 64, 128, (0.01, 0.02)
    u0 = driver.make_input(nx, ny, SEED, "cpu")
    g, (u, _) = workloads.build_force_march_graph(nx, ny, lam_x=lam[0],
                                                  lam_y=lam[1])
    ex = Executor(g, "cpu")
    out = ex.run(ex.init_state(u=RecordArray(u0, EULER_SPEC, Layout.SOA)),
                 10)
    got = ex.read(out, u).data
    want = ref.march(u0.double(), *lam, 10)
    assert driver.numbers(got, want, *lam)["u_gap"] < 2e-6
    # the march moved the state by far more than that
    assert driver.numbers(u0, want, *lam)["u_gap"] > 1e-3


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_on_the_cpu(trace):
    r = run_small(CELL, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["attempted"] % 100 == 0
    got = r["metrics"]
    if not trace:
        assert set(got) == {"setup_s", "step_ms"}
        return
    nx, ny = SMALL["flux-t4"]["nx"], SMALL["flux-t4"]["ny"]
    assert got["halo_bytes.step"]["value"] == pytest.approx(
        4 * 4 * (nx + 2) * (ny + 2) / 1e6)
    assert got["region_builds.step"]["value"] == 0
    assert got["flux_step_roofline"]["value"] > 0
    # no device trace on the CPU: nothing for K4's roofline to read
    assert "k4_roofline" not in got


def update_skipped(u, du, out=None):
    return u if out is None else out


def update_in_bfloat16(u, du, out=None):
    return RecordArray((u.data - du.data).bfloat16().float(), u.spec,
                       u.layout)


def lambdas_swapped(rec, lam_x, lam_y, **kw):
    return FLUX(rec, lam_y, lam_x, **kw)


def du_halved_over_half(rec, lam_x, lam_y, **kw):
    out = FLUX(rec, lam_x, lam_y, **kw)
    half = out.data.shape[1] // 2
    out.data[:, :half] *= 0.5
    return out


def run_one_short(self, state, steps):
    return RUN(self, state, steps - 1)


FAULTS = {"step_skipped": (Executor, "run", run_one_short),
          "update_skipped": (workloads, "conservative_update",
                             update_skipped),
          "lambdas_swapped": (stencil_ops, "flux_difference",
                              lambdas_swapped),
          "du_halved_over_half": (stencil_ops, "flux_difference",
                                  du_halved_over_half),
          "state_in_bfloat16": (workloads, "conservative_update",
                                update_in_bfloat16)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_caught(monkeypatch, fault):
    owner, name, fn = FAULTS[fault]
    monkeypatch.setattr(owner, name, fn)
    r = run_small(CELL)
    assert not r["correct"], r["checks"]
    assert r["checks"]["u_gap"]["value"] > r["checks"]["u_gap"]["limit"]


@pytest.mark.parametrize("velocity", [(0.0, 0.0), (2.5, -1.0)])
def test_a_uniform_state_stays_as_it_is(velocity):
    """Every face carries the same flux, so du is 0 exactly: the
    transmissive halo adds nothing at the edges, moving or not."""
    rho, p = 1.3, 2.0
    u = torch.empty(4, 12, 20, dtype=torch.float64)
    u[0], u[2], u[3] = rho, rho * velocity[0], rho * velocity[1]
    u[1] = p / (ref.GAMMA - 1) + rho * (velocity[0] ** 2
                                        + velocity[1] ** 2) / 2
    assert torch.equal(ref.march(u, 0.01, 0.02, 20), u)


def test_a_shock_along_x_stays_one_dimensional():
    """The shock-bubble state without its bubble varies along x alone:
    every column stays uniform along y, the y momentum 0, the shock
    moves to the right and the mass changes only through the edges."""
    u = ref.shock_bubble(256, 8, dtype=torch.float64)
    u[0] = torch.where(u[0] < 1, 1.0, u[0])    # no bubble (p was 1 there)
    lam, steps = (0.05, 0.05), 40
    out = ref.march(u, *lam, steps)
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    assert torch.equal(out, out[:, :, :1].expand_as(out))
    front = lambda s: int((s[0, :, 0] > 2).nonzero().max())  # noqa: E731
    assert front(out) > front(u)
    # the mass leaves and enters through the edges only
    inflow = lam[0] * steps * float(u[2, 0, 0]) * u.shape[2]
    assert float(out[0].sum() - u[0].sum()) == pytest.approx(inflow,
                                                             rel=1e-9)


@pytest.mark.parametrize("nx,ny", [(64, 32), (200, 100), (1024, 512)])
def test_the_reference_builds_the_programs_shock_bubble(nx, ny):
    """The reference's Fig. 11 state, built from the problem's numbers,
    is the program's ``shock_bubble_init`` in float32: the same bubble
    cells, the post-shock state within float32 rounding."""
    from repro_torch.physics.euler import shock_bubble_init

    want = shock_bubble_init(nx, ny, device="cpu")
    got = ref.shock_bubble(nx, ny)
    assert got.dtype == torch.float32 and got.shape == (4, nx, ny)
    assert torch.equal(got[0] == 0.1, want[0] == 0.1)
    assert torch.equal(got[3], want[3])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    # behind the shock: rho 4.4628, u 3.4979, p 16.7688 at Mach 3.81
    back = ref.shock_bubble(8, 1, dtype=torch.float64)[:, 0, 0]
    assert float(back[0]) == pytest.approx(4.4628, abs=1e-4)
    assert float(back[2] / back[0]) == pytest.approx(3.4979, abs=1e-4)
    assert float(ref.pressure(back[:, None])[0]) == pytest.approx(
        16.7688, abs=1e-4)


def _checkerboard(step, lam):
    """The growth of a 1e-6 checkerboard in the energy (so the pressure)
    of a gas at rest over 100 ``step``s at ``lam``."""
    u = torch.zeros(4, 32, 32, dtype=torch.float64)
    u[0], u[1] = 1.0, 1.0 / (ref.GAMMA - 1)
    i = torch.arange(32)
    v = u.clone()
    v[1] += 1e-6 * (-1.0) ** (i[:, None] + i[None, :])
    for _ in range(100):
        v = step(v, *lam)
    return float((v - u).abs().max()) / 1e-6


def test_the_step_damps_the_checkerboard_that_the_plain_sum_grows():
    """Why a step is the mean of two one-dimensional steps of 2 dt: the
    plain sum of the x and y flux differences at dt grows the grid's
    (pi, pi) mode by 1 + c_x^2 + c_y^2 a step; the mean damps it."""
    lam = (0.1, 0.2)               # Courant numbers 0.12 and 0.24 at rest

    def plain_sum(u, lam_x, lam_y):
        return (ref.one_dimensional_step(u, 0, lam_x)
                + ref.one_dimensional_step(u, 1, lam_y) - u)

    assert _checkerboard(plain_sum, lam) > 100
    assert _checkerboard(ref.step, lam) < 0.1


def test_the_march_stays_valid_at_the_cells_lambda():
    """The seeded shock-bubble state marched at ``flux-t4``'s lambdas in
    float64 over the time a window covers at 4096^2 (t = 0.14, the shock
    from x = 0.3 to past the bubble) at 128^2: density and pressure stay
    positive and the Courant number low."""
    cfg = harness.load_json("configs", "flux-t4", harness.ROOT / "bench")
    lam, n = (cfg["lam_x"], cfg["lam_y"]), 128
    u = driver.make_input(n, n, SEED, "cpu").double()
    steps = round(0.14 / (lam[0] * 2 / n))
    out = ref.march(u, *lam, steps)
    assert float(out[0].min()) > 0 and float(ref.pressure(out).min()) > 0
    assert ref.wavespeed_sum(out, *lam) < 0.2
    # the shock passed x = 0.85, beyond the bubble's centre
    assert float(out[0, int(0.85 * n / 2), n // 8]) > 2


def test_the_control_is_not_correct():
    r = control.readings(CELL, SEED, 100, device="cpu",
                         overrides=SMALL["flux-t4"])
    assert r["over"] == ["u_gap"], r


def test_flux_bytes_by_hand():
    n = 4096
    assert flux_bytes.k4_bytes(n, n) == 4 * 4 * (4098 ** 2 + 4096 ** 2) \
        == 537_133_120
    assert flux_bytes.step_bytes(n, n) == 32 * n * n == 536_870_912
    faces = 2 * 4096 * 4097
    assert flux_bytes.k4_ops(n, n) == 89 * faces + 20 * n * n


class _Cell:
    unit = "step"


def test_the_readers_by_hand():
    n = 4096
    st = profile.Stretch(window_s=1.0, busy_s=0.99, counts={"steps": 200})
    st.kernels = {"void (anonymous namespace)::flux_kernel<float, 1>(x)":
                  [200 * 0.25e-3, 200],
                  "void at::native::elementwise_kernel<128, 4, "
                  "direct_copy_kernel_cuda(x)>(x)": [200 * 0.3e-3, 3400]}
    cfg = {"driver": "flux", "nx": n, "ny": n}
    run = harness.Run(_Cell(), cfg, 1.0, 2.0, 4000, {},
                      {"halo_bytes": 4 * 4 * 4098 ** 2}, st)
    read = harness.reader
    assert read("k4_roofline")(run) == pytest.approx(
        100 * 537_133_120 / 3.35e12 / 0.25e-3)
    assert read("copy_ms.step")(run) == pytest.approx(0.3)
    assert read("halo_bytes.step")(run) == pytest.approx(268.697664)
    assert read("flux_step_roofline")(run) == pytest.approx(
        100 * 536_870_912 / 3.35e12 / 0.5e-3)
    other = harness.Run(_Cell(), {"driver": "particles",
                                  "particles": 1 << 20}, 1.0, 2.0, 10, {},
                        {}, st)
    for name in ("k4_roofline", "halo_bytes.step", "flux_step_roofline"):
        assert read(name)(other) is None
