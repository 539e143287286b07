"""The marched FORCE scheme (``workloads.build_force_march_graph``) on the
CPU: each step against the JAX package's ``flux_difference`` on the same
padded input, the update written in place, the halo assembly's byte
counter (``cache_stats()["halo_bytes"]``) and its ``ripple.halo`` span.

Tolerance: each step's state within 1e-5 of ``u - du / 2`` with the JAX
package's ``du`` at twice the step's lambdas (float32 sums of ~90-operation face fluxes in another
order), relative to the field's magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro.core as ref
import repro_torch.core as port
from repro_torch import workloads
from repro_torch.core import Executor, Layout, RecordArray, trace
from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init

NX, NY = 64, 128
LAM = (0.01, 0.02)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    port.clear_executable_cache()
    monkeypatch.setattr(trace, "_REC", trace._Recorder())
    yield
    port.clear_executable_cache()


def _input(nx=NX, ny=NY, seed=3) -> torch.Tensor:
    """The shock-bubble state with every element scaled by U(0.99, 1.01)."""
    gen = torch.Generator().manual_seed(seed)
    u = shock_bubble_init(nx, ny, device="cpu")
    return u * (0.99 + 0.02 * torch.rand(u.shape, generator=gen))


def _march(layout=Layout.SOA, regions=True, nx=NX, ny=NY):
    g, (u, du) = workloads.build_force_march_graph(
        nx, ny, lam_x=LAM[0], lam_y=LAM[1], layout=layout)
    ex = Executor(g, "cpu", regions=regions)
    state = ex.init_state(u=RecordArray(_input(nx, ny), EULER_SPEC,
                                        Layout.SOA))
    return ex, state, u


def _fields(ex, state, u) -> np.ndarray:
    rec = port.relayout(ex.read(state, u), Layout.SOA)
    return rec.data.numpy().copy()


def _jax_step(u: np.ndarray) -> np.ndarray:
    """``u - du / 2``, ``du`` the JAX package's FORCE flux difference of
    the transmissively padded ``u`` at twice the step's lambdas."""
    from repro.kernels.stencil.ops import flux_difference
    from repro.physics.euler import EULER_SPEC as RS

    d = jnp.asarray(u)
    for ax in (1, 2):
        d = ref.pad_boundary_only(d, axis=ax, width=1,
                                  boundary=ref.Boundary.TRANSMISSIVE)
    du = flux_difference(ref.RecordArray(d, RS, ref.Layout.SOA),
                         2 * LAM[0], 2 * LAM[1])
    return u - np.asarray(du.data) / 2


@pytest.mark.parametrize("layout", ["SOA", "AOS", "AOSOA"])
@pytest.mark.parametrize("regions", [True, False])
def test_each_step_is_the_reference_flux_difference(layout, regions):
    ex, state, u = _march(Layout[layout], regions)
    now = _fields(ex, state, u)
    for _ in range(10):
        want = _jax_step(now)
        state = ex.run(state, 1)
        now = _fields(ex, state, u)
        scale = np.abs(want).reshape(4, -1).max(axis=1)[:, None, None]
        np.testing.assert_array_less(np.abs(now - want) / scale, TOL)
    assert not np.allclose(now, _input().numpy())      # it marched


def test_steps_of_one_call_equal_calls_of_one_step():
    ex, state, u = _march()
    a = _fields(ex, ex.run(dict(state), 5), u)
    ex2, state2, _ = _march(regions=False)
    for _ in range(5):
        state2 = ex2.run(state2, 1)
    np.testing.assert_array_equal(a, _fields(ex2, state2, u))


def test_the_update_writes_u_in_place():
    ex, state, _ = _march()
    ex.run(state, 2)
    stats = ex.cache_stats()
    assert stats["copy_backs"] == 0 and stats["trace_events"] == 1


@pytest.mark.parametrize("nx,ny", [(NX, NY), (16, 8)])
def test_halo_bytes_are_the_padded_buffer(nx, ny):
    ex, state, _ = _march(nx=nx, ny=ny)
    assert ex.cache_stats()["halo_bytes"] == 0        # nothing built yet
    ex.run(state, 3)
    assert ex.cache_stats()["halo_bytes"] == 4 * (nx + 2) * (ny + 2) * 4


def test_a_graph_without_halo_counts_no_halo_bytes():
    g, _, _ = workloads.build_particle_graph(1024)
    ex = Executor(g, "cpu")
    ex.run(ex.init_state(), 2)
    assert ex.cache_stats()["halo_bytes"] == 0


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.session()


def test_an_eager_run_records_each_halo_assembly():
    ex, state, _ = _march(regions=False)
    _, s = _profiled(lambda: ex.run(state, 3))
    halos = s.named("ripple.halo")
    assert len(halos) == 3
    padded = 4 * (NX + 2) * (NY + 2) * 4
    assert all(sp.attrs == {"bytes": padded, "fields": 4} for sp in halos)
    (call,) = s.named("ripple.call")
    assert all(sp.call == call.id for sp in halos)


def test_a_build_and_each_cpu_launch_record_the_halo():
    """The CPU has no replay: a built piece's launch runs its segments
    again and assembles the halo on the host, so each records one."""
    ex, state, _ = _march()
    state, s = _profiled(lambda: ex.run(state, 3))
    (build,) = s.named("ripple.build")
    launches = s.named("ripple.launch")
    assert len(launches) == 2
    halos = s.named("ripple.halo")
    assert sorted(sp.parent for sp in halos) == sorted(
        [build.id] + [sp.id for sp in launches])
    _, s = _profiled(lambda: ex.run(state, 4))
    assert len(s.named("ripple.launch")) == 4
    assert len(s.named("ripple.halo")) == 4


def test_without_a_profiler_the_halo_records_nothing():
    ex, state, _ = _march(regions=False)
    ex.run(state, 2)
    assert trace.session().spans == []
