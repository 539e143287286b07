"""A run whose timed path is broken underneath comes out not correct:
the harness drives the port's plain path on the CPU at a small size, the
look for a card skipped, with each fault a cell can have planted in the
port's own functions (one chip, so no exchange between chips to leave
out)."""

from __future__ import annotations

import pytest

from .common import run_small

import repro_torch.kernels.eikonal.ops as eik_ops  # noqa: E402
import repro_torch.workloads as workloads  # noqa: E402
from repro_torch.core import Executor  # noqa: E402
from repro_torch.core.graph import Reducer  # noqa: E402

PUSH = workloads.particle_update
SWEEP = eik_ops.eikonal_fim_sweep
MAX = workloads.MaxReducer
RUN = Executor.run


def push_unchanged(r, dt, **kw):
    return PUSH(r, 0.0, **kw)


def push_half(r, dt, **kw):
    before = r.data.clone().reshape(-1)
    out = PUSH(r, dt, **kw)
    flat = out.data.view(-1)
    flat[flat.numel() // 2:] = before[flat.numel() // 2:]
    return out


def push_altered(r, dt, **kw):
    out = PUSH(r, dt, **kw)
    out.data.view(-1)[0] += 1.0
    return out


def max_altered():
    r = MAX()

    def local(x, out=None):
        return r.local(x, out=out).add_(1.0)

    return Reducer(r.name, local, r.combine)


def sweep_unchanged(p, m, h, **kw):
    interior = p[1:-1, 1:-1]
    out = kw.get("out")
    return interior.clone() if out is None else out.copy_(interior)


def sweep_half(p, m, h, **kw):
    out = SWEEP(p, m, h, **kw)
    half = out.shape[0] // 2
    out[half:] = p[1:-1, 1:-1][half:]
    return out


def sweep_altered(p, m, h, **kw):
    out = SWEEP(p, m, h, **kw)
    out[0, 0] += 0.5
    return out


PARTICLE_FAULTS = {"unchanged": ("particle_update", push_unchanged),
                   "half_left_out": ("particle_update", push_half),
                   "answer_altered": ("particle_update", push_altered),
                   "max_altered": ("MaxReducer", max_altered)}
EIKONAL_FAULTS = {"unchanged": sweep_unchanged, "half_left_out": sweep_half,
                  "answer_altered": sweep_altered}


def run_one_short(self, state, steps):
    return RUN(self, state, steps - 1)


@pytest.mark.parametrize("workload", ["particles.steps", "particles.diag"])
@pytest.mark.parametrize("fault", sorted(PARTICLE_FAULTS))
def test_particle_fault_is_caught(monkeypatch, workload, fault):
    name, fn = PARTICLE_FAULTS[fault]
    monkeypatch.setattr(workloads, name, fn)
    r = run_small(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["particles.steps", "particles.diag"])
def test_one_step_skipped_a_call_is_caught(monkeypatch, workload):
    monkeypatch.setattr(Executor, "run", run_one_short)
    r = run_small(workload)
    assert not r["correct"], r["checks"]
    assert r["checks"]["x_off"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(EIKONAL_FAULTS))
def test_eikonal_fault_is_caught(monkeypatch, fault):
    monkeypatch.setattr(eik_ops, "eikonal_fim_sweep", EIKONAL_FAULTS[fault])
    r = run_small("eikonal.solve")
    assert not r["correct"], r["checks"]
