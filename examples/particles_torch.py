"""Two independent particle populations on one Ripple graph (paper §7.2),
on PyTorch: ``examples/particles.py``'s graph through
``workloads.build_particle_graph``.

Program order writes the pusher/field/diagnostic nodes on separate
levels, but none of them share a tensor: the dependency-DAG scheduler
(``core/schedule.py``) runs them as one antichain in one segment.  Layout
polymorphism rides along: the ions store AoS, the electrons AoSoA, and
the same particle kernel (K3) updates both; the field is a SoA record
updated by the record SAXPY (K2); ``vmax`` is a max over the ions'
velocities.  At the executor's defaults the step is one captured CUDA
graph, replayed every step, and the state passed back is donated.

  PYTHONPATH=src python examples/particles_torch.py [--n 4096] [--steps 100]
  PYTHONPATH=src python examples/particles_torch.py --show-dag --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import workloads
from repro_torch.core import Executor, Layout, RecordArray
from repro_torch.core.device import resolve_device
from repro_torch.kernels.particle.ops import PARTICLE_SPEC
from repro_torch.kernels.saxpy.ops import SAXPY_SPEC

DT = workloads.DT


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n: int, steps: int, show_dag: bool = False, device=None) -> dict:
    """``steps`` steps of ``n`` particles per species on ``device`` (None:
    the GPU), checked against the closed form; returns vmax, the first
    call's and the later steps' wall times, and the executor."""
    device = resolve_device(device)
    g, (ions, electrons, field), vmax = workloads.build_particle_graph(n)
    ex = Executor(g, device=device)
    fused = ex.dag.fused_antichains()
    print(f"schedule: {len(ex._segments)} segment(s), "
          f"{len(fused)} fused antichain(s) "
          f"{[[u.label for u in w] for w in fused]}")
    if show_dag:
        print(ex.describe_dag())

    f = workloads.particle_fields(n)
    specs = {"ions": (PARTICLE_SPEC, Layout.AOS),
             "electrons": (PARTICLE_SPEC, Layout.AOSOA),
             "field": (SAXPY_SPEC, Layout.SOA)}
    state = ex.init_state(**{
        k: RecordArray.from_fields(
            spec, {name: torch.from_numpy(v) for name, v in f[k].items()},
            lay)
        for k, (spec, lay) in specs.items()})

    # the first step builds the graph (on the GPU: the kernels and the
    # capture); the rest replay it on the donated state
    _sync(device)
    t0 = time.perf_counter()
    state = ex.run(state, 1)
    _sync(device)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = ex.run(state, steps - 1)
    _sync(device)
    wall = time.perf_counter() - t0

    # drift-free kinematics: x_t = x_0 + t*dt*v, so verify both species
    # against the closed form (and the field against its saxpy series)
    for t in (ions, electrons):
        got = ex.read(state, t).field("x").cpu().numpy()
        want = f[t.name]["x"] + steps * DT * f[t.name]["v"]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    got_y = ex.read(state, field).field("y").cpu().numpy()
    np.testing.assert_allclose(got_y, steps * DT * f["field"]["x"],
                               rtol=1e-4, atol=1e-4)
    step_ms = wall / max(steps - 1, 1) * 1e3
    out = {"vmax": float(state[vmax.name]), "first_s": first_s,
           "step_ms": step_ms, "executor": ex}
    print(f"vmax={out['vmax']:.3f}; {steps} steps x {n} particles/species "
          f"ok: first step (build) {first_s:.2f}s, then {step_ms:.3f} "
          f"ms/step on {device}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--show-dag", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    return run(args.n, args.steps, show_dag=args.show_dag,
               device=args.device)


if __name__ == "__main__":
    main()
