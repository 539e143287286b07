"""Euler 2D shock-bubble (the paper's §8 scaling application) on PyTorch,
as ``examples/euler2d.py``, through ``workloads.build_euler_solver``
(paper Listing 12): per-step wavespeed field -> max-reduction -> CFL dt
-> dimension-split FORCE updates with halo exchange — ONE graph, built
once, executed many times.

``--devices N`` runs N shards on the one device
(``make_mesh(..., devices=[device] * N)``, the counterpart of the
reference's fake host devices): over y, or with ``--px`` over both grid
dims (paper Fig. 7's multi-dimensional transfer space); ``--overlap``
asks each update for the interior/boundary lowering, and ``--unsplit``
swaps the dimension-split updates for one 2-D-stencil node whose halo
schedule spans both axes (corner blocks included).  smax, the rho range
and the mass drift must match the one-shard run's.

  PYTHONPATH=src python examples/euler2d_torch.py --nx 128 --ny 64 --steps 50
  PYTHONPATH=src python examples/euler2d_torch.py --devices 4 --px 2 \\
      --overlap --device cpu
"""

import argparse
import time

import torch

from repro_torch import workloads
from repro_torch.core import make_mesh
from repro_torch.core.device import resolve_device
from repro_torch.physics.euler import RHO, pressure, shock_bubble_init


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_solver(nx: int, ny: int, n_devices: int = 1, px: int = 1,
                 overlap: bool = False, unsplit: bool = False, device=None):
    """The solver and its ``u`` on ``n_devices`` shards of ``device``:
    ``(executor, u)``."""
    device = resolve_device(device)
    mesh = None
    if n_devices > 1:
        if px > 1:
            if n_devices % px:
                raise ValueError(f"--px {px} must divide --devices "
                                 f"{n_devices}")
            mesh = make_mesh((px, n_devices // px), ("gx", "gy"),
                             devices=[device] * n_devices)
        else:
            mesh = make_mesh((n_devices,), ("gy",),
                             devices=[device] * n_devices)
    return workloads.build_euler_solver(
        nx, ny, mesh, overlap=overlap, unsplit=unsplit,
        device=None if mesh is not None else device)


def run(nx: int, ny: int, steps: int, n_devices: int = 1, px: int = 1,
        overlap: bool = False, unsplit: bool = False,
        show_dag: bool = False, device=None) -> dict:
    """``steps`` steps on ``device`` (None: the GPU); returns the printed
    values per chunk of 10 steps (smax, rho min and max, mass and its
    drift), the final state ``U`` (on the CPU), the halo blocks and the
    wall times."""
    device = resolve_device(device)
    dx, dy = 2.0 / nx, 1.0 / ny
    ex, u = build_solver(nx, ny, n_devices, px=px, overlap=overlap,
                         unsplit=unsplit, device=device)
    fused = ex.dag.fused_antichains()
    print(f"schedule: {len(ex._segments)} segment(s), "
          f"{len(fused)} fused antichain(s) "
          f"{[[un.label for un in w] for w in fused]}")
    if show_dag:
        print(ex.describe_dag())
    ht = ex.plan.halo_transfers
    if n_devices > 1:
        print(f"halo schedule: {len(ht)} blocks "
              f"({sum(1 for h in ht if h.overlapped)} overlapped, "
              f"{sum(1 for h in ht if h.mesh_axis)} copies between "
              f"shards); fallbacks: {len(ex.plan.overlap_fallbacks)}")
        for h in ht[:6]:
            print("  " + h.describe())
    U0 = shock_bubble_init(nx, ny, device=device)
    mass0 = float(U0[RHO].sum()) * dx * dy
    state = ex.init_state(u=U0)

    # the first step builds the graph (on the GPU: kernels and capture)
    _sync(device)
    t0 = time.perf_counter()
    state = ex(state)
    _sync(device)
    first_s = time.perf_counter() - t0

    rows = []
    t0 = time.perf_counter()
    chunk = 10
    for i in range(0, steps - 1, chunk):
        state = ex.run(state, steps=min(chunk, steps - 1 - i))
        U = ex.read(state, u).data
        # the graph's mass reduction reads u in wave 0 (so it fuses into
        # the wavespeed antichain): it is the mass at the START of the
        # last step, labelled accordingly
        mass = float(state["mass"]) * dx * dy
        row = {"step": i + chunk, "smax": float(state["smax"]),
               "rho_min": float(U[RHO].min()),
               "rho_max": float(U[RHO].max()), "mass": mass,
               "drift": abs(mass - mass0) / mass0}
        rows.append(row)
        print(f"step {row['step']:4d}: smax={row['smax']:.3f} "
              f"rho in [{row['rho_min']:.3f}, {row['rho_max']:.3f}] "
              f"mass drift (step start) {row['drift']:.2e}")
    _sync(device)
    wall = time.perf_counter() - t0

    U = ex.read(state, u).data.cpu()
    assert torch.isfinite(U).all()
    assert (U[RHO] > 0).all()
    assert (pressure(U) > 0).all()
    step_ms = wall / max(steps - 1, 1) * 1e3
    print(f"\n{steps} steps on {nx}x{ny} ({n_devices} shard(s) on "
          f"{device}): first step (build) {first_s:.2f}s, then "
          f"{step_ms:.3f} ms/step")
    return {"rows": rows, "U": U, "halo_blocks": len(ht),
            "first_s": first_s, "step_ms": step_ms, "executor": ex}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--devices", type=int, default=1,
                    help="shards of the one device (a mesh when > 1)")
    ap.add_argument("--px", type=int, default=1,
                    help="mesh extent along x (2-D decomposition when > 1)")
    ap.add_argument("--overlap", action="store_true",
                    help="hide the halo copies behind interior compute")
    ap.add_argument("--unsplit", action="store_true",
                    help="one 2-D-stencil update node instead of "
                         "dimension-split x/y nodes")
    ap.add_argument("--show-dag", action="store_true",
                    help="print the full dependency-DAG schedule "
                         "(describe_dag) before running")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    return run(args.nx, args.ny, args.steps, args.devices, px=args.px,
               overlap=args.overlap, unsplit=args.unsplit,
               show_dag=args.show_dag, device=args.device)


if __name__ == "__main__":
    main()
