"""The graphs of the paper's Tables 2-4 as the port runs them.

* :func:`build_saxpy_graph` — the Table 2 iterator-overhead probe: the
  bounds-checked and the unchecked flat SAXPY on one program level.
* :func:`build_particle_graph` — the JAX package's ``examples/particles.py``
  step: ions (AoS) and electrons (AoSoA) pushed by the particle kernel, a
  field (SoA) updated by the record SAXPY, and a NaN-ignoring max over the
  ions' velocities.  The three pushers share no tensor, so the DAG
  schedule runs them as one antichain.
* :func:`build_particle_diagnostic_graph` — that step with the host
  diagnostic a particle code logs every step (the time and ``vmax``),
  so that the plan runs device -> host -> device.
* :func:`build_flux_graph` — the Table 4 FORCE flux difference on a
  haloed 2-D Euler record (transmissive boundary), whole or partitioned
  over a mesh.
* :func:`build_force_march_graph` — that flux difference marched: each
  step's conservative update feeds the next step.
* :func:`build_eikonal_graph` — the Table 5 eikonal solve: the paper's
  conditional MapReduce around the FIM sweep, repeated until no cell
  changes, reinitialising the distance to a circle of sources; whole or
  partitioned over a mesh.
* :func:`build_euler_solver` — the JAX package's ``examples/euler2d.py``
  solver (paper Listing 12, the §8 scaling application): wavespeeds, a
  max-reduction for the CFL step, the mass diagnostic and the
  dimension-split (or unsplit) FORCE updates with halo exchange, over a
  mesh when given one.

Inputs come from NumPy's ``default_rng(seed)``, so the JAX package and the
port can be fed the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import (Boundary, DistTensor, ExecutionKind, Executor, Graph,
                   Layout, MaxReducer, Mesh, RecordArray, ReductionResult,
                   SumReducer, exclusive_padded_access, in_place,
                   make_reduction_result, relayout)
from .kernels.eikonal.ops import make_eikonal_graph
from .kernels.particle.ops import PARTICLE_SPEC, particle_update
from .kernels.saxpy.ops import SAXPY_SPEC, saxpy, saxpy_record
from .kernels.stencil.ops import make_flux_difference_graph
from .physics.euler import EULER_SPEC, sound_speed, update_dim, update_full

__all__ = ["DT", "build_saxpy_graph", "build_particle_graph",
           "build_particle_diagnostic_graph", "particle_fields",
           "build_flux_graph", "conservative_update",
           "build_force_march_graph", "Converging",
           "build_eikonal_graph", "eikonal_inputs", "eikonal_distance",
           "build_euler_solver"]

DT = 0.01


def build_saxpy_graph(n: int, a: float, *, block: int = 1024,
                      use_kernel: bool = True):
    """``y_bc = a*x + y_bc`` (bounds-checked) and ``y_nbc = a*x + y_nbc``
    (unchecked) as one antichain; returns ``(graph, (x, y_bc, y_nbc))``."""
    x = DistTensor("x", (n,))
    y_bc = DistTensor("y_bc", (n,))
    y_nbc = DistTensor("y_nbc", (n,))
    g = Graph(name="saxpy_probe")
    g.split(in_place(lambda xv, yv, out=None: saxpy(
        a, xv, yv, block=block, bounds_check=True, use_kernel=use_kernel,
        out=out)), x, y_bc)
    g.split(in_place(lambda xv, yv, out=None: saxpy(
        a, xv, yv, block=block, bounds_check=False, use_kernel=use_kernel,
        out=out)), x, y_nbc)
    return g, (x, y_bc, y_nbc)


def build_particle_graph(n: int, *, block: int = 512, dt: float = DT,
                         use_kernel: bool = True):
    """The particle step graph; returns
    ``(graph, (ions, electrons, field), vmax)``."""
    ions = DistTensor("ions", (n,), spec=PARTICLE_SPEC, layout=Layout.AOS)
    electrons = DistTensor("electrons", (n,), spec=PARTICLE_SPEC,
                           layout=Layout.AOSOA)
    field = DistTensor("field", (n,), spec=SAXPY_SPEC, layout=Layout.SOA)
    vmax = make_reduction_result("vmax")

    @in_place
    def push(r, out=None):
        return particle_update(r, dt, block=block, use_kernel=use_kernel,
                               out=out)

    g = Graph(name="particle_step")
    g.split(push, ions, writes=(0,))
    g.then_split(push, electrons, writes=(0,))
    g.then_split(in_place(lambda r, out=None: saxpy_record(
        r, dt, block=block, use_kernel=use_kernel, out=out)),
        field, writes=(0,))
    g.then_reduce(ions, vmax, MaxReducer(), field="v")
    return g, (ions, electrons, field), vmax


def build_particle_diagnostic_graph(n: int, record, *, block: int = 512,
                                    dt: float = DT, use_kernel: bool = True):
    """The particle step with a host diagnostic: the pushes and the max
    over the ions' velocities, then a host (Cpu) node that reads the
    step's time ``t`` and ``vmax`` and calls ``record(t, vmax)`` with both
    as Python floats (a particle code logs them every step; ``record`` may
    also stand in for slow I/O), then the field update (K2), which also
    advances the clock, ``t += dt``.

    The field update does not need ``vmax``, and the DAG schedule would
    hoist it into the pushes' segment.  It writes ``t``, which the
    diagnostic reads before it, and that anti-dependency keeps it behind
    the host node: the plan runs device -> host -> device, so that a
    callback is in flight while the next device region runs.  Pass
    ``record`` as a function or an object: a bound method of a list (its
    ``append``) is keyed by the list's contents in the plan signature.
    Returns ``(graph, (ions, electrons, field, t), vmax)``."""
    ions = DistTensor("ions", (n,), spec=PARTICLE_SPEC, layout=Layout.AOS)
    electrons = DistTensor("electrons", (n,), spec=PARTICLE_SPEC,
                           layout=Layout.AOSOA)
    field = DistTensor("field", (n,), spec=SAXPY_SPEC, layout=Layout.SOA)
    t = DistTensor("t", (1,))
    vmax = make_reduction_result("vmax")

    @in_place
    def push(r, out=None):
        return particle_update(r, dt, block=block, use_kernel=use_kernel,
                               out=out)

    def diagnostic(v, clock):
        record(float(clock[0]), float(v))

    @in_place
    def advance(r, clock, out=None):
        r_out, clock_out = (None, None) if out is None else out
        return (saxpy_record(r, dt, block=block, use_kernel=use_kernel,
                             out=r_out),
                clock + dt if clock_out is None
                else torch.add(clock, dt, out=clock_out))

    g = Graph(name="particle_step_diagnostic")
    g.split(push, ions, writes=(0,))
    g.then_split(push, electrons, writes=(0,))
    g.then_reduce(ions, vmax, MaxReducer(), field="v")
    g.then(diagnostic, exec_kind=ExecutionKind.Cpu, args=(vmax, t))
    g.then_split(advance, field, t, writes=(0, 1))
    return g, (ions, electrons, field, t), vmax


def particle_fields(n: int, seed: int = 0) -> dict[str, dict[str, np.ndarray]]:
    """Per-field float32 inputs of the particle graph: positions and
    velocities ~ N(0, 1) for both species, a field ``x`` ~ N(0, 1) with
    ``y = 0``."""
    rng = np.random.default_rng(seed)

    def species():
        return {"x": rng.standard_normal((n, 3), dtype=np.float32),
                "v": rng.standard_normal((n, 3), dtype=np.float32)}

    ions, electrons = species(), species()
    field = {"x": rng.standard_normal(n, dtype=np.float32),
             "y": np.zeros(n, np.float32)}
    return {"ions": ions, "electrons": electrons, "field": field}


def _partition(mesh, partition) -> tuple:
    """A workload graph's partition: as given, else the mesh's axes in
    order over the space dims, else none."""
    if partition is not None:
        return tuple(partition)
    return mesh.axis_names if mesh is not None else ()


def _flux_graph(out_name: str, nx: int, ny: int, lam_x, lam_y, layout,
                block, use_kernel, mesh, partition, overlap, graph=None):
    """The flux difference of ``u`` into the record ``out_name``, on
    ``graph`` when given: ``(graph, (u, out))``."""
    partition = _partition(mesh, partition)
    u = DistTensor("u", (nx, ny), spec=EULER_SPEC, layout=layout,
                   partition=partition, halo=(1, 1),
                   boundary=Boundary.TRANSMISSIVE)
    out = DistTensor(out_name, (nx, ny), spec=EULER_SPEC, layout=layout,
                     partition=partition)
    if mesh is not None:
        u.validate_mesh(mesh)
    g = make_flux_difference_graph(u, out, lam_x, lam_y, overlap=overlap,
                                   use_kernel=use_kernel, block=block,
                                   graph=graph)
    return g, (u, out)


def build_flux_graph(nx: int, ny: int, *, lam_x: float = 0.1,
                     lam_y: float = 0.1, layout: Layout = Layout.SOA,
                     block=None, use_kernel: bool = True,
                     mesh: Mesh = None, partition=None,
                     overlap: bool = False):
    """FORCE flux difference of ``u`` (halo (1, 1), transmissive) into
    ``flux``; returns ``(graph, (u, flux))``.  Both are partitioned by
    ``partition`` (default: ``mesh``'s axes over (x, y)), checked against
    ``mesh`` when given; ``overlap=True`` asks for the interior/boundary
    lowering.  A step leaves ``u`` as it was, so every step computes the
    same ``flux``: to march the scheme, build
    :func:`build_force_march_graph`."""
    return _flux_graph("flux", nx, ny, lam_x, lam_y, layout, block,
                       use_kernel, mesh, partition, overlap)


@in_place                       # reads each element of u before writing it
def conservative_update(u: RecordArray, du: RecordArray,
                        out=None) -> RecordArray:
    """The marched FORCE scheme's update ``u - du / 2`` of two Euler
    records (``du`` K4's flux difference at twice the step's ``lam_x``
    and ``lam_y``: see :func:`build_force_march_graph`), in ``u``'s
    layout; written into ``out`` (a record in that layout, ``u``'s own
    storage allowed) when given."""
    if du.layout is not u.layout:
        du = relayout(du, u.layout)
    if out is None:
        return RecordArray(u.data - du.data / 2, u.spec, u.layout)
    torch.add(u.data, du.data, alpha=-0.5, out=out.data)
    return out


def build_force_march_graph(nx: int, ny: int, *, lam_x: float,
                            lam_y: float, layout: Layout = Layout.SOA,
                            block=None, use_kernel: bool = True,
                            mesh: Mesh = None, partition=None,
                            overlap: bool = False):
    """The FORCE scheme marched (paper Table 4 and §8): a step fills
    ``u``'s transmissive halo (1, 1), takes :func:`build_flux_graph`'s
    flux difference ``du`` (K4 on the GPU) at ``2 lam_x`` and ``2
    lam_y``, and then updates ``u <- u - du / 2`` in place
    (:func:`conservative_update`), so that each step reads the last
    one's ``u``.  ``lam_x`` and ``lam_y`` are the step's ``dt / dx`` and
    ``dt / dy``.

    The step is the mean of the x and the y one-dimensional FORCE steps
    of ``2 dt``.  The plain sum ``u - lam_x dF - lam_y dG`` of fluxes at
    ``lam_x`` and ``lam_y`` grows the grid's checkerboard mode at any
    ``lam`` (by ``1 + C_x^2 + C_y^2`` a step under linear advection,
    ``C`` the Courant numbers); the mean of two one-dimensional steps is stable
    while each is, that is while ``2 lam_x max(|u| + c)`` and ``2 lam_y
    max(|v| + c)`` stay at most 1, which the caller keeps.  ``layout``,
    ``block``, ``use_kernel``, ``mesh``, ``partition`` and ``overlap``
    are :func:`build_flux_graph`'s.  Returns ``(graph, (u, du))``."""
    g, (u, du) = _flux_graph("du", nx, ny, 2 * lam_x, 2 * lam_y, layout,
                             block, use_kernel, mesh, partition, overlap,
                             graph=Graph(name="force_march"))
    g.then_split(conservative_update, u, du, writes=(0,))
    return g, (u, du)


class Converging:
    """Predicate of the eikonal loop: ``res > 0``, i.e. some cell changed
    in the last iteration.  ``iterations`` holds the number of iterations
    of the last solve that ended; past ``max_iters`` iterations of one
    solve the predicate raises instead of letting the loop run on."""

    def __init__(self, result: ReductionResult, max_iters=None):
        self.result = result.name
        self.max_iters = max_iters
        self.iterations = 0
        self._running = 0

    def __call__(self, state: dict) -> bool:
        if not bool(state[self.result] > 0):
            self.iterations, self._running = self._running, 0
            return False
        if self.max_iters is not None and self._running >= self.max_iters:
            self._running = 0
            raise RuntimeError(f"eikonal solve: still changing after "
                               f"{self.max_iters} iterations")
        self._running += 1
        return True


def build_eikonal_graph(n: int, *, inner: int = 4, block=(8, 128),
                        max_iters=None, use_kernel: bool = True,
                        mesh: Mesh = None, partition=None):
    """The Table 5 solve on an ``n x n`` grid (h = 1/n) as the paper's
    conditional MapReduce: per iteration ``phi_prev <- phi``, one FIM
    sweep (``inner`` sweeps per ``block`` tile, K5 on the GPU), the
    change ``|phi - phi_prev|`` and its max into ``res``, while
    ``res > 0``.  Every sweep is non-increasing, so the loop ends.
    Every tensor is partitioned by ``partition`` (default: ``mesh``'s
    axes), checked against ``mesh`` when given; with ``inner > 1`` a
    shard's extents must be multiples of ``block`` for the solve to equal
    the unsharded one (each tile then freezes the same halo cells).
    Returns ``(graph, (phi, mask), predicate)``, the predicate a
    :class:`Converging`."""
    partition = _partition(mesh, partition)
    phi = DistTensor("phi", (n, n), partition=partition, halo=(1, 1),
                     boundary=Boundary.TRANSMISSIVE)
    mask = DistTensor("mask", (n, n), dtype=torch.bool, partition=partition)
    phi_prev = DistTensor("phi_prev", (n, n), partition=partition)
    change = DistTensor("change", (n, n), partition=partition)
    if mesh is not None:
        phi.validate_mesh(mesh)
    res = make_reduction_result("res", init=float("inf"))
    body = Graph(name="fim_iteration")
    # eagerly phi_prev aliases phi; under regions=True phi_prev's buffer
    # takes a copy of phi, so that the sweep writes phi's buffer in place
    body.split(in_place(lambda p, _prev, out=None:
                        p if out is None else out.copy_(p)), phi, phi_prev)
    body.then(make_eikonal_graph(phi, mask, 1.0 / n, inner=inner,
                                 block=block, overlap=False,
                                 use_kernel=use_kernel))
    body.then_split(in_place(lambda p, q, _d, out=None:
                             torch.abs(p - q, out=out)),
                    phi, phi_prev, change)
    body.then_reduce(change, res, MaxReducer())
    converging = Converging(res, max_iters)
    body.conditional(converging)
    return Graph(name="eikonal_solve").emplace(body), (phi, mask), converging


def _radius_offset(n: int) -> np.ndarray:
    """``r - R`` in cells per cell centre: ``r`` the distance to the
    grid's centre, ``R = n/4``."""
    c = np.arange(n) + 0.5 - n / 2
    return np.hypot(c[:, None], c[None, :]) - n / 4


def eikonal_inputs(n: int) -> dict[str, np.ndarray]:
    """Level-set reinitialisation input: the sources are the cells whose
    centre lies within half a cell of the circle of radius ``n/4`` about
    the grid's centre; ``phi`` is 0 there and 1e3 elsewhere (float32),
    ``mask`` marks them."""
    mask = np.abs(_radius_offset(n)) <= 0.5
    phi = np.where(mask, 0.0, 1e3).astype(np.float32)
    return {"phi": phi, "mask": mask}


def eikonal_distance(n: int) -> np.ndarray:
    """The exact solution ``h |r - R|``: each cell centre's distance to the
    circle (float64)."""
    return np.abs(_radius_offset(n)) / n


def build_euler_solver(nx: int, ny: int, mesh: Mesh = None,
                       overlap: bool = False, unsplit: bool = False, *,
                       cfl: float = 0.4, device=None, **executor_opts):
    """The 2-D Euler shock-bubble solver of the JAX package's
    ``examples/euler2d.py`` (``build_solver``) as one graph, built once and
    run many times (paper Listing 12): per step the wavespeed field, its
    max into ``smax`` for the CFL step, the mass (sum of ``rho``) into
    ``mass``, then the dimension-split FORCE updates (``unsplit=True``:
    one 2-D update whose halo schedule spans both axes, corners
    included), each reading the pre-update halo
    (``exclusive_padded_access``).

    On a 2-axis ``mesh`` the grid is split over both dims (its axes in
    order), on a 1-axis mesh over y (the paper splits the higher dim);
    ``overlap=True`` asks each update for the interior/boundary lowering.
    ``executor_opts`` go to the :class:`Executor` (``regions=True``,
    ``donate=``).  Returns ``(executor, u)``."""
    dx, dy = 2.0 / nx, 1.0 / ny
    partition = (None, None)
    if mesh is not None:
        names = mesh.axis_names
        partition = names if len(names) == 2 else (None, names[0])
    u = DistTensor("u", (nx, ny), spec=EULER_SPEC, layout=Layout.SOA,
                   partition=partition, halo=(1, 1),
                   boundary=Boundary.TRANSMISSIVE)
    ux = u.with_(halo=(1, 0))
    uy = u.with_(halo=(0, 1))
    ws = DistTensor("ws", (nx, ny), partition=partition)
    smax = make_reduction_result("smax", init=1.0)
    mass = make_reduction_result("mass")

    def set_wavespeeds(rec, _ws):
        U = rec.data
        c = sound_speed(U)
        return torch.maximum(torch.abs(U[2] / U[0]) + c,
                             torch.abs(U[3] / U[0]) + c)

    def update_x(rec, s):
        dt = cfl * min(dx, dy) / s
        return RecordArray(update_dim(rec.data, 0, dt / dx), EULER_SPEC,
                           Layout.SOA)

    def update_y(rec, s):
        dt = cfl * min(dx, dy) / s
        return RecordArray(update_dim(rec.data, 1, dt / dy), EULER_SPEC,
                           Layout.SOA)

    def update_xy(rec, s):
        # unsplit scheme: both directional fluxes share one dt bound
        dt = cfl / (s * (1.0 / dx + 1.0 / dy))
        return RecordArray(update_full(rec.data, dt / dx, dt / dy),
                           EULER_SPEC, Layout.SOA)

    g = Graph(name="euler_step")
    g.split(set_wavespeeds, u, ws)
    g.then_reduce(ws, smax, MaxReducer())
    g.then_reduce(u, mass, SumReducer(), field="rho")
    if unsplit:
        g.then_split(update_xy, exclusive_padded_access(u), smax,
                     writes=(0,), overlap=overlap)
    else:
        g.then_split(update_x, exclusive_padded_access(ux), smax,
                     writes=(0,), overlap=overlap)
        g.then_split(update_y, exclusive_padded_access(uy), smax,
                     writes=(0,), overlap=overlap)
    return Executor(g, device, mesh=mesh, **executor_opts), u
