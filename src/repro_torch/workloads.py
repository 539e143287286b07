"""The graphs of the paper's Tables 2-4 as the port runs them.

* :func:`build_saxpy_graph` — the Table 2 iterator-overhead probe: the
  bounds-checked and the unchecked flat SAXPY on one program level.
* :func:`build_particle_graph` — the JAX package's ``examples/particles.py``
  step: ions (AoS) and electrons (AoSoA) pushed by the particle kernel, a
  field (SoA) updated by the record SAXPY, and a NaN-ignoring max over the
  ions' velocities.  The three pushers share no tensor, so the DAG
  schedule runs them as one antichain.
* :func:`build_flux_graph` — the Table 4 FORCE flux difference on a
  haloed 2-D Euler record (transmissive boundary).

Inputs come from NumPy's ``default_rng(seed)``, so the JAX package and the
port can be fed the same values.
"""

from __future__ import annotations

import numpy as np

from .core import (Boundary, DistTensor, Graph, Layout, MaxReducer,
                   make_reduction_result)
from .kernels.particle.ops import PARTICLE_SPEC, particle_update
from .kernels.saxpy.ops import SAXPY_SPEC, saxpy, saxpy_record
from .kernels.stencil.ops import make_flux_difference_graph
from .physics.euler import EULER_SPEC

__all__ = ["DT", "build_saxpy_graph", "build_particle_graph",
           "particle_fields", "build_flux_graph"]

DT = 0.01


def build_saxpy_graph(n: int, a: float, *, block: int = 1024,
                      use_kernel: bool = True):
    """``y_bc = a*x + y_bc`` (bounds-checked) and ``y_nbc = a*x + y_nbc``
    (unchecked) as one antichain; returns ``(graph, (x, y_bc, y_nbc))``."""
    x = DistTensor("x", (n,))
    y_bc = DistTensor("y_bc", (n,))
    y_nbc = DistTensor("y_nbc", (n,))
    g = Graph(name="saxpy_probe")
    g.split(lambda xv, yv: saxpy(a, xv, yv, block=block, bounds_check=True,
                                 use_kernel=use_kernel), x, y_bc)
    g.split(lambda xv, yv: saxpy(a, xv, yv, block=block, bounds_check=False,
                                 use_kernel=use_kernel), x, y_nbc)
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

    def push(r):
        return particle_update(r, dt, block=block, use_kernel=use_kernel)

    g = Graph(name="particle_step")
    g.split(push, ions, writes=(0,))
    g.then_split(push, electrons, writes=(0,))
    g.then_split(lambda r: saxpy_record(r, dt, block=block,
                                        use_kernel=use_kernel),
                 field, writes=(0,))
    g.then_reduce(ions, vmax, MaxReducer(), field="v")
    return g, (ions, electrons, field), vmax


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


def build_flux_graph(nx: int, ny: int, *, lam_x: float = 0.1,
                     lam_y: float = 0.1, layout: Layout = Layout.SOA,
                     block=None, use_kernel: bool = True):
    """FORCE flux difference of ``u`` (halo (1, 1), transmissive) into
    ``flux``; returns ``(graph, (u, flux))``."""
    u = DistTensor("u", (nx, ny), spec=EULER_SPEC, layout=layout,
                   halo=(1, 1), boundary=Boundary.TRANSMISSIVE)
    out = DistTensor("flux", (nx, ny), spec=EULER_SPEC, layout=layout)
    g = make_flux_difference_graph(u, out, lam_x, lam_y, overlap=False,
                                   use_kernel=use_kernel, block=block)
    return g, (u, out)
