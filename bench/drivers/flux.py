"""Driver of the finite-volume configurations (paper Table 4, §8): the
port's ``workloads.build_force_march_graph`` through ``Executor`` at its
defaults, ``state = ex.run(state, steps_per_call)`` back to back, as a
finite-volume code marches its grid between outputs: per step the
transmissive halo fill of the four-field record ``u``, K4's FORCE flux
difference ``du`` at twice the step's ``lam_x`` and ``lam_y``, and the
update ``u <- u - du / 2`` (the mean of the two one-dimensional steps of
``2 dt``; ``reference/flux.py`` says why).

Input: the Mach-3.81 shock and low-density bubble of Fig. 11, built by
the reference (``reference/flux.py``'s ``shock_bubble``), with each
element multiplied by U(0.99, 1.01), drawn on the device from the
seed.

The check: after the profiled stretch the driver keeps ``u``, runs one
more call through the same executor and its captured pieces, and keeps
``u`` again.  The reference (``reference/flux.py``) marches the first
state as many steps in float64; ``u_gap`` is, over the record's three
fields (``rho``, ``E`` and the momentum vector), the largest of each
field's widest gap from the reference over that field's largest
magnitude in the reference.  ``nonfinite`` counts the final
state's elements that are not finite, and ``cfl_max`` is its Courant
number ``lam_x max(|u| + c) + lam_y max(|v| + c)`` (NaN, and so over its
limit, where a pressure went negative).

Traffic (``traffic/<mix>.json``): ``steps_per_call`` steps a timed call,
and the harness's ``warm_calls`` and ``profile_calls``.
"""

from __future__ import annotations

import torch

from ..reference import flux as ref

# the record's fields by component: rho, E and the momentum vector, whose
# two components share one scale (so that a component that is nearly 0,
# as rho v is at the start, is not judged by its own magnitude)
FIELDS = (slice(0, 1), slice(1, 2), slice(2, 4))


def make_input(nx: int, ny: int, seed: int, device) -> torch.Tensor:
    """The seed's ``(4, nx, ny)`` float32 state."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = ref.shock_bubble(nx, ny, device=device)
    return u.mul_(torch.rand(u.shape, generator=gen, device=device)
                  .mul_(0.02).add_(0.99))


class Cell:
    """One finite-volume cell: ``call()`` runs ``steps_per_call`` steps."""

    unit = "step"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch import workloads
        from repro_torch.core import Executor, Layout, RecordArray
        from repro_torch.physics.euler import EULER_SPEC

        build = workloads.build_force_march_graph
        self.config, self.device = config, torch.device(device)
        nx, ny = config["nx"], config["ny"]
        self.lam = (config["lam_x"], config["lam_y"])
        self.per_call = traffic["steps_per_call"]
        g, (self.u, _) = build(nx, ny, lam_x=self.lam[0], lam_y=self.lam[1],
                               layout=Layout[config["layout"]])
        self.ex = Executor(g, self.device)
        u0 = make_input(nx, ny, seed, self.device)
        self.state = self.ex.init_state(
            u=RecordArray(u0, EULER_SPEC, Layout.SOA))
        del u0
        self.steps = 0

    def call(self) -> int:
        """One timed call; returns the steps it ran."""
        self.state = self.ex.run(self.state, self.per_call)
        self.steps += self.per_call
        return self.per_call

    def counters(self) -> dict:
        """What the program counts, and the steps so far."""
        cache = self.ex.cache_stats()
        return {"steps": self.steps, "trace_events": cache["trace_events"],
                "halo_bytes": cache["halo_bytes"]}

    def fields(self) -> torch.Tensor:
        """The state's ``u`` as ``(4, nx, ny)`` fields, whatever its
        layout (a view where it is SoA)."""
        from repro_torch.physics.euler import stack_state

        return stack_state(self.ex.read(self.state, self.u))

    def finish(self) -> None:
        """Keep ``u``, run one more call through the same executor, keep
        ``u`` again; then let the executor go."""
        self.start = self.fields().clone()
        self.call()
        self.final = self.fields().clone()
        self.state = self.ex = None

    def check(self) -> dict:
        """Every number compared, as ``{name: value}``."""
        want = ref.march(self.start.double(), *self.lam, self.per_call)
        return numbers(self.final, want, *self.lam)


def numbers(got: torch.Tensor, want: torch.Tensor, lam_x: float,
            lam_y: float) -> dict:
    """The numbers compared: ``got``, a ``(4, nx, ny)`` final state, held
    to the reference's ``want`` after the same steps from the same
    state."""
    gaps = []
    for sl in FIELDS:
        g, w = got[sl], want[sl].double()
        scale = max(float(w.abs().max()), torch.finfo(torch.float64).tiny)
        gaps.append(float((g.double() - w).abs().max()) / scale)
    nan = [x for x in gaps if x != x]
    return {"u_gap": nan[0] if nan else max(gaps),
            "nonfinite": int((~torch.isfinite(got)).sum()),
            "cfl_max": ref.wavespeed_sum(got, lam_x, lam_y)}
