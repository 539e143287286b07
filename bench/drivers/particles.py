"""Driver of the particle configurations (paper Table 3): the port's
``workloads.build_particle_graph`` (or, where the traffic logs a
diagnostic, ``build_particle_diagnostic_graph``) through ``Executor`` at
its defaults, ``state = ex.run(state, steps_per_call)`` back to back, as a
particle code runs between outputs.

Inputs: each record's storage drawn N(0, 1) in one call on the device
from the seed, in the layout the configuration declares, and rounded to
the reference's grid (``reference.particles.quantize``) so that with a
power-of-two ``dt`` every step's float32 additions are exact.  The
reference gets the same tensors; the check compares the final state of
the one state object that set-up made and the window advanced with the
closed form bit for bit, and every logged ``(t, vmax)``.

Traffic (``traffic/<mix>.json``): ``steps_per_call`` steps a timed call,
``diagnostic`` whether each step logs ``(t, vmax)`` to the host, and the
harness's ``warm_calls`` and ``profile_calls``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import particles as ref

COMPONENTS = {"ions": 6, "electrons": 6, "field": 2}


class Recorder:
    """The host diagnostic: keeps each step's ``(t, vmax)`` and the host
    clock at which it came, in a buffer made at set-up.  An object, so
    that the plan signature keys it by identity."""

    def __init__(self, capacity: int):
        self.log = np.zeros((capacity, 3))
        self.n = 0

    def __call__(self, t: float, vmax: float) -> None:
        self.log[self.n] = (t, vmax, time.perf_counter())
        self.n += 1


def storage(n: int, c: int, layout: str, gen, device) -> torch.Tensor:
    """``n`` records of ``c`` float32 components in ``layout``, N(0, 1)
    on the reference's grid."""
    if layout == "AOS":
        shape = (n, c)
    elif layout == "SOA":
        shape = (c, n)
    else:
        tile = np.gcd(n, 128)
        shape = (n // tile, c, tile)
    return ref.quantize(torch.randn(shape, generator=gen, device=device,
                                    dtype=torch.float32))


class Cell:
    """One particle cell: ``call()`` runs ``steps_per_call`` steps."""

    unit = "step"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch import workloads
        from repro_torch.core import Executor

        self.config, self.device = config, torch.device(device)
        self.n, self.dt = config["particles"], config["dt"]
        ref.exact_steps(self.dt)
        self.per_call = traffic["steps_per_call"]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.inputs = {k: storage(self.n, c, config["layouts"][k], gen,
                                  self.device)
                       for k, c in COMPONENTS.items()}
        if traffic["diagnostic"]:
            self.recorder = Recorder(config["log_capacity"])
            g, _, _ = workloads.build_particle_diagnostic_graph(
                self.n, self.recorder, block=config["block"], dt=self.dt)
        else:
            self.recorder = None
            g, _, _ = workloads.build_particle_graph(
                self.n, block=config["block"], dt=self.dt)
        self.ex = Executor(g, self.device)
        self.state = self.ex.init_state(**self.inputs)
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
                "wait_s": self.ex.async_stats["wait_s"],
                "logged": self.recorder.n if self.recorder else 0}

    def stamps(self, start: int, stop: int) -> np.ndarray:
        """The host clock of the diagnostics logged in ``[start, stop)``."""
        return self.recorder.log[start:stop, 2]

    def finish(self) -> None:
        """Keep the final state, let the executor go."""
        self.final = {k: self.state[k] for k in (*COMPONENTS, "vmax")}
        self.state = self.ex = None

    def check(self) -> dict:
        """Every number compared, as ``{name: value}``."""
        n = self.n
        got = {k: ref.components(self.final[k], n, c)
               for k, c in COMPONENTS.items()}
        log = None if self.recorder is None else \
            self.recorder.log[:self.recorder.n, :2]
        return numbers(got, self.start(), float(self.final["vmax"]), log,
                       self.dt, self.steps)

    def start(self) -> dict:
        """The inputs' ``(c, n)`` components by record."""
        return {k: ref.components(self.inputs[k], self.n, c)
                for k, c in COMPONENTS.items()}


def numbers(got: dict, start: dict, vmax: float, log, dt: float,
            steps: int) -> dict:
    """The numbers compared: each record's ``(c, n)`` components after
    ``steps`` steps (``got``) against the closed form from ``start``, the
    final ``vmax`` and, where a diagnostic logged them, every step's
    ``(t, vmax)`` (``log``, one row a step)."""
    want_vmax = ref.nan_ignoring_max(start["ions"][3:])
    out = {"x_off": sum(ref.off(got[s][:3], start[s][:3], start[s][3:],
                                dt, steps)
                        for s in ("ions", "electrons")),
           "y_off": ref.off(got["field"][1:], start["field"][1:],
                            start["field"][:1], dt, steps),
           "carried_changed": sum(ref.changed(got[s][3:], start[s][3:])
                                  for s in ("ions", "electrons"))
           + ref.changed(got["field"][:1], start["field"][:1]),
           "vmax_off": int(vmax != want_vmax)}
    if log is not None:
        m = min(len(log), steps)
        out["log_missing"] = abs(len(log) - steps)
        out["t_off"] = int((log[:m, 0] != ref.clock(steps, dt)[:m]).sum())
        out["vmax_log_off"] = int((log[:m, 1] != want_vmax).sum())
    return out
