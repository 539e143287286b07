"""Driver of the eikonal configurations (paper Table 5): the port's
``workloads.build_eikonal_graph`` through ``Executor`` at its defaults,
each solve ``ex.run(inputs, 1)`` from the seed's input to the fixed
point, as a level-set code reinitialises its distance.

Input: the sources are the cells whose centre lies within half a cell of
the circle of radius ``n/4`` about a centre that the seed moves from the
grid's centre by U(-0.5, 0.5) cells on each axis; ``phi`` is 0 there and
drawn U(500, 1000) elsewhere, on the device from the seed.  So every seed
has its own source set and fixed point, and a solve's length moves with
the seed by a few iterations.  Every solve starts from this input (the
executor copies it in: the caller's input is never written), so every
solve has one answer.  The check compares every solve's iteration count,
and the ``phi`` of one solve drawn from the seed (reservoir sampling over
the run's solves), with the reference's.

Traffic (``traffic/<mix>.json``): closed-loop whole solves, with the
harness's ``warm_calls`` and ``profile_calls``.
"""

from __future__ import annotations

import random

import torch

from ..reference import eikonal as ref


def make_input(n: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(phi, mask)`` of the seed's input."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shift = torch.rand(2, generator=gen, device=device,
                       dtype=torch.float64) - 0.5
    c = torch.arange(n, dtype=torch.float64, device=device) + 0.5 - n / 2
    cx, cy = c - shift[0], c - shift[1]
    mask = (torch.hypot(cx[:, None], cy[None, :]) - n / 4).abs() <= 0.5
    far = torch.rand((n, n), generator=gen, device=device) * 500 + 500
    return torch.where(mask, 0.0, far), mask


class Cell:
    """One eikonal cell: ``call()`` runs one whole solve."""

    unit = "solve"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch import workloads
        from repro_torch.core import Executor

        self.config, self.device = config, torch.device(device)
        self.n = n = config["n"]
        self.block = tuple(config["block"])
        self.phi0, self.mask = make_input(n, seed, self.device)
        g, _, self.converging = workloads.build_eikonal_graph(
            n, inner=config["inner"], block=self.block,
            max_iters=config["max_iters"])
        self.ex = Executor(g, self.device)
        self.inputs = self.ex.init_state(phi=self.phi0, mask=self.mask)
        self.pick = random.Random(seed)
        self.solves = self.failed = self.iterations = 0
        self.counts: list = []
        self.sample = None

    def call(self) -> int:
        """One timed solve; returns 1.  A solve that raises (past
        ``max_iters``) counts as failed."""
        try:
            out = self.ex.run(self.inputs, 1)
        except RuntimeError:
            self.failed += 1
            self.counts.append(-1)
        else:
            it = self.converging.iterations
            self.counts.append(it)
            self.iterations += it
            if self.pick.randrange(len(self.counts)) == 0:
                self.sample = out["phi"].clone()
            del out
        self.solves += 1
        return 1

    def counters(self) -> dict:
        """What the program counts, and the solves so far."""
        return {"solves": self.solves, "failed": self.failed,
                "iterations": self.iterations,
                "trace_events": self.ex.cache_stats()["trace_events"],
                "wait_s": self.ex.async_stats["wait_s"]}

    def finish(self) -> None:
        """Let the executor go; the sampled ``phi`` stays."""
        self.inputs = self.ex = None

    def check(self) -> dict:
        """Every number compared, as ``{name: value}``; also keeps the
        reference's iteration count (``self.ref_iterations``)."""
        want, self.ref_iterations = reference(self.config, self.phi0,
                                              self.mask)
        return numbers(self.sample, self.counts, want, self.ref_iterations)


def reference(config: dict, phi0, mask, dtype=torch.float32):
    """The reference's solve of the input in ``dtype``: ``(phi,
    iterations)``."""
    return ref.solve(phi0.to(dtype), mask, inner=config["inner"],
                     block=tuple(config["block"]),
                     max_iters=config["max_iters"])


def numbers(phi, counts: list, want, ref_iterations: int) -> dict:
    """The numbers compared: the widest gap of the sampled solve's ``phi``
    from the reference's, in cells (``h = 1/n``; no sample, as when every
    solve failed, reads 1e30), and the largest distance of a solve's
    iteration count from the reference's (a failed solve counts -1)."""
    n = want.shape[0]
    gap = 1e30 if phi is None else \
        float((phi.double() - want.double()).abs().max()) * n
    return {"phi_gap": gap,
            "iterations_off": max(abs(c - ref_iterations) for c in counts)}
