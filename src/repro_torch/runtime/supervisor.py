"""Host-side supervisor, as ``repro.runtime.supervisor``: the dynamic
layer of the system, across steps and failures.

* **checkpoint/restart** — periodic async checkpoints; on a step failure
  the state is restored from the last checkpoint and the steps replayed
  (the data pipeline is a pure function of the step counter, so the
  replay is exact);
* **retry with backoff** — transient errors (preemption, injected chaos
  through :mod:`~repro_torch.runtime.faults`) retry through the shared
  :class:`~repro_torch.runtime.faults.RetryPolicy`, at most
  ``max_failures`` failures a run and ``max_retries_per_step``
  consecutive failures of one step (the budget resets when a restore
  rewinds to an earlier step); other errors re-raise at once;
* **straggler detection** — a Welford mean and variance of each step's
  completion time (:class:`StepStats`);
* **re-placement** — :meth:`Supervisor.resize` moves the live state
  through the host onto other devices, the reference's slow but always
  correct re-mesh path.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..checkpoint.store import device_of, named_leaves
from .faults import RetryPolicy, TransientError, trip

__all__ = ["TransientError", "StepStats", "Supervisor"]


@dataclass
class StepStats:
    """Welford tracker of per-step COMPLETION wall time.

    ``dt`` passed to :meth:`update` is measured after the step's outputs
    are on the host (a ``torch.cuda.synchronize`` or a device-to-host
    read); the time the call took to return may be passed as
    ``dispatch=``, kept apart."""

    count: int = 0
    mean: float = 0.0
    m2: float = 0.0
    last: float = 0.0
    last_dispatch: float = 0.0
    dispatch_mean: float = 0.0
    stragglers: list = field(default_factory=list)

    def update(self, dt: float, step: int, zscore: float = 3.0,
               dispatch: Optional[float] = None) -> bool:
        """Welford update with a completion time ``dt``; returns True if
        this step was a straggler (after 8 steps, slower than ``mean +
        zscore * std``)."""
        self.last = dt
        self.count += 1
        d = dt - self.mean
        self.mean += d / self.count
        self.m2 += d * (dt - self.mean)
        if dispatch is not None:
            self.last_dispatch = dispatch
            self.dispatch_mean += (dispatch - self.dispatch_mean) \
                / self.count
        if self.count >= 8:
            std = math.sqrt(self.m2 / (self.count - 1))
            if std > 0 and dt > self.mean + zscore * std:
                self.stragglers.append((step, dt))
                return True
        return False

    @property
    def std(self) -> float:
        """Standard deviation of the completion times."""
        return math.sqrt(self.m2 / max(self.count - 1, 1))

    @property
    def overlap_ms(self) -> float:
        """Mean milliseconds per step between return and completion (0
        when dispatch was never reported)."""
        if self.dispatch_mean <= 0.0:
            return 0.0
        return max(self.mean - self.dispatch_mean, 0.0) * 1e3


def _synchronize(state: Any) -> None:
    """Wait for the device work of every CUDA device ``state`` lives on."""
    devices = {leaf.device for _, leaf, _ in named_leaves(state)
               if leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclass
class Supervisor:
    """Drives ``state = step_fn(state, batch_at(step))`` with fault
    tolerance.

    Transient failures restore from the last checkpoint and retry under
    ``retry``.  Recovery episodes are logged in :attr:`recoveries` as
    ``(failed_step, resumed_step, recovery_ms)``: the wall time from the
    failure until the failed step next completes.  A step's completion
    time is taken after a ``torch.cuda.synchronize`` on the state's
    devices; the time the step function took to return goes to
    ``StepStats.update(dispatch=)``.  ``state_devices`` (a device, or a
    dict of leaf name -> device; None keeps each leaf where it is) is
    where a restore places the state, as the reference's
    ``state_shardings``."""

    step_fn: Callable[[Any, Any], Any]
    ckpt: Any            # a checkpoint.CheckpointManager
    ckpt_every: int = 50
    max_failures: int = 10
    max_retries_per_step: int = 3
    straggler_zscore: float = 3.0
    state_devices: Any = None
    log: Callable[[str], None] = print
    retry: RetryPolicy = field(
        default_factory=lambda: RetryPolicy(base_delay=0.01, max_delay=0.25))

    stats: StepStats = field(default_factory=StepStats)
    failures: int = 0
    recoveries: list = field(default_factory=list)

    def run(self, state: Any, batch_at: Callable[[int], Any],
            start_step: int, num_steps: int,
            on_step: Optional[Callable[[int, Any], None]] = None) -> Any:
        """Run steps ``[start_step, start_step + num_steps)``; returns the
        state."""
        step = start_step
        end = start_step + num_steps
        retries = 0
        pending = []  # (failed_step, t_fail) awaiting a successful replay
        while step < end:
            try:
                t0 = time.perf_counter()
                trip("supervisor.step", step=step)
                state = self.step_fn(state, batch_at(step))
                t_dispatch = time.perf_counter() - t0
                _synchronize(state)
                dt = time.perf_counter() - t0
                if self.stats.update(dt, step, self.straggler_zscore,
                                     dispatch=t_dispatch):
                    self.log(f"[supervisor] straggler step {step}: "
                             f"{dt*1e3:.1f}ms (mean "
                             f"{self.stats.mean*1e3:.1f})")
                retries = 0
                now = time.perf_counter()
                for failed, t_fail in [p for p in pending if p[0] <= step]:
                    self.recoveries.append(
                        (failed, step, (now - t_fail) * 1e3))
                    pending.remove((failed, t_fail))
                step += 1
                if on_step is not None:
                    on_step(step, state)
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state, extra={"step": step})
            except Exception as e:
                if not self.retry.is_transient(e):
                    raise
                t_fail = time.perf_counter()
                self.failures += 1
                retries += 1
                if self.failures > self.max_failures:
                    raise RuntimeError(
                        f"exceeded max_failures={self.max_failures}") from e
                if retries > self.max_retries_per_step:
                    raise RuntimeError(
                        f"step {step} failed {retries} times") from e
                self.log(f"[supervisor] transient failure at step {step} "
                         f"({e}); restoring last checkpoint "
                         f"(retry {retries}, backoff "
                         f"{self.retry.backoff(retries)*1e3:.0f}ms)")
                self.retry.backoff_sleep(retries)
                state, new_step = self._restore(state, step)
                if new_step < step:
                    # rewound to an earlier checkpoint: the replayed
                    # steps start with a fresh per-step retry budget
                    retries = 0
                pending.append((step, t_fail))
                step = new_step
        self.ckpt.wait()
        return state

    def _restore(self, state, failed_step: int):
        # a save may still be on its writer thread: wait for it, so the
        # restore resumes from the newest checkpoint
        self.ckpt.wait()
        last = self.ckpt.latest_step()
        if last is None:  # nothing saved yet: restart from the given state
            return state, failed_step
        _, restored, extra = self.ckpt.restore_latest(
            state, devices=self.state_devices)
        self.log(f"[supervisor] resumed from checkpoint step {last}")
        return restored, int(extra.get("step", last))

    def resize(self, state: Any, devices: Any) -> Any:
        """Re-place the live state on ``devices`` (a device, or a dict of
        leaf name -> device): every leaf is pulled to the host, then put on
        its device in its place.  Later restores use the same placement."""
        leaves = [(name, leaf.detach().to("cpu"), setter)
                  for name, leaf, setter in named_leaves(state)]
        for name, host, setter in leaves:
            dev = device_of(devices, name)
            if dev is None:
                continue
            if setter is None:
                raise TypeError(f"{name}: a bare tensor cannot be moved")
            setter(host.to(dev))
        self.state_devices = devices
        return state
