"""The part of the host-side supervisor that serving needs: per-step
completion-time statistics with straggler detection, and the transient
error class.  Checkpoint/restart, the training loop and elastic re-mesh
of ``repro.runtime.supervisor`` are in ROADMAP queue 4."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from .faults import TransientError

__all__ = ["TransientError", "StepStats"]


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
