"""Deterministic fault injection + the shared retry/backoff policy.

The runtime's fault tolerance used to be exercised only by tests raising
:class:`TransientError` from user step functions — none of the real
failure surfaces (in-flight host futures, dispatched device regions,
per-block halo transfers, the tuning cache, checkpoint writes) could be
made to fail on demand.  This module makes failures first-class and
*deterministic*:

* a :class:`FaultPlan` schedules named :class:`Fault`\\ s at specific
  ``(step, site)`` coordinates.  Sites are fixed strings compiled into
  the runtime layers (see :data:`SITES`): each layer calls
  :func:`trip` at its injection point, which is a no-op until a plan is
  installed (:func:`fault_scope`).  A fault either raises (transient or
  deterministic), sleeps (straggler/hang), or asks the site to corrupt
  its artifact (tuning-cache files) — always at the same coordinates
  for the same plan, so chaos tests are bitwise-reproducible;
* a :class:`RetryPolicy` centralizes transient-vs-deterministic error
  classification and exponential backoff with *deterministic* jitter
  (seeded splitmix, not ``random.random``), replacing the ad-hoc
  retry loops in ``Supervisor.run`` and ``Batcher.step``.

Everything here is stdlib-only (no jax) so every runtime layer — core
executor, halo exchange, tuning cache, checkpoint store — can import it
without cycles.

Example::

    plan = FaultPlan([Fault("executor.region", nth=3),
                      Fault("batcher.step", step=7, times=2)])
    with fault_scope(plan):
        run_the_workload()          # faults fire at those coordinates
    assert plan.fired  # [(site, detail, step, Fault), ...]
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = [
    "SITES", "TransientError", "InjectedFault", "InjectedDeterministicFault",
    "HostTimeoutError", "Fault", "FaultPlan", "fault_scope", "install",
    "current_plan", "trip", "RetryPolicy",
]

#: The named injection points compiled into the runtime layers.  A
#: :class:`Fault` whose ``site`` is not in this registry is rejected at
#: plan construction (catches typos before a chaos run silently no-ops).
SITES = {
    "executor.region":    "device-region dispatch (before the executable "
                          "call — caller state is never half-donated)",
    "executor.host":      "host-node callback invocation (sync inline or "
                          "on the ripple-host pool)",
    "executor.dispatch":  "host-pool submission from the event-driven "
                          "dispatcher",
    "halo.block":         "one scheduled halo-block transfer "
                          "(fires at trace/build time)",
    "batcher.step":       "decode step of the continuous batcher",
    "batcher.admit":      "admission scatter of one request into a slot",
    "supervisor.step":    "one supervised training step",
    "tuning.cache.load":  "tuning-cache file read (corrupt kind garbles "
                          "the file first)",
    "checkpoint.save":    "checkpoint directory write",
}


class TransientError(RuntimeError):
    """A retryable failure (preemption / link flap / injected chaos).

    Historically defined in ``runtime/supervisor.py`` (which still
    re-exports it); it lives here so stdlib-only layers can classify
    errors without importing the supervisor."""


class InjectedFault(TransientError):
    """A transient failure raised by :func:`trip` — subclasses
    :class:`TransientError` so every existing retry path recovers from
    injected chaos exactly as it would from a real preemption."""


class InjectedDeterministicFault(RuntimeError):
    """An injected NON-retryable failure: retry policies must re-raise it
    (the budget/classification tests use it)."""


class HostTimeoutError(TransientError):
    """A host callback (or the frontier drain waiting on it) exceeded the
    executor's ``host_timeout`` watchdog.  Transient: the callback's
    successors are cancelled, the executor remains usable, and a retry
    (possibly after ladder demotion) may succeed."""


def _splitmix(x: int) -> int:
    """Deterministic 64-bit mix (same generator the data pipeline uses)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: *where* (``site`` + optional ``match`` on the
    site's detail string), *when* (``step`` — the site-reported step
    counter — or ``nth``, the 0-based visit index at that site, for
    layers that have no step notion), *what* (``kind``), and *how many*
    consecutive matching visits fire (``times``).

    Kinds:

    * ``"error"`` — raise :class:`InjectedFault` (transient) or, with
      ``transient=False``, :class:`InjectedDeterministicFault`;
    * ``"delay"`` — sleep ``delay_s`` seconds then continue (straggler /
      hung-callback injection; pair with the executor's ``host_timeout``
      watchdog to simulate a hang);
    * ``"corrupt"`` — no raise; :func:`trip` returns the fault and the
      site garbles its artifact (e.g. the tuning-cache JSON file).
    """

    site: str
    step: Optional[int] = None
    nth: Optional[int] = None
    kind: str = "error"
    transient: bool = True
    delay_s: float = 0.0
    match: Optional[str] = None
    times: int = 1

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} — "
                             f"known sites: {sorted(SITES)}")
        if self.kind not in ("error", "delay", "corrupt"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.step is None and self.nth is None:
            raise ValueError("a Fault needs a coordinate: step= or nth=")


class FaultPlan:
    """A deterministic schedule of :class:`Fault`\\ s plus the visit/fire
    log of one chaos run.

    Thread-safe (host callbacks trip from pool threads).  ``seed``
    derives deterministic per-fault delays when ``delay_s`` is a
    ``(lo, hi)`` range.  Introspection: :attr:`visits` counts trips per
    site, :attr:`fired` logs every fault that actually fired as
    ``(site, detail, step, fault)``, and :meth:`report` renders both."""

    def __init__(self, faults, seed: int = 0):
        self.faults = list(faults)
        self.seed = int(seed)
        self.visits: dict[str, int] = {}
        self.fired: list[tuple] = []
        self._shots: dict[int, int] = {}   # fault index -> times fired
        self._lock = threading.Lock()

    def _delay_of(self, idx: int, f: Fault) -> float:
        d = f.delay_s
        if isinstance(d, tuple):
            lo, hi = d
            u = _splitmix(self.seed * 0x10001 + idx) / float(1 << 64)
            return lo + (hi - lo) * u
        return float(d)

    def trip(self, site: str, detail: str = "",
             step: Optional[int] = None) -> Optional[Fault]:
        """One visit to ``site``: fire the first armed matching fault.

        Raises for ``error`` kinds, sleeps for ``delay`` kinds, returns
        the fault for ``corrupt`` kinds (the site acts on it), returns
        None when nothing fires."""
        with self._lock:
            n = self.visits.get(site, 0)
            self.visits[site] = n + 1
            hit = None
            for i, f in enumerate(self.faults):
                if f.site != site:
                    continue
                if self._shots.get(i, 0) >= f.times:
                    continue
                if f.match is not None and f.match not in detail:
                    continue
                if f.step is not None:
                    if step is None or step != f.step:
                        continue
                elif f.nth is not None and n < f.nth:
                    continue
                self._shots[i] = self._shots.get(i, 0) + 1
                self.fired.append((site, detail, step, f))
                hit = (i, f)
                break
        if hit is None:
            return None
        i, f = hit
        if f.kind == "delay":
            time.sleep(self._delay_of(i, f))
            return f
        if f.kind == "corrupt":
            return f
        where = f"{site}[{detail}]" if detail else site
        at = f"step {step}" if step is not None else f"visit {n}"
        if f.transient:
            err = InjectedFault(f"injected fault at {where} ({at})")
        else:
            err = InjectedDeterministicFault(
                f"injected deterministic fault at {where} ({at})")
        err.site = site  # lets the degradation ladder attribute failures
        raise err

    def exhausted(self) -> bool:
        """True when every scheduled fault has fired all its ``times``."""
        with self._lock:
            return all(self._shots.get(i, 0) >= f.times
                       for i, f in enumerate(self.faults))

    def report(self) -> str:
        """Human-readable visit counts and fired-fault log."""
        lines = ["fault plan:"]
        for site, n in sorted(self.visits.items()):
            lines.append(f"  visited {site} x{n}")
        for site, detail, step, f in self.fired:
            at = f"step {step}" if step is not None else f"nth={f.nth}"
            lines.append(f"  FIRED {f.kind} at {site}"
                         f"{f'[{detail}]' if detail else ''} ({at})")
        if not self.fired:
            lines.append("  (nothing fired)")
        return "\n".join(lines)


# the active plan is process-global (host callbacks trip from pool
# threads, so a thread-local would miss them)
_ACTIVE: Optional[FaultPlan] = None
_ACTIVE_LOCK = threading.Lock()


def install(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` as the process-wide active fault plan (None to
    uninstall).  Prefer the :func:`fault_scope` context manager."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = plan


def current_plan() -> Optional[FaultPlan]:
    """The active :class:`FaultPlan`, or None (no injection)."""
    return _ACTIVE


@contextmanager
def fault_scope(plan: FaultPlan):
    """Install ``plan`` for the duration of the block, always
    uninstalling on exit (even on an escaped injected fault)."""
    install(plan)
    try:
        yield plan
    finally:
        install(None)


def trip(site: str, detail: str = "", step: Optional[int] = None):
    """The injection point every runtime layer calls: a no-op (fast
    path: one global read) unless a plan is installed, else
    :meth:`FaultPlan.trip`."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.trip(site, detail, step)


# -- shared retry/backoff policy -----------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter + transient
    classification — the ONE retry policy the Supervisor, the Batcher,
    and the chaos harness share (each keeps its own recovery action:
    checkpoint restore, request-log replay, plain re-invoke).

    ``backoff(attempt)`` for attempt 1, 2, ... is
    ``min(max_delay, base_delay * multiplier**(attempt-1))`` scaled by
    ``1 + jitter * u`` where ``u in [0, 1)`` is a splitmix hash of
    ``(seed, attempt)`` — reproducible, unlike ``random.random``
    jitter, so chaos runs are bitwise-repeatable wall-clock included.
    ``sleep`` is injectable so tests can run backoff-free."""

    max_retries: int = 3
    base_delay: float = 0.02
    max_delay: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.25
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep
    transient_types: tuple = ()

    def is_transient(self, exc: BaseException) -> bool:
        """Retryable?  :class:`TransientError` (and its injected/watchdog
        subclasses) plus any ``transient_types`` extras; everything else
        — including :class:`InjectedDeterministicFault` — is
        deterministic and must re-raise."""
        if isinstance(exc, InjectedDeterministicFault):
            return False
        return isinstance(exc, TransientError) \
            or isinstance(exc, self.transient_types)

    def backoff(self, attempt: int) -> float:
        """The deterministic backoff delay before retry ``attempt``
        (1-based)."""
        base = min(self.max_delay,
                   self.base_delay * self.multiplier ** max(attempt - 1, 0))
        u = _splitmix(self.seed * 0x9E3779B1 + attempt) / float(1 << 64)
        return base * (1.0 + self.jitter * u)

    def backoff_sleep(self, attempt: int) -> float:
        """Sleep the backoff delay for ``attempt``; returns the delay."""
        d = self.backoff(attempt)
        if d > 0:
            self.sleep(d)
        return d

    def call(self, fn: Callable, *args,
             on_retry: Optional[Callable[[int, BaseException], None]] = None):
        """Run ``fn(*args)``, retrying transient failures up to
        ``max_retries`` times with backoff.  Deterministic failures and
        budget exhaustion re-raise the original exception."""
        attempt = 0
        while True:
            try:
                return fn(*args)
            except Exception as exc:
                if not self.is_transient(exc):
                    raise
                attempt += 1
                if attempt > self.max_retries:
                    raise
                if on_retry is not None:
                    on_retry(attempt, exc)
                self.backoff_sleep(attempt)
