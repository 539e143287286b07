"""What a ``torch.profiler`` trace of the profiled stretch says: the
device's busy time (the union of its kernels, copies and fills), the
device time of each kernel by name, and the idle gaps, each labelled by
what the host was doing in it.

The stretch is the span of the ``bench.stretch`` annotation, which the
harness opens after a warm call (the profiler drops the first records of
a short call) and closes after a synchronize, so that every operation of
the stretch ends inside it.
"""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field

from .roofline import KERNEL_SYMBOLS

STRETCH = "bench.stretch"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")
# PyTorch's copies between strided tensors and its concatenation are
# kernels; with the memcpy nodes they are the halo fill's and the
# aliasing's copies
COPY_KERNELS = ("direct_copy_kernel", "CatArrayBatchedCopy")
# PyTorch's wrappers around the functor that names an elementwise kernel
GENERIC = ("gpu_kernel_impl_nocast", "gpu_kernel_impl", "BinaryFunctor",
           "AUnaryFunctor", "BUnaryFunctor")


@dataclass
class Stretch:
    """One profiled stretch.  ``kernels`` maps each device operation's
    name to ``[seconds, count]``; ``gaps`` holds ``(seconds, host)`` for
    every stretch of time in which the device ran nothing; ``counts``
    what the program did in the stretch (steps, iterations)."""

    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)
    gaps: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)

    def kernel_s(self, wrapper: str) -> tuple[float, int]:
        """Seconds and launches of one of the port's kernels."""
        sym = KERNEL_SYMBOLS[wrapper]
        hits = [v for k, v in self.kernels.items() if sym in k]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    def group_s(self, group: str) -> float:
        """Device seconds of ``"copies"`` (memcpy nodes and copy kernels)
        or ``"torch_ops"`` (every other operation that is none of the
        port's kernels)."""
        return sum(s for k, (s, _) in self.kernels.items()
                   if classify(k) == group)

    def breakdown(self, top: int = 10) -> dict:
        """The contract's ``breakdown``: the device operations that took
        most time, and the idle time summed by what the host was doing."""
        ops: dict = {}
        for k, (s, _) in self.kernels.items():
            ops[short(k)] = ops.get(short(k), 0.0) + s
        ops = sorted(([k, s] for k, s in ops.items()),
                     key=lambda e: -e[1])[:top]
        idle: dict = {}
        for s, host in self.gaps:
            idle[host] = idle.get(host, 0.0) + s
        gaps = sorted(([k, s] for k, s in idle.items()),
                      key=lambda e: -e[1])[:top]
        return {"device_ops": ops, "idle_gaps": gaps}


def short(name: str) -> str:
    """A kernel's name without its arguments and its templates' clutter:
    PyTorch's elementwise and reduction kernels by the functor they run
    (``elementwise_kernel[direct_copy_kernel_cuda]``)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    head = name.split("(", 1)[0]
    outer = head.split("<", 1)[0].rsplit("::", 1)[-1]
    if outer.endswith("elementwise_kernel") or "reduce_kernel" in outer:
        inner = [w for w in re.findall(
            r"\b(\w*Functor\w*|\w+_kernel_cuda|\w+_kernel|\w+_impl)\b", name)
            if w not in (outer, *GENERIC)]
        return f"{outer}[{inner[0]}]" if inner else outer
    return head[:120]


def classify(name: str) -> str:
    """``"kernel"`` for the port's hand-written kernels, ``"copies"``,
    or ``"torch_ops"``."""
    if any(sym in name for sym in KERNEL_SYMBOLS.values()):
        return "kernel"
    if name.startswith(("Memcpy", "memcpy")) or \
            any(c in name for c in COPY_KERNELS):
        return "copies"
    return "torch_ops"


def read(events: list, counts: dict) -> Stretch:
    """Reduce the trace's events (the ``traceEvents`` of the profiler's
    Chrome trace: ``cat``, ``name``, ``ts`` and ``dur`` in microseconds)
    to the stretch.  Raises when the trace holds no stretch annotation."""
    marks = [e for e in events if e.get("name") == STRETCH
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no bench.stretch annotation")
    a = float(marks[0]["ts"])
    b = a + float(marks[0]["dur"])
    dev, host = [], []
    for e in events:
        kind, d = e.get("cat"), float(e.get("dur", 0))
        s = float(e.get("ts", 0))
        if kind in DEVICE_ACTIVITIES:
            if d > 0 and s < b and s + d > a:
                dev.append((max(s, a), min(s + d, b), e["name"]))
        elif kind in HOST_ACTIVITIES and e.get("name") != STRETCH:
            host.append((s, s + d, e["name"]))
    kernels: dict = {}
    for s, t, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (t - s) * 1e-6
        k[1] += 1
    busy, gaps = _union(sorted(dev), a, b)
    return Stretch(window_s=(b - a) * 1e-6, busy_s=busy * 1e-6,
                   kernels=kernels, gaps=_label(gaps, host),
                   counts=dict(counts))


def _union(dev: list, a: int, b: int) -> tuple[int, list]:
    """Microseconds covered by the intervals (sorted by start), and the
    uncovered gaps of ``[a, b]`` as ``(start, end)``."""
    busy, gaps, end = 0, [], a
    for s, t, _ in dev:
        if s > end:
            gaps.append((end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    if b > end:
        gaps.append((end, b))
    return busy, gaps


def _label(gaps: list, host: list) -> list:
    """Each gap's seconds and the innermost host event running at its
    midpoint ("none" where no host event ran)."""
    host.sort()
    out, heap, i = [], [], 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= mid:
            s, t, name = host[i]
            heapq.heappush(heap, (t - s, t, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out.append(((g1 - g0) * 1e-6, heap[0][2] if heap else "none"))
    return out
