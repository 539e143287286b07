#!/usr/bin/env python3
"""Compare another checkout's async dispatcher with this one's on one GPU.

    python3 tools/async_ab.py OTHER_EXECUTOR_PY [--rounds N]

OTHER_EXECUTOR_PY is ``src/repro_torch/core/executor.py`` of another
checkout (for example the parent commit unpacked with ``git archive``).
Its ``_AsyncRun`` and the helpers defined with it are executed in this
checkout's executor module, and the two dispatchers take turns (other,
this, this, other, ...) on ``chip_smoke.py`` phase 3c's overlap
measurement: the particle step at 2^24 particles per species with a host
diagnostic that sleeps the synchronous step's time, 100 steps a run, the
median of 3 runs each way.  Per turn it prints ms per step sync and async,
the mean sleep on the callback's thread, the gain (sync / async) and the
async step's time beyond its sleep; then, per dispatcher, the gains' median,
minimum and maximum.  Everything else (kernels, captured graphs, the sync
path) is this checkout's.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))


def other_async_run(path: str, module):
    """The ``_AsyncRun`` class of the executor source at ``path``, its
    block (from the host pool's lock to ``RelayoutStep``) executed in a
    copy of ``module``'s namespace."""
    src = open(path).read()
    start = src.index("_HOST_POOL: Optional[ThreadPoolExecutor] = None")
    end = src.index("@dataclass(frozen=True)\nclass RelayoutStep")
    ns = dict(module.__dict__)
    exec(compile(src[start:end], path, "exec"), ns)
    return ns["_AsyncRun"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("async_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import workloads
    from repro_torch.core import Executor, clear_executable_cache
    from repro_torch.core import executor as ex_mod
    from repro_torch.kernels import _build

    variants = {"other": other_async_run(args.other, ex_mod),
                "this": ex_mod._AsyncRun}
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    diag = cs.Diagnostic()
    g, _, _ = workloads.build_particle_diagnostic_graph(cs.PARTICLE_N, diag)
    _, inp, _, _ = cs.regions_graph("particle_step", 0)
    steps = cs.PARTICLE_STEPS

    def whole(ex):
        state = ex.init_state(**inp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.run(state, steps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    keep = {}
    for mode in (False, True):
        clear_executable_cache()
        keep[mode] = Executor(g, regions=True, donate=True,
                              async_regions=mode)
        whole(keep[mode])
    diag.host_s = statistics.median(
        whole(keep[False]) for _ in range(cs.ASYNC_REPS)) / 1e3
    print(f"host time {1e3 * diag.host_s:.3f} ms a callback", flush=True)
    gains = {k: [] for k in variants}
    order = ["other", "this", "this", "other"] * args.rounds
    try:
        for name in order:
            ex_mod._AsyncRun = variants[name]
            ms, slept = {}, {}
            for mode in (False, True):
                diag.reset()
                ms[mode] = statistics.median(
                    whole(keep[mode]) for _ in range(cs.ASYNC_REPS))
                slept[mode] = 1e3 * statistics.mean(diag.slept)
            gain = ms[False] / ms[True]
            gains[name].append(gain)
            print(f"{name}: sync {ms[False]:.3f} ms a step (sleep "
                  f"{slept[False]:.3f}), async {ms[True]:.3f} (sleep "
                  f"{slept[True]:.3f}), gain {gain:.3f}, async beyond its "
                  f"sleep {ms[True] - slept[True]:.3f} ms", flush=True)
    finally:
        ex_mod._AsyncRun = variants["this"]
        diag.host_s = 0.0
    for name, gs in gains.items():
        print(f"{name}: gain median {statistics.median(gs):.3f}, min "
              f"{min(gs):.3f}, max {max(gs):.3f} over {len(gs)} turns "
              f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
