"""What the benchmark's tests share: the small sizes at which a test run
drives a cell on the CPU, and running a cell there."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {"particles-t3": {"particles": 4096, "log_capacity": 100_000},
         "eikonal-t5": {"n": 64, "max_iters": 256}}
SEED = 2**31 + 11


def run_small(workload: str, trace: bool = False, seconds: float = 0.5,
              seed: int = SEED) -> dict:
    """One run of ``workload`` on the CPU at its configuration's small
    size, the look for a card skipped."""
    from bench import harness
    from repro_torch.core import clear_executable_cache

    clear_executable_cache()
    cfg = harness.cell_entry(harness.load_benchmark(), workload)["config"]
    return harness.run(workload, seed, seconds, trace, device="cpu",
                       overrides=SMALL[cfg])
