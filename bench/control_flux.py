"""The control of the finite-volume cells (``bench/control.py`` takes
the particle and eikonal configurations): the plain reference put in
the program's place, computed in bfloat16, the nearest precision below
the configuration's float32, from the input a run of the cell makes from
each seed.  It marches ``--steps`` steps in bfloat16 in place of the
window, keeps the state, and marches one more call's steps in bfloat16;
that call is judged by the run's numbers against the float64 reference
from the kept state, with the run's limits.  Every seed has to come out
not correct: each line names the numbers over their limit.

    python3 bench/control_flux.py --workload flux.4096 --seeds <n> [...] \\
        [--steps K]

The benchmark's runs never run this; ``tests/test_bench_flux.py`` runs
it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

from bench import harness  # noqa: E402
from bench.drivers import flux  # noqa: E402
from bench.reference import flux as ref  # noqa: E402


def readings(workload: str, seed: int, steps: int, device="cuda",
             overrides=None, root=harness.ROOT) -> dict:
    """The control's numbers for one seed, with the limits they are held
    to and the names of those over their limit."""
    bench = harness.load_benchmark(root)
    entry = harness.cell_entry(bench, workload)
    config = {**harness.load_json("configs", entry["config"], root / "bench"),
              **(overrides or {})}
    traffic = harness.load_json("traffic", entry["traffic"], root / "bench")
    lam = (config["lam_x"], config["lam_y"])
    t0 = time.perf_counter()
    u = flux.make_input(config["nx"], config["ny"], seed, device)
    start = ref.march(u.to(torch.bfloat16), *lam, steps)
    got = ref.march(start, *lam, traffic["steps_per_call"])
    want = ref.march(start.double(), *lam, traffic["steps_per_call"])
    nums = flux.numbers(got.float(), want, *lam)
    limits = config["limits"]
    return {"workload": workload, "seed": seed,
            "seconds": time.perf_counter() - t0, "numbers": nums,
            "limits": {k: limits[k] for k in nums},
            "over": [k for k, v in nums.items() if not v <= limits[k]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, default=3000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.steps)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
