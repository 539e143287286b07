"""The control of each cell's comparison: the plain reference put in the
program's place, computed in the nearest precision below the one the
configuration states (bfloat16 for float32), from the inputs a run of
the cell makes from each seed, judged by the same numbers and limits as
a run.  Every seed has to come out not correct: each line names the
numbers that read over their limit.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--steps K]

``--steps`` is how many steps a particle cell's control takes (a run of
the cell at its window takes about as many).  The benchmark's runs never
run this; ``tests/test_bench_control.py`` runs it at a small size.
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

import torch  # noqa: E402

from bench import harness  # noqa: E402
from bench.drivers import eikonal, particles  # noqa: E402
from bench.reference import particles as pref  # noqa: E402


def readings(workload: str, seed: int, steps: int, device="cuda",
             overrides=None, root=harness.ROOT) -> dict:
    """The control's numbers for one seed, with the limits they are held
    to and the names of those over their limit."""
    bench = harness.load_benchmark(root)
    entry = harness.cell_entry(bench, workload)
    config = {**harness.load_json("configs", entry["config"], root / "bench"),
              **(overrides or {})}
    traffic = harness.load_json("traffic", entry["traffic"], root / "bench")
    low = torch.bfloat16
    t0 = time.perf_counter()
    if config["driver"] == "particles":
        n = config["particles"]
        gen = torch.Generator(device=device).manual_seed(seed)
        start = {k: pref.components(
            particles.storage(n, c, config["layouts"][k], gen, device), n, c)
            for k, c in particles.COMPONENTS.items()}
        got, vmax, log = pref.step_lower(start, config["dt"], steps, low)
        nums = particles.numbers(got, start, vmax,
                                 log if traffic["diagnostic"] else None,
                                 config["dt"], steps)
    else:
        phi0, mask = eikonal.make_input(config["n"], seed, device)
        want, iters = eikonal.reference(config, phi0, mask)
        got, got_iters = eikonal.reference(config, phi0, mask, dtype=low)
        nums = eikonal.numbers(got, [got_iters], want, iters)
    limits = config["limits"]
    return {"workload": workload, "seed": seed,
            "seconds": time.perf_counter() - t0, "numbers": nums,
            "limits": {k: limits[k] for k in nums},
            "over": [k for k, v in nums.items() if not v <= limits[k]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, default=1400)
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
