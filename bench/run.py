"""Run one cell of ``BENCHMARK.json`` once on the card and print the
result as one JSON line, the last line of standard output:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (import, inputs from the seed, the executor, the warm calls that
build and capture) counts from the process's start to the first timed
call.  Then the cell's calls run back to back for ``--seconds``, ended by
a synchronize; with ``--trace 1`` a stretch of calls after the window is
profiled for the per-layer metrics.  Then the outputs are checked against
the plain reference, and each number compared is printed with its limit
as the last lines of standard error.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and when a module of JAX or of the JAX package
was loaded.  Builds and kernel caches stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the script's own folder first on the path would shadow modules by the
# names of the benchmark's files; the checkout's root and the port's
# sources take its place
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
# the port builds its kernels into build/repro_torch/ of the checkout;
# any PyTorch extension, Triton or tuning cache stays beside them
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("REPRO_TUNE_CACHE", "tune-cache")):
    os.environ[var] = str(ROOT / "build" / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from bench import harness

    entry = harness.cell_entry(harness.load_benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda:0",
                         t_start=T_START)
    found = loaded_forbidden()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}: no "
              f"result", file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
