"""One run of one cell: resolve the cell's files by name, set up, warm up,
measure for the window, profile a stretch (``--trace 1``), check the
outputs against the reference, read the metrics, build the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The configuration's file (``configs/<config>.json``) names its driver
(``drivers/<driver>.py``), which builds the port's graph at the file's
sizes, makes the inputs from the seed, drives the timed calls with the
mix's parameters (``traffic/<traffic>.json``) and compares the outputs
with ``reference/``; the file also holds the limit of each number
compared.  Each metric is read by ``metrics/<metric>.py``'s ``read(run)``,
which returns None where the cell has nothing for it to read.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from . import profile as profile_mod

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


@dataclass
class Run:
    """What one run measured, as the metric readers see it.  ``before``
    and ``after`` are the driver's counters around the window; ``stretch``
    is the profiled stretch (``--trace 1``) or None."""

    cell: Any
    config: dict
    setup_s: float
    window_s: float
    units: int
    before: dict
    after: dict
    stretch: Optional[profile_mod.Stretch] = None

    def delta(self, key: str):
        """How much a counter grew across the window."""
        return self.after[key] - self.before[key]


def load_benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` of the checkout at ``root``."""
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(benchmark: dict, workload: str) -> dict:
    """The ``workloads`` entry named ``workload``."""
    for w in benchmark["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {workload!r}")


def metrics_for(benchmark: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: the end-to-end
    ones without trace, the per-layer ones with it, each where its
    ``workloads`` list (if any) names the cell."""
    group = benchmark["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def reader(name: str, bench: Path = BENCH):
    """``read`` of ``metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    """``<kind>/<name>.json`` of the benchmark's folder."""
    return json.loads((bench / kind / f"{name}.json").read_text())


def driver(name: str):
    """The module ``drivers/<name>.py``."""
    return importlib.import_module(f"bench.drivers.{name}")


def synchronize(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile_stretch(cell, calls: int, device) -> profile_mod.Stretch:
    """Profile ``calls`` timed calls after one warm call under the
    profiler; only the stretch's annotation is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        cell.call()
        synchronize(device)
        c0 = cell.counters()
        with record_function(profile_mod.STRETCH):
            for _ in range(calls):
                with record_function("bench.call"):
                    cell.call()
            synchronize(device)
        c1 = cell.counters()
    counts = {k: c1[k] - c0[k] for k in c0}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return profile_mod.read(events, counts)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", root: Path = ROOT, overrides: Optional[dict] = None,
        t_start: Optional[float] = None) -> dict:
    """One run of ``workload``; returns the result line as a dict.
    ``overrides`` replace keys of the configuration (the tests' small
    sizes); ``t_start`` is the process's start on the host clock."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    t_run = time.perf_counter()
    bench = load_benchmark(root)
    entry = cell_entry(bench, workload)
    config = {**load_json("configs", entry["config"], root / "bench"),
              **(overrides or {})}
    traffic = load_json("traffic", entry["traffic"], root / "bench")
    wanted = metrics_for(bench, workload, trace)
    readers = {m["name"]: reader(m["name"], root / "bench") for m in wanted}

    cell = driver(config["driver"]).Cell(config, traffic, seed, device)
    t_cell = time.perf_counter()
    for _ in range(traffic["warm_calls"]):
        cell.call()
    synchronize(device)
    before = cell.counters()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    units = 0
    while time.perf_counter() - t0 < seconds:
        units += cell.call()
    synchronize(device)
    window_s = time.perf_counter() - t0
    after = cell.counters()
    failed = after.get("failed", 0) - before.get("failed", 0)
    stretch = profile_stretch(cell, traffic["profile_calls"], device) \
        if trace else None
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cell.finish()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = cell.check()
    check_s = time.perf_counter() - t_check
    limits = config["limits"]
    correct = failed == 0 and all(v <= limits[k] for k, v in numbers.items())
    # JSON has no infinity or NaN: such a reading is printed as a string
    checks = {k: {"value": v if math.isfinite(v) else str(v),
                  "limit": limits[k]} for k, v in numbers.items()}

    r = Run(cell, config, setup_s, window_s, units, before, after, stretch)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]](r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": entry["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": units, "failed": failed,
           "metrics": metrics, "device": dev}
    if stretch is not None:
        dev["busy_s"] = stretch.busy_s
        dev["window_s"] = stretch.window_s
        out["breakdown"] = stretch.breakdown()
    # where set-up went: imports and start-up, the driver's inputs and
    # executor, the warm calls that build and capture
    out["setup_parts_s"] = {"start": t_run - t_start, "cell": t_cell - t_run,
                            "warm": t0 - t_cell}
    out["check_s"] = check_s
    out["checks"] = checks
    return out


def check_lines(result: dict) -> list:
    """One line a number compared, with its limit."""
    return [f"check {k} = {c['value']!r} (limit {c['limit']!r})"
            for k, c in result["checks"].items()]

