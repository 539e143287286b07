"""The harness resolves everything by name, finds files dropped in, runs
every cell on the CPU's plain path at a small size with the reference
agreeing, counts the roofline bytes as by hand, loads no JAX, and refuses
to run without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from .common import ROOT, SMALL, run_small

from bench import harness, profile, roofline  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_every_name_resolves():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cfg = harness.load_json("configs", w["config"])
        assert configs[w["config"]]["file"] == \
            f"bench/configs/{w['config']}.json"
        assert callable(harness.driver(cfg["driver"]).Cell)
        traffic = harness.load_json("traffic", w["traffic"])
        assert {"warm_calls", "profile_calls"} <= set(traffic)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_cpu(workload, trace):
    r = run_small(workload, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in harness.metrics_for(BENCH, workload, trace)}
    assert set(r["metrics"]) <= want
    assert ("setup_s" in r["metrics"]) == (not trace)
    assert list(r)[-1] == "checks"
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_dropped_files_are_found(tmp_path):
    """A new configuration, traffic mix, metric and cell need new files
    and new entries only."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/particles-t3.json").read_text())
    cfg.update(SMALL["particles-t3"], block=256)
    (tmp_path / "bench/configs/particles-small.json").write_text(
        json.dumps(cfg))
    traffic = {"steps_per_call": 10, "diagnostic": False,
               "warm_calls": 1, "profile_calls": 1}
    (tmp_path / "bench/traffic/few.json").write_text(json.dumps(traffic))
    (tmp_path / "bench/metrics/steps_done.py").write_text(
        "def read(run):\n    return run.units\n")
    bench["configs"].append({"name": "particles-small", "source": "test",
                             "file": "bench/configs/particles-small.json",
                             "reduced": ["particles"], "why": "test"})
    bench["workloads"].append({"name": "particles.few",
                               "config": "particles-small", "traffic": "few",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "steps_done", "unit": "count",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["particles.few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]
        from bench import harness
        assert harness.ROOT == __import__("pathlib").Path({str(tmp_path)!r})
        r = harness.run("particles.few", 5, 0.3, False, device="cpu")
        print(json.dumps(r))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert r["metrics"]["steps_done"]["value"] == r["attempted"] > 0
    assert r["attempted"] % 10 == 0


def test_roofline_bytes_by_hand():
    n = 1 << 24
    assert roofline.k3_bytes(n) == 36 * n == 603_979_776
    assert roofline.particle_step_bytes(n) == 84 * n == 1_409_286_144
    assert roofline.k5_bytes(4096) == 4 * 4098 ** 2 + 4096 ** 2 \
        + 4 * 4096 ** 2 == 151_060_496
    assert roofline.solve_bytes(4096, 745) == 745 * 9 * 4096 ** 2
    assert roofline.bound_s(3.35e12) == 1.0
    assert roofline.bound_s(0, 67e12) == 1.0


class _Cell:
    def __init__(self, unit):
        self.unit = unit
        self.ref_iterations = 745


def test_roofline_readers_by_hand():
    st = profile.Stretch(window_s=1.0, busy_s=0.9, counts={
        "steps": 200, "iterations": 745})
    st.kernels = {"void (anonymous namespace)::particle_kernel<float, 0>(x)":
                  [400 * 0.25e-3, 400],
                  "void (anonymous namespace)::fim_kernel<float, 4, 4>(x)":
                  [745 * 0.1e-3, 745]}
    n, grid = 1 << 24, 4096
    step = harness.Run(_Cell("step"), {"particles": n}, 1.0, 2.0, 1000, {},
                       {}, st)
    solve = harness.Run(_Cell("solve"), {"n": grid}, 1.0, 8.0, 20, {}, {},
                        st)
    read = harness.reader
    assert read("k3_roofline")(step) == pytest.approx(
        100 * 36 * n / 3.35e12 / 0.25e-3)
    assert read("step_roofline")(step) == pytest.approx(
        100 * 84 * n / 3.35e12 / 2e-3)
    assert read("k5_roofline")(solve) == pytest.approx(
        100 * (4 * 4098 ** 2 + 5 * grid ** 2) / 3.35e12 / 0.1e-3)
    assert read("solve_roofline")(solve) == pytest.approx(
        100 * 745 * 9 * grid ** 2 / 3.35e12 / 0.4)
    assert read("device_idle.step")(step) == pytest.approx(10.0)
    assert read("step_roofline")(solve) is None
    assert read("solve_roofline")(step) is None


def test_profile_reduction():
    ev = [{"cat": "user_annotation", "name": "bench.stretch", "ts": 0,
           "dur": 100},
          {"cat": "kernel", "name": "void (anonymous namespace)::"
           "fim_kernel<float, 4, 4>(float const*)", "ts": 10, "dur": 20},
          {"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
           "ts": 25, "dur": 15},
          {"cat": "kernel", "name": "void at::native::vectorized_elementwise"
           "_kernel<4, at::native::CUDAFunctor_add<float>, x>(int)",
           "ts": 60, "dur": 30},
          {"cat": "kernel", "name": "outside", "ts": 200, "dur": 5},
          {"cat": "cpu_op", "name": "aten::item", "ts": 40, "dur": 20},
          {"cat": "cuda_runtime", "name": "cudaStreamSynchronize",
           "ts": 45, "dur": 10},
          {"cat": "user_annotation", "name": "bench.call", "ts": 0,
           "dur": 100}]
    s = profile.read(ev, {"iterations": 1})
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(60e-6)
    assert s.gaps == [(pytest.approx(10e-6), "bench.call"),
                      (pytest.approx(20e-6), "cudaStreamSynchronize"),
                      (pytest.approx(10e-6), "bench.call")]
    assert s.kernel_s("eikonal_fim") == (pytest.approx(20e-6), 1)
    assert s.group_s("copies") == pytest.approx(15e-6)
    assert s.group_s("torch_ops") == pytest.approx(30e-6)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "vectorized_elementwise_kernel" \
        "[CUDAFunctor_add]"
    assert b["idle_gaps"][0] == ["bench.call", pytest.approx(20e-6)]


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_no_jax_in_a_run_or_the_references():
    top = ("import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
           .format(root=str(ROOT), src=str(ROOT / "src")))
    run = _modules_after(top + textwrap.dedent("""
        import importlib.util, pathlib
        spec = importlib.util.spec_from_file_location(
            "bench_run", pathlib.Path("bench/run.py"))
        importlib.util.module_from_spec(spec)
        from bench.tests.common import run_small
        for w in ("particles.steps", "eikonal.solve"):
            run_small(w, trace=True, seconds=0.2)
        import bench.control
        print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
    """))
    assert "repro_torch" in run
    assert not run & {"jax", "jaxlib", "flax", "repro"}
    refs = _modules_after(top + textwrap.dedent("""
        import bench.reference.particles, bench.reference.eikonal
        print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
    """))
    assert not refs & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_without_a_card_the_harness_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.\-]{1,16}"
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_its_format():
    import re

    b = BENCH
    assert set(b) == KEYS
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.fullmatch(NAME, c["name"]) and _line(c["why"])
        assert (ROOT / c["file"]).is_file() and _line(c["source"])
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.fullmatch(NAME, w["name"]) and w["config"] in names
        assert re.fullmatch(NAME, w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        cells.add(w["name"])
    metric_names = set()
    for group, keys in (("end_to_end", {"bound"}),
                        ("per_layer", {"layer", "moves"})):
        for m in b[group]:
            assert set(m) - {"workloads"} == {"name", "unit", "better",
                                              "source"} | keys
            assert re.fullmatch(NAME, m["name"]) and \
                re.fullmatch(UNIT, m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["name"] not in metric_names
            metric_names.add(m["name"])
            if group == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert _line(m["layer"])
    for cell in cells:
        e2e = harness.metrics_for(b, cell, False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.metrics_for(b, cell, True)
    assert len(json.dumps(b)) <= 64 * 1024
