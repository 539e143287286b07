"""The paper's three examples and the serving demo on the port
(``examples/*_torch.py``) run on the CPU at small sizes, with their own
checks, and against the JAX package's examples.

* ``quickstart_torch.py``: every section's printed values, and the
  README's port quickstart block equal to the file's snippet (as
  ``tests/test_docstrings.py`` holds the JAX one);
* ``particles_torch.py``: the closed-form check inside ``run`` at 1024
  particles a species;
* ``serve_lm_torch.py``: ragged requests served to their EOS or length
  at gemma3-12b's and recurrentgemma-9b's smoke configs;
* ``euler2d_torch.py``: N shards of the CPU (``--devices N``) against one
  shard, the final state within rtol 1e-5, atol 1e-6 and every printed
  row's smax equal (a sum over shards folds in another order, so the mass
  within float32 1e-6 relative); and the one-shard run against the JAX
  package's ``examples/euler2d.py`` at 64 x 32, 20 steps: the final state
  at the reference tests' rtol 1e-5, atol 1e-6, and each printed row
  within one unit of its last printed digit (smax and the rho range are
  printed to 1e-3, the drift to three significant digits)."""

import contextlib
import importlib.util
import io
import os
import re
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    import repro_torch.core as port
    from repro_torch.tuning import cache

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune-cache"))
    cache.clear_memo()
    port.clear_executable_cache()
    yield
    port.clear_executable_cache()
    cache.clear_memo()


def test_quickstart_runs_every_section_on_the_cpu():
    from repro_torch.core import Layout

    shown = _load("quickstart_torch").main(["--device", "cpu"])
    assert torch.equal(shown["saxpy"],
                       6.0 * torch.arange(1024, dtype=torch.float32) + 1.0)
    assert shown["total"] == 0.0
    assert torch.equal(shown["central"], torch.tensor([4.0, 8.0, 12.0]))
    assert shown["pinned"] is Layout.AOS
    assert shown["solver"] is Layout.AOSOA
    assert shown["tuning"] == "measured"


def test_readme_port_quickstart_matches_the_example_file():
    """The README's port quickstart block is the example's snippet,
    between the readme markers, less its indent."""
    with open(os.path.join(REPO, "README.md")) as f:
        readme = f.read()
    with open(os.path.join(EXAMPLES, "quickstart_torch.py")) as f:
        example = f.read()
    m = re.search(r"<!-- doc-example: examples/quickstart_torch.py -->\s*"
                  r"```python\n(.*?)```", readme, re.S)
    assert m, "README lacks the port's quickstart doc-example block"
    m2 = re.search(r"# --8<-- \[start:readme\]\n(.*?)"
                   r"[ \t]*# --8<-- \[end:readme\]", example, re.S)
    assert m2, "examples/quickstart_torch.py lacks the readme markers"
    assert m.group(1) == textwrap.dedent(m2.group(1)), (
        "README port quickstart drifted from examples/quickstart_torch.py")


def test_particles_closed_form_on_the_cpu():
    out = _load("particles_torch").main(["--n", "1024", "--steps", "20",
                                         "--device", "cpu", "--show-dag"])
    ex = out["executor"]
    assert ex.regions and ex.donate
    assert ex.cache_stats()["trace_events"] == 1
    assert ex.cache_stats()["moved_out"] == 0     # each run donated back
    assert np.isfinite(out["vmax"])


@pytest.mark.parametrize("arch", ["gemma3-12b", "recurrentgemma-9b"])
def test_serve_lm_serves_ragged_requests_on_the_cpu(arch):
    """``serve_lm_torch.py``: 8 ragged requests through 4 slots at the
    smoke config (window 16: 12-24-token prompts and 24 new tokens wrap
    the ring), every request retired after its EOS or 24 tokens, the
    decode captured once."""
    reqs = _load("serve_lm_torch").main(["--arch", arch, "--device",
                                         "cpu"])
    assert len(reqs) == 8
    for r in reqs:
        assert r.status == "done" and 12 <= len(r.prompt) <= 24
        assert 1 <= len(r.generated) <= 24
        assert len(r.generated) == 24 or r.generated[-1] == 0
        assert all(0 <= t < 256 for t in r.generated)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llava-next-mistral-7b"])
def test_serve_lm_points_encoder_decoder_and_vlm_to_the_uniform_loop(arch):
    """``serve_lm_torch.py`` serves no encoder-decoder or VLM arch through
    the ``Batcher``: it says so and names the launcher's ``--legacy``, as
    ``examples/serve_lm.py`` does."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        reqs = _load("serve_lm_torch").main(["--arch", arch, "--device",
                                             "cpu"])
    assert reqs == []
    assert "repro_torch.launch.serve --legacy" in out.getvalue()


EULER = ["--nx", "64", "--ny", "32", "--steps", "20", "--device", "cpu"]


@pytest.fixture(scope="module")
def euler_one_shard():
    return {unsplit: _load("euler2d_torch").main(
        EULER + (["--unsplit"] if unsplit else []))
        for unsplit in (False, True)}


@pytest.mark.parametrize("shards", [
    ["--devices", "4"],
    ["--devices", "4", "--px", "2", "--overlap"],
    ["--devices", "4", "--px", "2", "--overlap", "--unsplit"]],
    ids=["4-over-y", "2x2-overlap", "2x2-overlap-unsplit"])
def test_euler_on_four_shards_equals_one(euler_one_shard, shards):
    got = _load("euler2d_torch").main(EULER + shards)
    want = euler_one_shard["--unsplit" in shards]
    assert got["halo_blocks"] > 0
    assert not got["executor"].plan.overlap_fallbacks
    np.testing.assert_allclose(got["U"].numpy(), want["U"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert len(got["rows"]) == len(want["rows"]) == 2
    for g, w in zip(got["rows"], want["rows"]):
        assert g["smax"] == w["smax"]
        assert g["rho_min"] == w["rho_min"] and g["rho_max"] == w["rho_max"]
        assert g["mass"] == pytest.approx(w["mass"], rel=1e-6)


def _printed_rows(text: str) -> list:
    rows = re.findall(r"step +(\d+): smax=([\d.]+) rho in \[([\d.]+), "
                      r"([\d.]+)\] mass drift \(step start\) ([\d.e+-]+)",
                      text)
    return [tuple(float(x) for x in r) for r in rows]


def test_euler_equals_the_jax_example(euler_one_shard):
    sys.path.insert(0, EXAMPLES)
    try:
        ref = _load("euler2d")
    finally:
        sys.path.remove(EXAMPLES)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        U_ref = ref.run(64, 32, 20)
    want = _printed_rows(buf.getvalue())
    got = euler_one_shard[False]
    np.testing.assert_allclose(got["U"].numpy(), np.asarray(U_ref),
                               rtol=1e-5, atol=1e-6)
    assert len(want) == len(got["rows"]) == 2
    for w, g in zip(want, got["rows"]):
        assert g["step"] == w[0]
        for key, ref_v in zip(("smax", "rho_min", "rho_max"), w[1:4]):
            assert abs(round(g[key], 3) - ref_v) <= 1e-3 + 1e-9, key
        assert abs(g["drift"] - w[4]) <= 0.01 * w[4] + 1e-12
