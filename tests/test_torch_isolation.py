"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and not the port's examples (``examples/*_torch.py``)
import JAX or the JAX package, and nothing falls back to the CPU when no
GPU is present."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")

_IMPORT_ALL = r"""
import importlib.util, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [k for k, v in sys.modules.items() if v is not None and (
    k == "repro" or k.startswith("repro.") or k.split(".")[0] == "jax")]
assert not loaded, loaded
print(len(names))
"""


def _env(pythonpath: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = pythonpath
    return env


def test_port_imports_neither_jax_nor_the_reference():
    path = os.pathsep.join(p for p in (os.path.join(REPO, "src"),
                                       os.environ.get("PYTHONPATH")) if p)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, CHIP_SMOKE], env=_env(path),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20   # every port module was imported


_IMPORT_EXAMPLES = r"""
import importlib.util, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [k for k, v in sys.modules.items() if v is not None and (
    k == "repro" or k.startswith("repro.") or k.split(".")[0] == "jax")]
assert not loaded, loaded
print(len(sys.argv) - 1)
"""


def test_port_examples_import_neither_jax_nor_the_reference():
    examples = [os.path.join(REPO, "examples", f"{name}_torch.py")
                for name in ("quickstart", "particles", "euler2d",
                             "serve_lm")]
    path = os.pathsep.join(p for p in (os.path.join(REPO, "src"),
                                       os.environ.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-c", _IMPORT_EXAMPLES,
                          *examples], env=_env(path), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(examples)


def test_chip_smoke_without_a_gpu_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run")
    out = subprocess.run([sys.executable, CHIP_SMOKE], env=_env(""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails_with_no_result(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the
    repository, the script fails before printing any result."""
    shutil.copy(CHIP_SMOKE, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_env(""), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
