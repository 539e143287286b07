"""Build and load the CUDA kernels (``csrc/*.cu``) for Hopper.

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds.  Libraries go into ``build/repro_torch/`` of the checkout, named
by a digest of the source, every ``csrc/*.cuh`` header and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.  ``nvcc`` comes from ``$CUDA_HOME/bin`` or the
``PATH``; without it, building raises.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build", "load", "check", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/repro_torch (this file is src/repro_torch/kernels/_build.py)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("saxpy", "particle", "stencil", "eikonal", "attention", "ssd",
           "reduce")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``,
    else the toolkit's default home ``/usr/local/cuda`` (as PyTorch's own
    extension builder assumes)."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").is_file():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from src/repro_torch/csrc at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives.  The digest
    covers every header under ``csrc/``, so an edited header rebuilds
    every library."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes at once; returns the seconds each build took.  The
    compiler's report (registers, shared memory, spills) is kept beside
    each library as ``.log``."""
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    seconds, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use),
    with ``argtypes`` declared from ``signatures`` (function -> ctypes
    argument types; every entry point returns a C ``int``)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.ripple_error_string.argtypes = [ctypes.c_int]
        lib.ripple_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.ripple_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
