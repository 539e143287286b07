#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. setup — the card's name and power limit (``nvidia-smi``), then every
   CUDA kernel built from ``src/repro_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (all sources compiled at once);
2. kernel parity — each kernel against its plain PyTorch version on the
   card, at the main path's shapes, float32 and bfloat16, every layout;
3. the main path through the port's ``Graph``/``Executor`` on the GPU:
   the Table 2 SAXPY probe (n = 2^24), the particle step graph (2^24
   particles per species, 100 steps, closed-form check) and the FORCE flux
   graph on a 4096 x 4096 shock-bubble interior (checked against the
   plain version on the card), with every kernel's launch count read
   from the run;
4. times — per kernel (CUDA events around 30 calls back to back, the
   median of 5 such batches, after warm-up) beside
   its bound (bytes over 3.35 TB/s, operations over 67 TFLOP/s of
   float32), its plain version and, where one PyTorch call computes the
   same function, that call.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a GPU, or without
the rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

# NVIDIA H100 SXM data sheet: device memory rate and float32 rate outside
# the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SAXPY_N, SAXPY_A, SAXPY_STEPS = 1 << 24, 1.75, 20
PARTICLE_N, PARTICLE_STEPS = 1 << 24, 100
FLUX_N, FLUX_STEPS, FLUX_LAM = 4096, 20, 0.1
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# flux: float32 sums of ~90-op face fluxes in another order than the plain
# version; bfloat16: the kernel computes in float32 and rounds once, the
# plain version rounds after every operation
FLUX_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# operations of one FORCE face flux in csrc/stencil.cu: three physical
# fluxes of 13 each, 2 for the λ factors, 10 per component for the
# Lax-Friedrichs flux and the Richtmyer state, 2 per component to average
OPS_PER_FACE = 3 * 13 + 2 + 4 * 10 + 4 * 2
# per cell: lam * (F+ - F-) per dim and component, and the sum of the dims
OPS_PER_CELL = 2 * 4 * 2 + 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, reps: int = 5, warmup: int = 3) -> float:
    """Device time of one call: ``iters`` calls back to back between one
    pair of CUDA events, divided by ``iters``; the median of ``reps`` such
    batches.  The host queues calls ahead of the card, so the host work of
    each call (checks, allocation, the launch itself) hides behind the
    kernels before it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def run_steps(ex, state: dict, steps: int) -> tuple[dict, float]:
    """``steps`` passes of ``ex`` one at a time; returns the final state and
    the median host time of one step, each ended by a device synchronize."""
    import torch

    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ex.run(state, 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, statistics.median(times)


def max_err(got, want, tol: float, what: str) -> float:
    """Max absolute difference; fails unless |got - want| <= tol + tol*|want|
    everywhere and every value is finite."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite values")
    diff = (g - w).abs()
    bad = int((diff > tol + tol * w.abs()).sum())
    err = float(diff.max())
    log(f"parity {what}: max_abs_err={err:.3e} (tolerance {tol:g}, "
        f"{bad} outside)")
    if bad:
        raise AssertionError(f"{what}: {bad} values outside tolerance")
    return err


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.core import (Boundary, Executor, Layout, RecordArray,
                                  pad_boundary_only, relayout)
    from repro_torch.kernels import _build
    from repro_torch.kernels.particle.kernel import particle_update_cuda
    from repro_torch.kernels.particle.ops import (PARTICLE_SPEC,
                                                  particle_update_ref)
    from repro_torch.kernels.saxpy.kernel import (saxpy_cuda,
                                                  saxpy_record_cuda)
    from repro_torch.kernels.saxpy.ops import (SAXPY_SPEC, saxpy_record_ref,
                                               saxpy_ref)
    from repro_torch.kernels.stencil.kernel import flux_difference_cuda
    from repro_torch.kernels.stencil.ops import (flux_difference,
                                                 flux_difference_ref)
    from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init
    from repro_torch import workloads

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {', '.join(f'{k}.cu {v:.1f}s' for k, v in secs.items())} "
        f"(wall {time.perf_counter() - t0:.1f}s, into {_build.BUILD_DIR})")
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log")
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    kernels = {  # name -> JSON entry
        "saxpy": {"source": "src/repro_torch/csrc/saxpy.cu",
                  "replaces": "src/repro/kernels/saxpy/kernel.py:61"},
        "saxpy_record": {"source": "src/repro_torch/csrc/saxpy.cu",
                         "replaces": "src/repro/kernels/saxpy/kernel.py:112"},
        "particle_update": {
            "source": "src/repro_torch/csrc/particle.cu",
            "replaces": "src/repro/kernels/particle/kernel.py:59"},
        "flux_difference": {
            "source": "src/repro_torch/csrc/stencil.cu",
            "replaces": "src/repro/kernels/stencil/kernel.py:67"},
    }
    wrappers = {"saxpy": saxpy_cuda, "saxpy_record": saxpy_record_cuda,
                "particle_update": particle_update_cuda,
                "flux_difference": flux_difference_cuda}
    errs = {k: 0.0 for k in kernels}
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def haloed_shock_bubble(dtype):
        """The flux kernel's input: the shock-bubble state in ``dtype``
        with a one-cell transmissive halo, (4, FLUX_N+2, FLUX_N+2)."""
        u = shock_bubble_init(FLUX_N, FLUX_N, device=dev).to(dtype)
        for ax in (1, 2):
            u = pad_boundary_only(u, axis=ax, width=1,
                                  boundary=Boundary.TRANSMISSIVE)
        return u

    # -- 2. kernel parity on the card ----------------------------------------
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        tol = TOL[dname]
        for n in (SAXPY_N, SAXPY_N + 3):
            x, y = randn(n, dtype=dt), randn(n, dtype=dt)
            want = saxpy_ref(SAXPY_A, x, y)
            for bc in (True, False):
                e = max_err(saxpy_cuda(SAXPY_A, x, y, bounds_check=bc), want,
                            tol, f"saxpy {dname} n={n} "
                                 f"{'BC' if bc else 'NBC'}")
                if dname == "float32":
                    errs["saxpy"] = max(errs["saxpy"], e)
        for lay in Layout:
            rec = RecordArray(randn(2, PARTICLE_N, dtype=dt), SAXPY_SPEC,
                              Layout.SOA).with_layout(lay)
            e = max_err(saxpy_record_cuda(rec, workloads.DT).data,
                        saxpy_record_ref(rec, workloads.DT).data, tol,
                        f"saxpy_record {dname} {lay.name}")
            rec = RecordArray(randn(6, PARTICLE_N, dtype=dt), PARTICLE_SPEC,
                              Layout.SOA).with_layout(lay)
            e2 = max_err(particle_update_cuda(rec, workloads.DT).data,
                         particle_update_ref(rec, workloads.DT).data, tol,
                         f"particle_update {dname} {lay.name}")
            if dname == "float32":
                errs["saxpy_record"] = max(errs["saxpy_record"], e)
                errs["particle_update"] = max(errs["particle_update"], e2)
        u = haloed_shock_bubble(dt)
        for lay in Layout:   # AoSoA goes through the ops relayout
            rec = relayout(RecordArray(u, EULER_SPEC, Layout.SOA), lay)
            e = max_err(flux_difference(rec, FLUX_LAM, FLUX_LAM).data,
                        flux_difference_ref(rec, FLUX_LAM, FLUX_LAM).data,
                        FLUX_TOL[dname], f"flux_difference {dname} "
                                         f"{lay.name}")
            if dname == "float32":
                errs["flux_difference"] = max(errs["flux_difference"], e)
            del rec
        del u
        torch.cuda.empty_cache()

    # -- 3. the main path through Graph/Executor on the GPU ------------------
    for w in wrappers.values():
        w.launches = 0
    wall = {}

    g, (x_t, y_bc, y_nbc) = workloads.build_saxpy_graph(SAXPY_N, SAXPY_A)
    ex = Executor(g)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(SAXPY_N, dtype=np.float32)
    state = ex.init_state(x=x0)
    state, wall["saxpy_probe"] = run_steps(ex, state, SAXPY_STEPS)
    want = torch.from_numpy(x0).to(dev)
    acc = torch.zeros_like(want)
    for _ in range(SAXPY_STEPS):
        acc = SAXPY_A * want + acc
    for t in (y_bc, y_nbc):
        max_err(state[t.name], acc, 1e-5, f"main path saxpy probe {t.name}")
    del state, ex, want, acc

    g, (ions, electrons, field), vmax = workloads.build_particle_graph(
        PARTICLE_N)
    ex = Executor(g)
    fields = workloads.particle_fields(PARTICLE_N)
    specs = {"ions": (PARTICLE_SPEC, Layout.AOS),
             "electrons": (PARTICLE_SPEC, Layout.AOSOA),
             "field": (SAXPY_SPEC, Layout.SOA)}
    state = ex.init_state(**{
        k: RecordArray.from_fields(spec, {f: torch.from_numpy(v).to(dev)
                                          for f, v in fields[k].items()},
                                   lay)
        for k, (spec, lay) in specs.items()})
    state, wall["particle_step"] = run_steps(ex, state, PARTICLE_STEPS)
    span = PARTICLE_STEPS * workloads.DT
    for t, key in ((ions, "ions"), (electrons, "electrons")):
        x_t0 = torch.from_numpy(fields[key]["x"]).to(dev)
        v_t0 = torch.from_numpy(fields[key]["v"]).to(dev)
        max_err(ex.read(state, t).field("x"), x_t0 + span * v_t0, 1e-4,
                f"main path {key} x_T = x_0 + T dt v")
    max_err(ex.read(state, field).field("y"),
            span * torch.from_numpy(fields["field"]["x"]).to(dev), 1e-4,
            "main path field y_T = T dt x")
    v_ions = torch.from_numpy(fields["ions"]["v"]).to(dev)
    max_err(state[vmax.name], v_ions.max(), 0.0, "main path vmax")
    del state, ex, fields, x_t0, v_t0, v_ions

    g, (u_t, flux_t) = workloads.build_flux_graph(FLUX_N, FLUX_N,
                                                  lam_x=FLUX_LAM,
                                                  lam_y=FLUX_LAM)
    ex = Executor(g)
    u0 = shock_bubble_init(FLUX_N, FLUX_N, device=dev)
    state = ex.init_state(u=u0)
    state, wall["flux"] = run_steps(ex, state, FLUX_STEPS)
    launches = {k: w.launches for k, w in wrappers.items()}
    plain_g, _ = workloads.build_flux_graph(FLUX_N, FLUX_N, lam_x=FLUX_LAM,
                                            lam_y=FLUX_LAM, use_kernel=False)
    plain_ex = Executor(plain_g)
    plain = plain_ex(plain_ex.init_state(u=u0))
    max_err(state[flux_t.name], plain[flux_t.name], FLUX_TOL["float32"],
            "main path flux graph vs plain graph")
    del state, plain, plain_ex, ex

    log(f"main path launches: {json.dumps(launches)}")
    expect = {"saxpy": 2 * SAXPY_STEPS, "saxpy_record": PARTICLE_STEPS,
              "particle_update": 2 * PARTICLE_STEPS,
              "flux_difference": FLUX_STEPS}
    for k, n in expect.items():
        if launches[k] != n:
            raise AssertionError(f"{k}: {launches[k]} launches on the main "
                                 f"path, expected {n}")
    for k, ms in wall.items():
        log(f"wall per step {k} (median): {ms:.3f} ms ({card})")

    # -- 4. times -----------------------------------------------------------
    results = {}
    x, y = randn(SAXPY_N), randn(SAXPY_N)
    n = SAXPY_N
    nbc_ms = time_ms(lambda: saxpy_cuda(SAXPY_A, x, y, bounds_check=False))
    results["saxpy"] = dict(
        ms=time_ms(lambda: saxpy_cuda(SAXPY_A, x, y)),
        plain_ms=time_ms(lambda: saxpy_ref(SAXPY_A, x, y)),
        library_ms=time_ms(lambda: torch.add(y, x, alpha=SAXPY_A)),
        nbytes=3 * n * 4, ops=2 * n)
    log(f"time saxpy NBC: {nbc_ms:.4f} ms ({card})")
    del x, y

    rec = RecordArray(randn(2, PARTICLE_N), SAXPY_SPEC, Layout.SOA)
    results["saxpy_record"] = dict(
        ms=time_ms(lambda: saxpy_record_cuda(rec, workloads.DT)),
        plain_ms=time_ms(lambda: saxpy_record_ref(rec, workloads.DT)),
        library_ms=None, nbytes=2 * 2 * PARTICLE_N * 4, ops=2 * PARTICLE_N)
    del rec

    recs = {lay: RecordArray(randn(6, PARTICLE_N), PARTICLE_SPEC,
                             Layout.SOA).with_layout(lay)
            for lay in (Layout.AOS, Layout.AOSOA)}
    aos = recs[Layout.AOS]
    results["particle_update"] = dict(
        ms=time_ms(lambda: particle_update_cuda(aos, workloads.DT)),
        plain_ms=time_ms(lambda: particle_update_ref(aos, workloads.DT)),
        library_ms=None, nbytes=2 * 6 * PARTICLE_N * 4, ops=6 * PARTICLE_N)
    aosoa = recs[Layout.AOSOA]
    log(f"time particle_update AOSOA: "
        f"{time_ms(lambda: particle_update_cuda(aosoa, workloads.DT)):.4f} "
        f"ms, plain "
        f"{time_ms(lambda: particle_update_ref(aosoa, workloads.DT)):.4f} "
        f"ms ({card})")
    del recs, aos, aosoa

    u = haloed_shock_bubble(torch.float32)
    rec = RecordArray(u, EULER_SPEC, Layout.SOA)
    nx = ny = FLUX_N
    faces = (nx + 1) * ny + nx * (ny + 1)
    results["flux_difference"] = dict(
        ms=time_ms(lambda: flux_difference_cuda(rec, FLUX_LAM, FLUX_LAM)),
        plain_ms=time_ms(lambda: flux_difference_ref(rec, FLUX_LAM,
                                                     FLUX_LAM), iters=20),
        library_ms=None,
        nbytes=4 * 4 * ((nx + 2) * (ny + 2) + nx * ny),
        ops=faces * OPS_PER_FACE + nx * ny * OPS_PER_CELL)
    del rec, u

    entries = []
    for name, meta in kernels.items():
        r = results[name]
        b_ms, b_by = bound(r["nbytes"], r["ops"])
        lib_ms = r["library_ms"]
        lib = "-" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"time {name}: kernel {r['ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {r['nbytes']} bytes, {r['ops']} ops), plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ({card})")
        entries.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"]})

    log(f"card: {card}")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
