#!/usr/bin/env python3
"""Time the port's flux kernel (K4, ``src/repro_torch/csrc/stencil.cu``)
at the strip lengths and block widths it takes, on one NVIDIA GPU.

    python3 tools/k4_geometry.py

For the 4096 x 4096 shock-bubble state of the main path (haloed, float32
and bfloat16, SoA and AoS) and each geometry (rows a strip, warps a
block), the kernel is held against its plain version with λ = (0.1, 0.05)
(float32 1e-4, bfloat16 2e-2, as ``chip_smoke.py``) and timed with CUDA
events: 30 calls back to back, the median of 5 such batches, the kernel
and its traffic alone (the same loads, shuffles and stores with a sum for
the flux arithmetic).  ``flux_geometry`` takes the geometry marked
"(taken)".  Exits non-zero without a GPU or on a disagreement.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

N = 4096
GEOMETRIES = ((1, 4), (2, 4), (4, 4), (8, 4), (4, 2), (8, 2), (4, 1))
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def time_ms(fn, iters: int = 30, reps: int = 5, warmup: int = 3) -> float:
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_geometry: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core import (Boundary, Layout, RecordArray,
                                  pad_boundary_only, relayout)
    from repro_torch.kernels import _build
    from repro_torch.kernels._common import (LAYOUT_CODE, DTYPE_SUFFIX,
                                             stream_of)
    from repro_torch.kernels.stencil import kernel as k4
    from repro_torch.kernels.stencil.ref import flux_difference_ref
    from repro_torch.physics.euler import EULER_SPEC, shock_bubble_init

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    lib = _build.load("stencil", k4._SIGNATURES)
    dev = torch.device("cuda")
    taken = k4.flux_geometry(N, N)

    def launch(fn, rec, rows, warps, lam=(0.1, 0.1)):
        out = torch.empty(RecordArray.storage_shape(EULER_SPEC, (N, N),
                                                    rec.layout),
                          dtype=rec.dtype, device=dev)
        grid = (-(-(-(-N // 32)) // warps), -(-N // rows))
        code = getattr(lib, f"{fn}_{DTYPE_SUFFIX[rec.dtype]}")(
            rec.data.data_ptr(), out.data_ptr(), N, N,
            LAYOUT_CODE[rec.layout], *lam, rows, warps, *grid,
            stream_of(rec.data))
        _build.check(lib, code, fn)
        return out

    failed = False
    for dname in ("float32", "bfloat16"):
        u = shock_bubble_init(N, N, device=dev).to(getattr(torch, dname))
        for ax in (1, 2):
            u = pad_boundary_only(u, axis=ax, width=1,
                                  boundary=Boundary.TRANSMISSIVE)
        for lay in (Layout.SOA, Layout.AOS):
            rec = relayout(RecordArray(u, EULER_SPEC, Layout.SOA), lay)
            want = flux_difference_ref(rec, 0.1, 0.05).data.float()
            tol = TOL[dname]
            for rows, warps in GEOMETRIES:
                got = launch("flux_difference", rec, rows, warps,
                             (0.1, 0.05)).float()
                diff = (got - want).abs()
                bad = int((~(diff <= tol + tol * want.abs())).sum())
                failed |= bad > 0
                ms = time_ms(lambda: launch("flux_difference", rec, rows,
                                            warps))
                traffic = time_ms(lambda: launch("flux_traffic", rec, rows,
                                                 warps))
                mark = " (taken)" if (rows, warps) == (
                    taken.rows_per_strip, taken.warps_per_block) else ""
                print(f"K4 {dname} {lay.name} {N}^2, {rows} rows a strip, "
                      f"{warps} warps a block{mark}: {ms:.4f} ms, traffic "
                      f"alone {traffic:.4f} ms, max |difference| "
                      f"{float(diff.max()):.3e}, {bad} outside ({card})",
                      flush=True)
            del rec, want
        del u
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
