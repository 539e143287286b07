#!/usr/bin/env python3
"""Run some phases of ``chip_smoke.py`` on one NVIDIA GPU, for development.

    python3 tools/chip_phases.py [--repeat N] PHASE [PHASE ...]

PHASE is ``out`` (K1-K5's ``out=`` against their fresh-output calls),
``lm`` (phase 3's qwen3-8b and mamba2-130m at the defaults, with the serve
launcher's smoke checks), ``local`` (K6 at head dim 256 against its plain
version and timed, then phase 3's gemma3-12b and recurrentgemma-9b with
the ring check), ``archs`` (phase 3g: K6 at the new archs' prefill
shapes against its plain version and timed, qwen1.5-4b and chatglm3-6b
through the ``Batcher``, seamless-m4t-medium and llava-next-mistral-7b
through the uniform loop with the decode check), ``moe`` (phase 3h:
K6 at the 3g and 3h prefill shapes against its plain version and timed,
phi3.5-moe and arctic-480b cut in depth through the ``Batcher``),
``regions`` (phase 3b's
four graphs), ``serve``
(phase 3b's two served models), ``async`` (phase 3c), ``mesh`` (phase
3d), ``examples`` (phase 3e: tuning on a mesh and the examples),
``train`` (phase 3f: training, the gradient gate, the supervisor) or
``parallel`` (phase 3i: the MoE all-to-all, phi3.5-moe's prefill through
the hook, sequence parallelism, ``compressed_psum``).  Each
phase runs as ``chip_smoke.py`` runs it, with its checks, ``--repeat``
times in a row; a failed check is printed and the next run goes on.  The
kernels are built first.  Exits non-zero if any run failed.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

PHASES = ("out", "lm", "local", "archs", "moe", "regions", "serve",
          "async", "mesh", "examples", "train", "parallel")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phases", nargs="+", choices=PHASES)
    parser.add_argument("--repeat", type=int, default=1)
    args = parser.parse_args()

    # phase 3f's deterministic algorithms need it before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import workloads
    from repro_torch.core import Boundary, pad_boundary_only
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention.kernel import flash_attention_cuda
    from repro_torch.kernels.eikonal.kernel import eikonal_fim_cuda
    from repro_torch.kernels.eikonal.ops import eikonal_fim_ref
    from repro_torch.kernels.particle.kernel import particle_update_cuda
    from repro_torch.kernels.saxpy.kernel import (saxpy_cuda,
                                                  saxpy_record_cuda)
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.kernels.stencil.kernel import flux_difference_cuda

    card = cs.card_line()
    cs.log(f"card: {card}")
    _build.build()
    wrappers = {"saxpy": saxpy_cuda, "saxpy_record": saxpy_record_cuda,
                "particle_update": particle_update_cuda,
                "flux_difference": flux_difference_cuda,
                "eikonal_fim": eikonal_fim_cuda,
                "flash_attention": flash_attention_cuda,
                "ssd_intra_chunk": ssd_intra_chunk_cuda}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts_now():
        return {k: w.launches for k, w in wrappers.items()}

    dev = torch.device("cuda")
    eik = {k: torch.from_numpy(v).to(dev)
           for k, v in workloads.eikonal_inputs(cs.EIK_N).items()}

    def halo(p):
        for ax in (0, 1):
            p = pad_boundary_only(p, axis=ax, width=1,
                                  boundary=Boundary.TRANSMISSIVE)
        return p

    runs = {
        "out": lambda: cs.out_checks(card, eik_mid(), eik["mask"]),
        "lm": lambda: [cs.serve_lm(arch, card, zero_counts, counts_now)
                       for arch in ("qwen3-8b", "mamba2-130m")],
        "local": lambda: [cs.local_attention_parity(),
                          cs.local_attention_times(card)] + [
            cs.serve_lm(arch, card, zero_counts, counts_now)
            for arch in cs.LM_LOCAL_ARCHS],
        "archs": lambda: [cs.serving_attention_parity(),
                          cs.serving_attention_times(card)] + [
            cs.serve_lm(arch, card, zero_counts, counts_now)
            for arch in cs.LM_DENSE_ARCHS] + [
            cs.serve_frontend(arch, card, zero_counts, counts_now)
            for arch in cs.LM_FRONTEND_ARCHS],
        "moe": lambda: [cs.serving_attention_parity(),
                        cs.serving_attention_times(card)] + [
            cs.serve_lm(arch, card, zero_counts, counts_now)
            for arch in cs.LM_MOE_ARCHS],
        "regions": lambda: cs.regions_phase(card, zero_counts, counts_now),
        "serve": lambda: [cs.serve_regions(arch, card, zero_counts,
                                           counts_now)
                          for arch in ("qwen3-8b", "mamba2-130m")],
        "async": lambda: cs.async_phase(card, zero_counts, counts_now),
        "mesh": lambda: cs.mesh_phase(card, zero_counts, counts_now, eik),
        "examples": lambda: cs.examples_phase(card, zero_counts,
                                              counts_now),
        "train": lambda: cs.train_phase(card, zero_counts, counts_now),
        "parallel": lambda: cs.parallel_phase(card, zero_counts,
                                              counts_now)}

    def eik_mid():
        """The eikonal kernel's mid-solve input of chip_smoke.py."""
        phi = eik["phi"]
        for _ in range(cs.EIK_WARM):
            phi = eikonal_fim_ref(halo(phi), eik["mask"], 1 / cs.EIK_N,
                                  inner=cs.EIK_INNER, block=cs.EIK_BLOCK)
        return halo(phi)

    failed = 0
    for phase in args.phases:
        for i in range(args.repeat):
            try:
                runs[phase]()
                cs.log(f"chip_phases: {phase} run {i} passed")
            except Exception:
                failed += 1
                traceback.print_exc()
                cs.log(f"chip_phases: {phase} run {i} FAILED")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
