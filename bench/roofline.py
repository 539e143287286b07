"""The yardstick's arithmetic: the H100's published peaks, the least time
a piece of work can take on it, and the bytes each measured piece of work
needs, counted from the problem's shapes whatever implements it.

Each input byte is counted read once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit: the device
# memory rate and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32 = 4

# the port's hand-written kernels by wrapper: the piece of the profiler's
# name of each (the same inside a captured graph)
KERNEL_SYMBOLS = {"saxpy": "::saxpy_kernel<",
                  "saxpy_record": "::saxpy_record_kernel<",
                  "particle_update": "::particle_kernel<",
                  "flux_difference": "::flux_kernel<",
                  "eikonal_fim": "::fim_kernel<",
                  "flash_attention": "::attn_",
                  "ssd_intra_chunk": "::ssd_"}


def bound_s(nbytes: float, ops: float = 0.0,
            ops_per_s: float = F32_OPS_PER_S) -> float:
    """The least seconds the work takes: the larger of its bytes over the
    memory rate and its operations over the arithmetic rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def k3_bytes(n: int) -> int:
    """K3 over ``n`` particles: ``x`` and ``v`` (3 float32 each) read,
    ``x`` written."""
    return n * (3 + 3 + 3) * F32


def particle_step_bytes(n: int) -> int:
    """One particle step over ``n`` particle indices: both species' ``x``
    and ``v`` read and ``x`` written (K3 twice), the field's ``x`` and
    ``y`` read and ``y`` written (K2); the max re-reads the ions' ``v``,
    which a step need not read twice."""
    return 2 * k3_bytes(n) + n * (1 + 1 + 1) * F32


def k5_bytes(n: int) -> int:
    """K5 over an ``n x n`` grid: the padded ``phi`` (float32) and the
    source mask (one byte a cell) read, ``phi`` written."""
    return (n + 2) ** 2 * F32 + n * n + n * n * F32


def solve_bytes(n: int, iterations: int) -> int:
    """A whole solve: per iteration ``phi`` and the mask read and ``phi``
    written, 9 bytes a cell."""
    return iterations * n * n * (F32 + 1 + F32)
