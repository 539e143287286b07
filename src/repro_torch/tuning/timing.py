"""Shared timing harness — first-call vs steady-state split timing.

The port of ``repro/tuning/timing.py``.  The measured autotuner
(``repro_torch.tuning.search``) times every candidate through this module:
the first call is reported apart from the steady-state median, and a
candidate's loop may stop early once it is dominated.

Times are wall time on the host clock per call, each call ended by a
device synchronize when its result lies on a CUDA device: the end-to-end
metric is wall time per graph step, and the port's steps are partly
host-bound, so a device-only clock would prefer a plan that costs more
Python dispatch.
"""

from __future__ import annotations

import time

import torch

__all__ = ["time_fn", "time_fn_split", "time_fn_budget"]


def _cuda_devices(result, out: set) -> set:
    """The CUDA devices of every tensor in ``result`` (a tensor, a
    ShardedArray's shards, or dicts / lists / tuples of them, such as an
    ``Executor.run`` state)."""
    shards = getattr(result, "shards", None)
    if shards is not None:
        result = shards
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            out.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _cuda_devices(v, out)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _cuda_devices(v, out)
    return out


def _block(result):
    """Wait until ``result`` is computed: a synchronize of each CUDA device
    it lies on (nothing on the CPU, where torch computes eagerly)."""
    for dev in _cuda_devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


def time_fn_split(fn, *args, iters: int = 5, warmup: int = 2,
                  **kw) -> tuple[float, float]:
    """``(first_ms, steady_ms)`` — the first call (which pays kernel
    builds and allocator growth) timed separately from the steady-state
    median.

    ``warmup`` counts total pre-measurement calls (the first, timed one
    included); ``steady_ms`` is the median of ``iters`` calls after it."""
    first, steady, _, _ = time_fn_budget(fn, *args, iters=iters,
                                         warmup=warmup, **kw)
    return first, steady


def time_fn_budget(fn, *args, iters: int = 5, warmup: int = 2,
                   min_iters: int = 2, stop_above_ms=None,
                   **kw) -> tuple[float, float, int, bool]:
    """``(first_ms, steady_ms, iters_run, dominated)`` — like
    :func:`time_fn_split`, but the steady-state loop stops early once the
    candidate is dominated: after ``min_iters`` timed calls, if the
    RUNNING median already exceeds ``stop_above_ms`` the remaining
    iterations are skipped (``dominated=True``) — the autotuner's
    per-candidate measurement budget.  ``stop_above_ms=None`` times all
    ``iters`` calls."""
    t0 = time.perf_counter()
    _block(fn(*args, **kw))
    first = (time.perf_counter() - t0) * 1e3
    for _ in range(max(warmup - 1, 0)):
        _block(fn(*args, **kw))
    times: list[float] = []
    dominated = False
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args, **kw))
        times.append((time.perf_counter() - t0) * 1e3)
        if (stop_above_ms is not None and len(times) >= max(min_iters, 1)
                and sorted(times)[len(times) // 2] > stop_above_ms):
            dominated = True
            break
    return first, sorted(times)[len(times) // 2], len(times), dominated


def time_fn(fn, *args, iters: int = 5, warmup: int = 2, **kw) -> float:
    """Median steady-state wall time per call in ms (the first call
    excluded — see :func:`time_fn_split`)."""
    return time_fn_split(fn, *args, iters=iters, warmup=warmup, **kw)[1]
