"""repro_torch.tuning — measured autotuner for layout & kernel tiling.

The port of ``repro.tuning``: it turns the layout solver's static
heuristics and the kernels' fixed tile defaults into *measured*
decisions:

* :mod:`repro_torch.tuning.search` — the search: proposes the
  JOINT (per-key layout × per-kernel tile) candidate space (plus
  per-segment layout refinements), ranks it by an analytic penalty, times
  the surviving candidates as real runs under a
  :class:`~repro_torch.tuning.search.TuneBudget`, and commits the argmin
  (``Executor(tune="auto", tune_budget=...)``);
* :mod:`repro_torch.tuning.cache` — the persistent on-disk cache
  (``~/.cache/repro-tune`` or ``$REPRO_TUNE_CACHE``), keyed by plan
  signature × device assortment × torch and CUDA versions, so a second
  process loads tuned configs with zero re-measurement;
* :mod:`repro_torch.tuning.tiles` — the per-kernel ``tile_candidates()``
  registry and the ambient tile scope ops wrappers resolve through;
* :mod:`repro_torch.tuning.timing` — the first-call/steady-state timing
  harness.

This package's ``__init__`` stays import-light (no ``repro_torch.core``
import): ``core/executor.py`` imports :mod:`tiles` at module load, and
the search module is loaded lazily on first attribute access.
"""

from . import cache, tiles, timing
from .cache import cache_dir, cache_path, clear_memo, tuning_lock
from .tiles import (active_tiles, record_tile_use, register_tile_kernel,
                    registered_tile_kernels, resolve_tile, tile_candidates,
                    tile_distance, tile_scope)
from .timing import time_fn, time_fn_budget, time_fn_split

__all__ = [
    "cache", "tiles", "timing",
    "cache_dir", "cache_path", "clear_memo", "tuning_lock",
    "active_tiles", "record_tile_use", "register_tile_kernel",
    "registered_tile_kernels", "resolve_tile", "tile_candidates",
    "tile_distance", "tile_scope",
    "time_fn", "time_fn_budget", "time_fn_split",
    # lazy (search imports repro_torch.core):
    "Measurement", "TuneBudget", "TuningDecision", "STATS", "reset_stats",
    "resolve_tuning", "measure_plan", "tuning_key", "search",
]

_LAZY = {"Measurement", "TuneBudget", "TuningDecision", "STATS",
         "reset_stats", "resolve_tuning", "measure_plan", "tuning_key",
         "search"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        search = importlib.import_module(".search", __name__)
        if name == "search":
            return search
        return getattr(search, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
