"""Data pipeline: deterministic, shard-aware token streams with prefetch
onto the device."""

from .pipeline import MemmapCorpus, Prefetcher, SyntheticLM, make_batches

__all__ = ["MemmapCorpus", "SyntheticLM", "Prefetcher", "make_batches"]
