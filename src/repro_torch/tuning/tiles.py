"""Per-kernel tile registry + ambient tile configuration.

A copy of the JAX package's ``repro/tuning/tiles.py`` (pure Python; the
port keeps its own so that it never imports ``repro``).  Each kernel
package registers a ``tile_candidates()`` hook (``register_tile_kernel``)
that enumerates the block/tile shapes feasible for a given problem shape,
and resolves its effective block through :func:`resolve_tile`:

* an explicit ``block=`` argument from the caller always wins;
* otherwise the innermost active :func:`tile_scope` override — how an
  ``Executor`` applies a tile configuration (``tile_overrides=``) while
  its nodes run, without threading a knob through every node closure;
* otherwise the kernel's built-in default.

:func:`record_tile_use` captures which kernels a run actually consulted
(and at which problem shapes) — the measured autotuner's search-space
discovery (``repro_torch.tuning.search``).

This module imports nothing of ``repro_torch.core``: the executor and
every ``kernels/*/ops.py`` import it at module load.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Iterator, Mapping, Optional

__all__ = [
    "register_tile_kernel",
    "registered_tile_kernels",
    "tile_candidates",
    "tile_distance",
    "resolve_tile",
    "tile_scope",
    "active_tiles",
    "record_tile_use",
    "note_tile_uses",
]

# kernel name -> candidates fn: (shape tuple) -> sequence of tile configs
_REGISTRY: dict[str, Callable[[tuple[int, ...]], tuple]] = {}
# stack of active override mappings (innermost last)
_SCOPE: list[Mapping[str, Any]] = []
# stack of active recorders: kernel -> set of (shape, default) pairs
_RECORDERS: list[dict[str, set]] = []


def _norm(tile):
    """Hashable, JSON-round-trippable form of a tile config (lists from a
    JSON cache load become tuples)."""
    if isinstance(tile, list):
        return tuple(_norm(t) for t in tile)
    if isinstance(tile, tuple):
        return tuple(_norm(t) for t in tile)
    return tile


def register_tile_kernel(name: str, candidates: Callable) -> Callable:
    """Register kernel ``name``'s ``tile_candidates(shape)`` hook.

    ``candidates`` maps a problem-shape tuple (each kernel documents its
    own convention — e.g. ``(n,)`` for 1-d record kernels, ``(nx, ny)``
    for 2-d stencils) to the tuple of feasible tile configs, including
    the kernel's default when it is feasible.  Returns ``candidates`` so
    it can be used as a decorator.

    Example::

        @partial(register_tile_kernel, "saxpy")
        def tile_candidates(shape):
            (n,) = shape
            return tuple(b for b in (256, 1024, 4096) if n % b == 0)
    """
    _REGISTRY[name] = candidates
    return candidates


def registered_tile_kernels() -> tuple[str, ...]:
    """Names of every kernel with a registered tile hook (sorted)."""
    return tuple(sorted(_REGISTRY))


def tile_candidates(kernel: str, shape) -> tuple:
    """Feasible tile configs of ``kernel`` for a problem ``shape``
    (empty when the kernel registered no hook)."""
    fn = _REGISTRY.get(kernel)
    if fn is None:
        return ()
    return tuple(_norm(t) for t in fn(tuple(shape)))


def tile_distance(tile, default) -> float:
    """Deterministic distance between a tile config and a kernel's
    default: the sum of ``|log2(t / d)|`` over numeric components (nested
    configs recurse; non-numeric components contribute 0 when equal, 1
    when not).  The joint autotuner uses it to order candidates
    near-default-first, so its HLO cost ranking breaks ties toward the
    configurations most likely to behave like the measured baseline."""
    import math

    tile, default = _norm(tile), _norm(default)
    if isinstance(tile, tuple) or isinstance(default, tuple):
        ts = tile if isinstance(tile, tuple) else (tile,)
        ds = default if isinstance(default, tuple) else (default,)
        if len(ts) != len(ds):
            return float(max(len(ts), len(ds)))
        return sum(tile_distance(t, d) for t, d in zip(ts, ds))
    if isinstance(tile, (int, float)) and isinstance(default, (int, float)) \
            and tile > 0 and default > 0:
        return abs(math.log2(tile / default))
    return 0.0 if tile == default else 1.0


def resolve_tile(kernel: str, explicit, default, shape=None):
    """The effective tile for one kernel invocation.

    Precedence: ``explicit`` (the caller's ``block=`` argument) over the
    innermost :func:`tile_scope` override over ``default``.  When a
    :func:`record_tile_use` recorder is active the consultation is
    logged (kernel name, ``shape``, ``default``) — the autotuner's
    search-space discovery.
    """
    if shape is not None and explicit is None:
        # explicit blocks are not tunable call sites: overrides would
        # never reach them, so recording them would waste measurements
        shape = tuple(shape)
        for rec in _RECORDERS:
            rec.setdefault(kernel, set()).add((shape, _norm(default)))
    if explicit is not None:
        return _norm(explicit)
    for scope in reversed(_SCOPE):
        if kernel in scope:
            return _norm(scope[kernel])
    return _norm(default)


@contextmanager
def tile_scope(config: Optional[Mapping[str, Any]]) -> Iterator[None]:
    """Make ``config`` (kernel name -> tile) the ambient tile overrides.

    Scopes nest; the innermost binding of a kernel wins.  The executor
    runs every device segment in the scope of its tile config.
    """
    if not config:
        yield
        return
    _SCOPE.append(config)
    try:
        yield
    finally:
        _SCOPE.pop()


def active_tiles() -> dict[str, Any]:
    """The merged ambient tile overrides currently in scope."""
    out: dict[str, Any] = {}
    for scope in _SCOPE:
        out.update(scope)
    return out


@contextmanager
def record_tile_use() -> Iterator[dict[str, set]]:
    """Record every :func:`resolve_tile` consultation inside the block.

    Yields a dict ``kernel -> {(shape, default), ...}`` that fills in as
    kernels are consulted (i.e. as node functions run).  The tuner
    runs its baseline measurement inside this to learn which kernels a
    graph uses and at which shapes.
    """
    rec: dict[str, set] = {}
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def note_tile_uses(uses: Mapping[str, set]) -> None:
    """Report consultations recorded earlier to every active recorder: a
    captured CUDA graph replays its kernels without calling
    :func:`resolve_tile`, so the executor notes what its capture
    consulted on each replay."""
    for rec in _RECORDERS:
        for kernel, entries in uses.items():
            rec.setdefault(kernel, set()).update(entries)
