"""Persistent tuning cache — measured decisions survive the process.

The port of ``repro/tuning/cache.py``.  One JSON file per tuning key
under ``$REPRO_TUNE_CACHE`` (or ``~/.cache/repro-tune``).  The key is
derived from the *heuristic* plan signature × the full device assortment
(:func:`device_assortment`: CUDA device names × compute capabilities ×
counts × process count) × torch and CUDA versions
(``repro_torch.tuning.search``), so a second process constructing an
``Executor`` over an identical graph on the same hardware (the serving
pattern) loads the tuned configuration with zero re-measurement — and a
process on DIFFERENT hardware misses instead of inheriting a wrong
decision.  The JAX package keys its entries with another prefix, so
neither package loads the other's decisions.

Robustness contract:

* files carry ``schema`` versioning — a version mismatch is treated as
  a miss (re-measured under ``tune="auto"``), never a crash;
* a corrupt / truncated / hand-edited-broken file falls back to
  heuristics with a SINGLE ``RuntimeWarning`` per file per process;
* writes are atomic (temp file + ``os.replace``) so a concurrent
  reader never observes a half-written entry;
* an in-process memo makes repeat loads free (no file IO on the second
  ``Executor(tune="auto")`` construction in the same process);
* cross-PROCESS tuning races serialize through a lock file
  (:func:`tuning_lock`): two processes auto-tuning the same key take
  the lock around measure+store, so the second blocks until the first
  persists and then LOADS instead of re-measuring.  The lock is
  advisory and crash-safe — a stale lock older than ``stale_s`` is
  broken (the holder died), and an unlockable directory degrades to
  running unlocked (worst case: duplicated measurement, last atomic
  write wins).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Optional

import torch

__all__ = ["SCHEMA_VERSION", "cache_dir", "cache_path", "device_assortment",
           "load", "store", "clear_memo", "tuning_lock"]

#: Current on-disk schema: entries carry the joint tuner's per-segment
#: layout assignments and proposed/pruned/measured counts (the JAX
#: package's schema 3).
SCHEMA_VERSION = 3

# in-process memo: key -> validated payload (None entries are not memoized
# so a file written later in the process is still picked up)
_MEMO: dict[str, dict] = {}
# cache files already warned about (the "single warning" contract)
_WARNED: set[str] = set()


def cache_dir() -> Path:
    """The tuning-cache directory: ``$REPRO_TUNE_CACHE`` if set, else
    ``~/.cache/repro-tune``."""
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-tune"


def cache_path(key: str) -> Path:
    """The JSON file holding the tuned decision for ``key``."""
    return cache_dir() / f"{key}.json"


def device_assortment() -> tuple:
    """The process's FULL device complement as a hashable key: sorted
    ``(platform, device name, compute capability, count)`` tuples over the
    visible CUDA devices (``("cpu", "cpu", None, 1)`` without one), plus
    the process count (``torch.distributed``'s world size when it is
    initialised, else 1).

    Measurements only transfer between identical assortments: a decision
    measured on one H100 must not hit on another card, on four of them,
    or in a multi-process group."""
    if torch.cuda.is_available():
        counts: dict[tuple, int] = {}
        for i in range(torch.cuda.device_count()):
            k = ("cuda", torch.cuda.get_device_name(i),
                 tuple(torch.cuda.get_device_capability(i)))
            counts[k] = counts.get(k, 0) + 1
        kinds = tuple(sorted(k + (n,) for k, n in counts.items()))
    else:
        kinds = (("cpu", "cpu", None, 1),)
    dist = torch.distributed
    procs = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return kinds, int(procs)


def _validate(payload: Any, key: str) -> dict:
    """Raise ``ValueError`` unless ``payload`` is a well-formed entry for
    ``key`` at :data:`SCHEMA_VERSION`."""
    if not isinstance(payload, dict):
        raise ValueError("payload is not an object")
    if payload.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"schema {payload.get('schema')!r} != "
                         f"{SCHEMA_VERSION}")
    if payload.get("key") != key:
        raise ValueError("key mismatch")
    for field in ("layouts", "tiles"):
        if not isinstance(payload.get(field), dict):
            raise ValueError(f"missing/invalid {field!r}")
    if not isinstance(payload.get("measurements", []), list):
        raise ValueError("invalid measurements")
    return payload


def load(key: str) -> Optional[dict]:
    """The cached payload for ``key``, or None (miss).

    A corrupt or schema-incompatible file warns ONCE per process and
    reads as a miss — the caller falls back to heuristics (``load`` mode)
    or re-measures and overwrites (``auto`` mode)."""
    memo = _MEMO.get(key)
    if memo is not None:
        return memo
    path = cache_path(key)
    _corrupt_if_scheduled(path)
    try:
        text = path.read_text()
    except FileNotFoundError:
        return None
    except OSError as exc:
        _warn_once(path, f"unreadable ({exc})")
        return None
    try:
        payload = _validate(json.loads(text), key)
    except (ValueError, TypeError) as exc:
        _warn_once(path, str(exc))
        return None
    _MEMO[key] = payload
    return payload


def _warn_once(path: Path, reason: str) -> None:
    s = str(path)
    if s in _WARNED:
        return
    _WARNED.add(s)
    warnings.warn(
        f"repro-tune cache {s} is corrupt or incompatible ({reason}) — "
        f"falling back to heuristic layouts/tiles", RuntimeWarning,
        stacklevel=3)


def store(key: str, payload: dict) -> None:
    """Atomically persist ``payload`` under ``key`` (and memoize it).

    An unwritable cache directory degrades to a warning — tuning still
    applies in-process, it just will not survive it."""
    payload = dict(payload, schema=SCHEMA_VERSION, key=key)
    _MEMO[key] = payload
    path = cache_path(key)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                   prefix=f".{key}.", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError as exc:
        warnings.warn(
            f"repro-tune cache {path} could not be written ({exc}) — "
            f"tuned configuration applies to this process only",
            RuntimeWarning, stacklevel=3)


def clear_memo() -> None:
    """Drop the in-process memo and warning dedup (tests)."""
    _MEMO.clear()
    _WARNED.clear()


def _corrupt_if_scheduled(path: Path) -> None:
    """Chaos hook: a scheduled ``tuning.cache.load`` fault of kind
    ``"corrupt"`` garbles the cache file in place before the read, so
    the corrupt-file fallback (warn once, treat as miss) is what gets
    exercised; ``"error"``-kind faults raise here instead."""
    from ..runtime.faults import current_plan

    plan = current_plan()
    if plan is None:
        return
    fault = plan.trip("tuning.cache.load", detail=str(path))
    if fault is not None and fault.kind == "corrupt" and path.exists():
        path.write_text("{ this is not json —")


# -- cross-process lock --------------------------------------------------------

@contextmanager
def tuning_lock(key: str, timeout_s: float = 120.0, stale_s: float = 600.0,
                poll_s: float = 0.05):
    """Advisory cross-process lock for one tuning key.

    ``O_CREAT | O_EXCL`` on ``<key>.lock`` is the atomic acquire (NFS-
    and POSIX-safe without fcntl); the holder's pid and timestamp go in
    the file for debuggability.  Waiters poll; a lock file older than
    ``stale_s`` is broken (its creator died mid-measure), and a waiter
    that cannot acquire within ``timeout_s`` — or cannot create files
    in the cache dir at all — proceeds UNLOCKED with a warning, because
    duplicated measurement is strictly better than a wedged process
    (the final ``os.replace`` in :func:`store` keeps whichever write
    lands last, both of which are valid measurements)."""
    lock = cache_dir() / f"{key}.lock"
    acquired = False
    deadline = time.monotonic() + timeout_s
    try:
        cache_dir().mkdir(parents=True, exist_ok=True)
    except OSError:
        yield False
        return
    while True:
        try:
            fd = os.open(str(lock), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                f.write(f"{os.getpid()} {time.time()}\n")
            acquired = True
            break
        except FileExistsError:
            try:
                age = time.time() - lock.stat().st_mtime
            except OSError:       # holder released between open and stat
                continue
            if age > stale_s:
                try:              # break the stale lock; race-safe: only
                    lock.unlink()  # one unlink succeeds, then both retry
                except OSError:
                    pass
                continue
            if time.monotonic() > deadline:
                warnings.warn(
                    f"repro-tune lock {lock} held for {timeout_s:.0f}s — "
                    f"proceeding unlocked (duplicate measurement)",
                    RuntimeWarning, stacklevel=3)
                break
            time.sleep(poll_s)
        except OSError as exc:
            warnings.warn(
                f"repro-tune lock {lock} could not be created ({exc}) — "
                f"proceeding unlocked", RuntimeWarning, stacklevel=3)
            break
    try:
        yield acquired
    finally:
        if acquired:
            try:
                lock.unlink()
            except OSError:
                pass
