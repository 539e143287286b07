"""Deterministic shard-aware data pipeline, as ``repro.data.pipeline``.

Two sources, both numpy and bit for bit the reference's batches:

* :class:`SyntheticLM` — a counter-hash token stream (splitmix64): batch i
  is a pure function of (seed, step, shard), so every data-parallel
  worker regenerates exactly its shard, and a restart resumes by the step
  counter alone;
* :class:`MemmapCorpus` — a binary token file (``np.memmap``) cut into
  fixed-length windows, sharded round-robin.

:class:`Prefetcher` runs the source on a background thread and moves each
batch to the device ahead of the consumer: the batch is copied into a
pinned host buffer, then to the GPU with ``non_blocking=True`` on a side
stream, and the consumer's stream waits on that copy's event before it
reads.  A pinned buffer is refilled only after its last copy finished.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["SyntheticLM", "MemmapCorpus", "Prefetcher", "make_batches"]

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
    return z ^ (z >> np.uint64(31))


@dataclass
class SyntheticLM:
    """Deterministic synthetic LM batches: tokens[b, s] = h(seed, step,
    global_row, s) % vocab; labels = the next token."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0            # this worker's data-parallel shard
    num_shards: int = 1

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {self.num_shards} shards")
        self.local_batch = self.global_batch // self.num_shards

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """``{"tokens", "labels"}``, int32 ``(local_batch, seq_len)``."""
        rows = (self.shard * self.local_batch
                + np.arange(self.local_batch, dtype=np.uint64))
        s = np.arange(self.seq_len + 1, dtype=np.uint64)
        base = (np.uint64(self.seed) * np.uint64(0x9E3779B1)
                + np.uint64(step) * np.uint64(0x85EBCA77))
        key = base + rows[:, None] * np.uint64(1 << 32) + s[None, :]
        toks = (_splitmix64(key) % np.uint64(self.vocab_size)).astype(
            np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass
class MemmapCorpus:
    """Fixed-window LM batches from a flat binary token file."""

    path: str
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    shard: int = 0
    num_shards: int = 1

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {self.num_shards} shards")
        self.local_batch = self.global_batch // self.num_shards
        self.tokens = np.memmap(self.path, dtype=self.dtype, mode="r")
        self.windows = (len(self.tokens) - 1) // self.seq_len

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Round-robin windows across (step, shard, row): deterministic
        and disjoint across shards."""
        row0 = step * self.global_batch + self.shard * self.local_batch
        idx = (row0 + np.arange(self.local_batch)) % self.windows
        starts = idx * self.seq_len
        toks = np.stack([self.tokens[s: s + self.seq_len + 1]
                         for s in starts]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class _Staging:
    """One pinned host buffer per batch key and the event of its last
    copy to the device."""

    def __init__(self):
        self.host: dict[str, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None


class Prefetcher:
    """Background-thread prefetch (a depth-``depth`` pipeline) of
    ``source.batch_at(step)`` onto ``device`` (``None``: the GPU).

    Each batch (a dict of numpy arrays, after ``transform``) arrives as a
    dict of tensors on the device.  On the GPU the producer thread copies
    it into one of ``depth + 1`` sets of pinned buffers and from there to
    the device on its own stream; :meth:`next` makes the caller's current
    stream wait on that copy's event.  Before it refills a set of pinned
    buffers the producer waits for that set's previous copy.

    As the reference's: batches are never dropped (the producer blocks,
    stop-aware, until the consumer frees a slot), a producer exception
    re-raises in the consumer from :meth:`next` with the failing step,
    and :meth:`close` leaves no thread behind."""

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 transform=None, device: Any = None):
        self.source = source
        self.depth = depth
        self.transform = transform or (lambda x: x)
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._error_step: Optional[int] = None
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            # depth batches may wait in the queue and one be in the
            # consumer's hands while the producer fills another
            self._staging = [_Staging() for _ in range(depth + 1)]
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="repro-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that still honours close(); True if enqueued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, batch: dict, staging: _Staging):
        if not self._cuda:
            return {k: torch.from_numpy(np.array(v)) for k, v in
                    batch.items()}, None
        if staging.copied is not None:
            staging.copied.synchronize()   # its last copy has left it
        out = {}
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            for k, v in batch.items():
                src = torch.from_numpy(np.ascontiguousarray(v))
                buf = staging.host.get(k)
                if buf is None or buf.shape != src.shape or \
                        buf.dtype != src.dtype:
                    buf = torch.empty_like(src, pin_memory=True)
                    staging.host[k] = buf
                buf.copy_(src)
                out[k] = buf.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        staging.copied = ev
        return out, ev

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                staging = self._staging[step % len(self._staging)] \
                    if self._cuda else None
                batch, ev = self._to_device(
                    self.transform(self.source.batch_at(step)), staging)
            except BaseException as e:
                self._error_step = step
                self._error = e
                self._put((step, e, None))  # wake the consumer
                return
            if not self._put((step, batch, ev)):
                return
            step += 1

    def next(self) -> tuple[int, dict]:
        """The next ``(step, batch)`` in order, readable on the caller's
        current stream; re-raises a producer exception (chained, with the
        failing step) instead of hanging."""
        if self._error is not None and self._q.empty():
            raise RuntimeError(
                f"prefetch producer failed at step {self._error_step}"
            ) from self._error
        step, batch, ev = self._q.get()
        if isinstance(batch, BaseException):
            raise RuntimeError(
                f"prefetch producer failed at step {step}") from batch
        if ev is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ev)
            for t in batch.values():   # freed on the consumer's stream
                t.record_stream(stream)
        return step, batch

    def close(self):
        """Stop the producer and reap the thread (draining the queue until
        the producer notices the stop event)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.2)
        self._thread.join()


def make_batches(source, steps: int, start_step: int = 0):
    """``(step, source.batch_at(step))`` for ``steps`` steps."""
    for s in range(start_step, start_step + steps):
        yield s, source.batch_at(s)
