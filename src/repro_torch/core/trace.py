"""Spans inside the port, on the profiler's clock.

A span is one piece of the executor's work (``ripple.call``,
``ripple.launch``, ...; ``core/executor.py``'s docstring lists them),
recorded where the work happens.  Spans record only while a
``torch.profiler`` session records: every site reads the profiler's own
flag (``torch.autograd.profiler._is_profiler_enabled``, a plain bool)
and, off, returns a shared do-nothing context, allocating nothing.  On,
a span

* opens a user range in the profiler (``_record_function_with_args_enter``,
  what ``record_function`` opens, without its trip through the operator
  dispatcher, which costs three times as much), so that it sits in the
  profiler's trace (a ``user_annotation`` event) on the same clock as the
  device's kernels, and an idle gap of the device can be put down to the
  span around it;
* keeps a :class:`Span` in the process's buffer: its name, start and end
  (``time.perf_counter_ns``), its parent, its call's id (the id of the
  ``ripple.call`` span, which every span of one ``Executor.run``
  shares), its thread and a few attributes.

On the card one launch in :data:`EVERY` is timed: the launch before it
records a timing event ``done`` just after its replay, it records ``go``
just before its own, and if both are of one call it gets ``gap_us``, the
device's microseconds from ``done`` to ``go``: the time the device
waited for the host before it.  Under the profiler the stream lookup and
the record cost more than a span, and ``go`` lies in the gap it
measures, so the other launches record none.  A pair's events go back
to a pool (an event made under the profiler costs about a launch) once a
non-blocking query after the timed launch finds them passed;
:func:`session` resolves the rest.

The buffer keeps the newest session's spans: the first span that finds
the profiler on after a site found it off, or after :func:`session` read
the buffer, starts a new one.  It holds at most :data:`LIMIT` spans and
counts the ones it drops.

    with torch.profiler.profile():
        ex.run(state, 10)
    s = trace.session()
    launches = s.named("ripple.launch")
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from time import perf_counter_ns
from typing import Optional

import torch
from torch.autograd import _record_function_with_args_enter as _range_open
from torch.autograd import _record_function_with_args_exit as _range_close
from torch.autograd import profiler as _profiler

__all__ = ["EVERY", "LIMIT", "Session", "Span", "session", "span"]

LIMIT = 1 << 16
# odd, so that the timed launches fall on each piece of a step in turn
# (on all of them wherever a step's pieces are not a multiple of 7)
EVERY = 7


class Span:
    """One span: ``name``, ``id``, ``up`` (the span it lies in, or None),
    ``call`` (the id of its ``ripple.call``), ``thread``, ``start`` and
    ``end`` (``perf_counter_ns``), ``attrs``; ``go`` and ``done``, a
    launch's timing events on the card (None elsewhere, and once its
    pair's ``gap_us`` is known)."""

    __slots__ = ("name", "id", "up", "call", "thread", "start", "end",
                 "attrs", "go", "done", "_range")

    def __init__(self, name: str, up: Optional["Span"]):
        self.name = name
        self.id = next(_IDS)
        self.up = up
        self.call = self.id if up is None else up.call
        self.thread = threading.get_ident()
        self.attrs: dict = {}
        self.go = self.done = None
        self.start = self.end = 0

    def __enter__(self) -> "Span":
        _stack().append(self)
        self._range = _range_open(self.name)
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = perf_counter_ns()
        _range_close(self._range)
        self._range = None
        _stack().pop()
        _REC.keep(self)
        return False

    def replay(self, graph, device) -> None:
        """``graph.replay()`` as this launch: ``go`` before it if this is
        a timed launch, ``done`` after it if the next one is."""
        n = _REC.launches = _REC.launches + 1
        if n % EVERY == 0:
            self.go = _REC.event()
            self.go.record(torch.cuda.current_stream(device))
        graph.replay()
        if n % EVERY == EVERY - 1:
            self.done = _REC.event()
            self.done.record(torch.cuda.current_stream(device))

    @property
    def parent(self) -> Optional[int]:
        """The id of the span this one lies in, or None."""
        return None if self.up is None else self.up.id

    @property
    def us(self) -> float:
        """The span's host microseconds."""
        return (self.end - self.start) / 1e3

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"call={self.call}, {self.us:.1f} us, {self.attrs})")


class _Off:
    """What a site gets while the profiler is off: enters as None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> list:
    """The spans open on this thread, innermost last."""
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


@dataclass
class Session:
    """The spans of one profiler session, in the order they ended, and
    its counters: ``dropped``, the spans past :data:`LIMIT`."""

    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=lambda: {"dropped": 0})

    def named(self, name: str) -> list:
        """The spans called ``name``."""
        return [s for s in self.spans if s.name == name]


class _Recorder:
    """The process's buffer: the newest session, whether it is still
    open (``live``), the session's launches so far, the pooled timing
    events, the launch whose ``done`` the next timed launch reads
    (``last``), and the timed pairs whose gap is not known yet
    (``pending``, in the stream's order)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.current = Session()
        self.live = False
        self.launches = 0
        self.events: list = []
        self.last: Optional[Span] = None
        self.pending: deque = deque()

    def begin(self) -> None:
        """Start a new session; the old one's events go back to the
        pool, their gaps unread."""
        with self.lock:
            if self.live:
                return
            self.current = Session()
            self.launches = 0
            for a, b in self.pending:
                self.events += (a.done, b.go)
            self.pending.clear()
            if self.last is not None:
                self.events.append(self.last.done)
                self.last = None
            self.live = True

    def keep(self, s: Span) -> None:
        """Buffer a span that ended; a timed launch then settles what
        the device has passed."""
        cur = self.current
        if len(cur.spans) < LIMIT:
            cur.spans.append(s)
        else:
            cur.counters["dropped"] += 1
        if s.done is None and s.go is None:
            return
        with self.lock:
            if s.done is not None:
                if self.last is not None:   # its timed launch never came
                    self.events.append(self.last.done)
                    self.last.done = None
                self.last = s
                return
            a, self.last = self.last, None
            if a is None or a.call != s.call:
                self.events.append(s.go)
                s.go = None
                if a is not None:
                    self.events.append(a.done)
                    a.done = None
                return
            self.pending.append((a, s))
            self.settle(wait=False)

    def event(self):
        try:
            return self.events.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def settle(self, wait: bool) -> None:
        """Give each pending pair whose ``go`` the device has passed
        (every pair, waiting, with ``wait``) its ``gap_us``, and pool its
        events.  Under the lock."""
        while self.pending:
            a, b = self.pending[0]
            if wait:
                b.go.synchronize()
            elif not b.go.query():
                return
            self.pending.popleft()
            b.attrs["gap_us"] = a.done.elapsed_time(b.go) * 1e3
            self.events += (a.done, b.go)
            a.done = b.go = None


_REC = _Recorder()


def span(name: str, parent: Optional[Span] = None):
    """A context for one span: a :class:`Span` (entered as itself) while
    the profiler records, else a shared one that enters as None.  Its
    parent is ``parent`` or the innermost span open on this thread."""
    if not _profiler._is_profiler_enabled:
        _REC.live = False
        return _OFF
    if not _REC.live:
        _REC.begin()
    if parent is None:
        stack = _stack()
        parent = stack[-1] if stack else None
    return Span(name, parent)


def session() -> Session:
    """The newest profiler session's spans and counters, each timed
    launch's ``gap_us`` resolved (this waits for the events it reads).
    The next span that finds the profiler on starts a new session."""
    with _REC.lock:
        _REC.live = False
        _REC.settle(wait=True)
        return _REC.current
