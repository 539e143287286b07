"""The readers of the port's own spans (``bench/spans.py``): each by hand
on a made-up session, None where there is nothing to read (no stretch, a
session without the spans, a program without them), and reported by a
traced run on the CPU."""

from __future__ import annotations

import sys

import pytest

from .common import run_small

from bench import harness, profile  # noqa: E402
from repro_torch.core import trace  # noqa: E402

READERS = ("launch_gap_us.step", "launch_gap_us.solve", "launch_us.solve",
           "callback_queue_ms")


class _Cell:
    def __init__(self, unit):
        self.unit = unit


def _run(unit, stretch=True):
    st = profile.Stretch(window_s=1.0, busy_s=0.9,
                         counts={"steps": 7, "iterations": 7})
    return harness.Run(_Cell(unit), {}, 1.0, 2.0, 10, {}, {},
                       st if stretch else None)


def _span(name, up, start_us, end_us, **attrs):
    s = trace.Span(name, up)
    s.start, s.end = int(start_us * 1e3), int(end_us * 1e3)
    s.attrs.update(attrs)
    return s


def _made_up():
    """Two calls; launches with their device gaps (none before a call's
    first launch), two callbacks 250 and 750 us behind their submits."""
    a = _span("ripple.call", None, 0, 1000)
    b = _span("ripple.call", None, 2000, 3000)
    spans = [a, b,
             _span("ripple.launch", a, 10, 110),
             _span("ripple.launch", a, 200, 260, gap_us=4.0),
             _span("ripple.launch", a, 300, 340, gap_us=8.0),
             _span("ripple.launch", b, 2010, 2030),
             _span("ripple.launch", b, 2100, 2120, gap_us=3.0)]
    s1 = _span("ripple.submit", a, 120, 150)
    s2 = _span("ripple.submit", a, 350, 400)
    spans += [s1, s2,
              _span("ripple.callback", a, 400, 500, submit=s1.id),
              _span("ripple.callback", a, 1150, 1200, submit=s2.id)]
    return trace.Session(spans=spans)


@pytest.fixture
def session(monkeypatch):
    made = _made_up()
    monkeypatch.setattr(trace, "session", lambda: made)
    return made


def test_span_readers_by_hand(session):
    read = harness.reader
    assert read("launch_gap_us.step")(_run("step")) == pytest.approx(5.0)
    assert read("launch_gap_us.solve")(_run("solve")) == pytest.approx(5.0)
    assert read("launch_us.solve")(_run("solve")) == pytest.approx(
        (100 + 60 + 40 + 20 + 20) / 5)
    assert read("callback_queue_ms")(_run("step")) == pytest.approx(
        (0.25 + 0.75) / 2)
    assert read("launch_gap_us.step")(_run("solve")) is None
    assert read("launch_gap_us.solve")(_run("step")) is None
    assert read("launch_us.solve")(_run("step")) is None
    assert read("callback_queue_ms")(_run("solve")) is None


@pytest.mark.parametrize("name", READERS)
def test_span_readers_without_a_stretch(session, name):
    unit = "solve" if name.endswith(".solve") else "step"
    assert harness.reader(name)(_run(unit, stretch=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_span_readers_on_a_session_without_their_spans(monkeypatch, name):
    a = _span("ripple.call", None, 0, 10)
    empty = trace.Session(spans=[a, _span("ripple.launch", a, 1, 2)])
    if name.startswith("launch_us"):
        empty.spans.pop()
    monkeypatch.setattr(trace, "session", lambda: empty)
    unit = "solve" if name.endswith(".solve") else "step"
    assert harness.reader(name)(_run(unit)) is None


@pytest.mark.parametrize("name", READERS)
def test_span_readers_in_a_program_without_spans(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    monkeypatch.delattr(sys.modules["repro_torch.core"], "trace")
    unit = "solve" if name.endswith(".solve") else "step"
    assert harness.reader(name)(_run(unit)) is None


@pytest.mark.parametrize("workload,metric", [
    ("eikonal.solve", "launch_us.solve"),
    ("particles.diag", "callback_queue_ms")])
def test_a_traced_cpu_run_reports_the_spans(monkeypatch, workload, metric):
    monkeypatch.setattr(trace, "_REC", trace._Recorder())
    assert run_small(workload, trace=False)["correct"]
    assert trace.session().spans == []        # --trace 0 records nothing
    r = run_small(workload, trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"][metric]["value"] > 0
    # no timing events on the CPU: no device gaps
    assert not any(m.startswith("launch_gap_us") for m in r["metrics"])
