"""What the port's own spans (``repro_torch.core.trace``) say about the
profiled stretch: the newest profiler session, which holds the
stretch's warm call and its timed calls.  So every number here is a mean
over the session's spans, never a count over ``run.stretch.counts``.
Each returns None without a stretch, in a program without the spans, or
where the session has none of the spans it reads.
"""

from __future__ import annotations


def session(run):
    """The spans of ``run``'s profiled stretch, or None."""
    if run.stretch is None:
        return None
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    return trace.session()


def _mean(values: list):
    return sum(values) / len(values) if values else None


def launch_gap_us(run):
    """Mean device microseconds from a launch's ``done`` event to the next
    launch's ``go`` in the same call, over the timed launches (one in
    ``trace.EVERY``, each with ``gap_us``): the device waiting for the
    host before a launch, the ``go`` record's own cost included."""
    s = session(run)
    if s is None:
        return None
    return _mean([sp.attrs["gap_us"] for sp in s.named("ripple.launch")
                  if "gap_us" in sp.attrs])


def launch_us(run):
    """Mean host microseconds of a ``ripple.launch`` span: a piece's
    staging and the replay call."""
    s = session(run)
    if s is None:
        return None
    return _mean([sp.us for sp in s.named("ripple.launch")])


def callback_queue_ms(run):
    """Mean host milliseconds from a callback's ``ripple.submit`` end to
    its ``ripple.callback`` start: how long a diagnostic waits in the
    queue."""
    s = session(run)
    if s is None:
        return None
    submits = {sp.id: sp for sp in s.named("ripple.submit")}
    return _mean([(cb.start - submits[cb.attrs["submit"]].end) / 1e6
                  for cb in s.named("ripple.callback")
                  if cb.attrs.get("submit") in submits])
