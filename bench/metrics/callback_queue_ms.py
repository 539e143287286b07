"""Mean host milliseconds, in the profiled stretch, from a callback's
``ripple.submit`` end to its ``ripple.callback`` start: how stale a
diagnostic is when the host reads it."""

from bench import spans


def read(run):
    if run.cell.unit != "step":
        return None
    return spans.callback_queue_ms(run)
