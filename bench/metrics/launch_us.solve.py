"""Mean host microseconds of a ``ripple.launch`` span (a piece's staging
and the replay call) in the profiled stretch of a solve cell."""

from bench import spans


def read(run):
    if run.cell.unit != "solve":
        return None
    return spans.launch_us(run)
