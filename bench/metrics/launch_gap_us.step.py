"""Mean device microseconds, in the profiled stretch of a step cell, from
a launch's ``done`` to the next launch's ``go`` in the same call, over
the port's timed launches (one in ``trace.EVERY``): the device waiting
for the host between two pieces.  None on the CPU, which has no events."""

from bench import spans


def read(run):
    if run.cell.unit != "step":
        return None
    return spans.launch_gap_us(run)
