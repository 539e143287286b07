"""Share of the profiled stretch of a step cell in which the device ran
no kernel, copy or fill, in %."""


def read(run):
    s = run.stretch
    if s is None or run.cell.unit != "step" or s.window_s <= 0:
        return None
    return 100 * (1 - s.busy_s / s.window_s)
