"""Milliseconds a step: the whole window, ended by a synchronize, over
every step completed in it."""


def read(run):
    if run.cell.unit != "step" or not run.units:
        return None
    return run.window_s * 1e3 / run.units
