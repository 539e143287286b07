"""Milliseconds a solve: the whole window over the solves completed in
it, each from its reset to the host's read of its last predicate."""


def read(run):
    if run.cell.unit != "solve" or not run.units:
        return None
    return run.window_s * 1e3 / run.units
