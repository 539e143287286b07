"""Iterations a solve (``Converging.iterations``), over the window's
solves."""


def read(run):
    if run.cell.unit != "solve" or not run.units:
        return None
    return run.delta("iterations") / run.units
