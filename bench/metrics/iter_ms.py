"""Milliseconds an iteration of the solve: the whole window over every
iteration of its solves."""


def read(run):
    if run.cell.unit != "solve" or not run.delta("iterations"):
        return None
    return run.window_s * 1e3 / run.delta("iterations")
