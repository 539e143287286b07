"""The whole solve's share of the card's roofline: the least time the
reference's iterations of this input take at the memory rate (9 B a cell
an iteration) over the window's time a solve, in %."""

from bench import roofline


def read(run):
    iters = getattr(run.cell, "ref_iterations", None)
    if run.cell.unit != "solve" or not run.units or not iters:
        return None
    need = roofline.bound_s(roofline.solve_bytes(run.config["n"], iters))
    return 100 * need / (run.window_s / run.units)
