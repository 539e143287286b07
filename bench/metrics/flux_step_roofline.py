"""The whole marched step's share of the card's roofline: the least time
a step's needed bytes take at the memory rate (``u`` read and written,
32 B a cell) over the window's time a step, in %."""

from bench import flux_bytes, roofline


def read(run):
    if run.cell.unit != "step" or not run.units \
            or run.config.get("driver") != "flux":
        return None
    need = roofline.bound_s(
        flux_bytes.step_bytes(run.config["nx"], run.config["ny"]))
    return 100 * need / (run.window_s / run.units)
