"""The whole particle step's share of the card's roofline: the least
time a step's bytes take at the memory rate (84 B a particle index) over
the window's time a step, in %."""

from bench import roofline


def read(run):
    if run.cell.unit != "step" or not run.units:
        return None
    need = roofline.bound_s(
        roofline.particle_step_bytes(run.config["particles"]))
    return 100 * need / (run.window_s / run.units)
