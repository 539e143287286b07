"""K5's share of its roofline: the least time its bytes take at the
card's memory rate (padded ``phi`` and the mask read, ``phi`` written)
over its mean profiled device time a launch, in %."""

from bench import roofline


def read(run):
    s = run.stretch
    if s is None:
        return None
    secs, launches = s.kernel_s("eikonal_fim")
    if not launches or secs <= 0:
        return None
    return 100 * roofline.bound_s(roofline.k5_bytes(run.config["n"])) \
        / (secs / launches)
