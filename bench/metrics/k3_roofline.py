"""K3's share of its roofline: the least time its bytes take at the
card's memory rate (``x`` and ``v`` read, ``x`` written, 36 B a
particle) over its mean profiled device time a launch, in %."""

from bench import roofline


def read(run):
    s = run.stretch
    if s is None:
        return None
    secs, launches = s.kernel_s("particle_update")
    if not launches or secs <= 0:
        return None
    return 100 * roofline.bound_s(roofline.k3_bytes(run.config["particles"])) \
        / (secs / launches)
