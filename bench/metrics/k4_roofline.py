"""K4's share of its roofline: the least time its work takes on the card
(the padded ``u`` read and ``du`` written, 4 float32 fields each, at the
memory rate, or its operations at the float32 rate, whichever is longer)
over its mean profiled device time a launch, in %."""

from bench import flux_bytes, roofline


def read(run):
    s = run.stretch
    if s is None or run.config.get("driver") != "flux":
        return None
    secs, launches = s.kernel_s("flux_difference")
    if not launches or secs <= 0:
        return None
    nx, ny = run.config["nx"], run.config["ny"]
    need = roofline.bound_s(flux_bytes.k4_bytes(nx, ny),
                            flux_bytes.k4_ops(nx, ny))
    return 100 * need / (secs / launches)
