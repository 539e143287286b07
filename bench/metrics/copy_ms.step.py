"""Device milliseconds a step of the copies (memcpy nodes and copy
kernels: the halo fill of a padded record), from the profiled
stretch."""


def read(run):
    s = run.stretch
    if s is None or run.cell.unit != "step" or not s.counts["steps"]:
        return None
    return s.group_s("copies") * 1e3 / s.counts["steps"]
