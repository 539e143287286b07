"""Device milliseconds an iteration of the solve's copies (memcpy nodes
and copy kernels: the halo fill, ``phi_prev <- phi``), from the profiled
stretch."""


def read(run):
    s = run.stretch
    if s is None or run.cell.unit != "solve" or not s.counts["iterations"]:
        return None
    return s.group_s("copies") * 1e3 / s.counts["iterations"]
