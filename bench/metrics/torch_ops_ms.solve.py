"""Device milliseconds an iteration of the solve's operations that are
none of the port's kernels and no copy (the change, its max), from the
profiled stretch."""


def read(run):
    s = run.stretch
    if s is None or run.cell.unit != "solve" or not s.counts["iterations"]:
        return None
    return s.group_s("torch_ops") * 1e3 / s.counts["iterations"]
