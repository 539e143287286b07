"""Device milliseconds a step of the operations that are none of the
port's hand-written kernels and no copy (the max's, the graph's own ops),
from the profiled stretch."""


def read(run):
    s = run.stretch
    if s is None or run.cell.unit != "step" or not s.counts["steps"]:
        return None
    return s.group_s("torch_ops") * 1e3 / s.counts["steps"]
