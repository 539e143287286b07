"""The 95th percentile of the host-clock gaps between successive
diagnostics logged in the window, in milliseconds."""

import statistics

import numpy as np


def read(run):
    if run.cell.unit != "step" or run.delta("logged") < 21:
        return None
    stamps = run.cell.stamps(run.before["logged"], run.after["logged"])
    return statistics.quantiles(np.diff(stamps) * 1e3, n=100)[94]
