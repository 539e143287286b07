"""Pieces the executor built (captured) during the window of a solve
cell: ``cache_stats()["trace_events"]``."""


def read(run):
    if run.cell.unit != "solve":
        return None
    return run.delta("trace_events")
