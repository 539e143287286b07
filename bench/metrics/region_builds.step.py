"""Pieces the executor built (captured) during the window of a step cell:
``cache_stats()["trace_events"]``, which a steady run leaves unchanged."""


def read(run):
    if run.cell.unit != "step":
        return None
    return run.delta("trace_events")
