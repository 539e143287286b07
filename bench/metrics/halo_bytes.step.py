"""Megabytes a step that the executor's halo assembly writes:
``cache_stats()["halo_bytes"]``, each built piece run once (one step of
a device-only graph).  None where the program does not count them."""


def read(run):
    if run.cell.unit != "step" or run.after.get("halo_bytes") is None:
        return None
    return run.after["halo_bytes"] / 1e6
