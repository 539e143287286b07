"""Milliseconds a step that the host waited inside calls for queued work
(``Executor.async_stats["wait_s"]`` across the window), where a host
callback runs every step.  Most of it is the end-of-call drain, in which
the host waits for the device to finish the call's queued steps, so it
moves with the device time a call queues as much as with the
dispatcher."""


def read(run):
    if run.cell.unit != "step" or not run.delta("logged") or not run.units:
        return None
    return run.delta("wait_s") * 1e3 / run.units
