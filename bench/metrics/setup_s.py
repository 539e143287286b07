"""Set-up: the process's start to the first timed call (import, inputs
from the seed, the executor, the warm calls that build and capture)."""


def read(run):
    return run.setup_s
