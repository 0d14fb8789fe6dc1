"""Set-up: from the start of the run to the window's start (host clock):
making and writing the table, loading it, building kernels where a run
must, and warming up every query of the pool."""

UNIT = "s"


def read(run):
    return run.setup_s
