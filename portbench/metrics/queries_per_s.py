"""Queries answered in the window over the window's seconds (host clock)."""

UNIT = "queries/s"


def read(run):
    return run.ops / run.seconds if run.ops else None
