"""Rows of all one-shot scans answered in the window (each scan reads every
row of the table) over the window's seconds (host clock)."""

UNIT = "rows/s"


def read(run):
    return run.ops * run.table.n_rows / run.seconds if run.ops else None
