"""Rows of all one-shot scans answered in the window (each scan reads every
row of the table) over the window's seconds (host clock).  A layer's metric
of the cold cell: its runs move with the GPU machine's host from one process
to the next by more than an end-to-end bound may hold (PERF.md §2), so the
cell's rate is read in its traced runs, beside the layers that make it."""

LAYER = "front door"
UNIT = "rows/s"
MOVES = "device_peak_gb"


def read(run):
    return run.ops * run.table.n_rows / run.seconds if run.ops else None
