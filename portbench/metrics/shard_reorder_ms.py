"""The reorder of the sharded scan's plan a scan: the program's
`dpq.shard_plan.reorder` spans (`parallel/partition.reorder_pages`, the
per-page arrays and the string tables permuted into rank-major order),
summed over rank 0's window, over the scans."""

from portbench import spans

LAYER = "sharded scan"
UNIT = "ms"
MOVES = "device_peak_gb"


def read(run):
    return spans.span_ms_per_op(run, "dpq.shard_plan.reorder")
