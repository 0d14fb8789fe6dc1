"""The page assignment of the sharded scan's plan a scan: the program's
`dpq.shard_plan.assign` spans (`parallel/partition.assign_balanced_equal`,
heaviest page first onto the lightest rank that has room), summed over
rank 0's window, over the scans."""

from portbench import spans

LAYER = "sharded scan"
UNIT = "ms"
MOVES = "device_peak_gb"


def read(run):
    return spans.span_ms_per_op(run, "dpq.shard_plan.assign")
