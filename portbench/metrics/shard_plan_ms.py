"""The sharded scan's page plan a scan: the program's `dpq.shard_plan`
spans (`ScanEngine.scan` with a mesh: pad pages, byte weights,
`assign_balanced_equal`, `reorder_pages`), summed over rank 0's window,
over the scans."""

from portbench import spans

LAYER = "sharded scan"
UNIT = "ms"
MOVES = "device_peak_gb"


def read(run):
    return spans.span_ms_per_op(run, "dpq.shard_plan")
