"""The resident scan step a query: the program's `dpq.step` spans
(`ops/scan.scan_buckets`: the accept table, the walks and dictionary
counts, the copies back), summed over the window, over the queries."""

from portbench import spans

LAYER = "scan step"
UNIT = "ms"
MOVES = "query_p95_ms"


def read(run):
    return spans.span_ms_per_op(run, "dpq.step")
