"""The resident scan step a query: the span of `ops/scan.scan_buckets` (the
accept table, the walks and dictionary counts, the copies back), summed
over the window, over the queries."""

LAYER = "scan step"
UNIT = "ms"
MOVES = "query_p95_ms"


def read(run):
    return 1e3 * run.span_seconds("scan_step") / run.ops if run.ops else None
