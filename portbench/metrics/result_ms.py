"""The front door's own time a query: `ResidentColumn.scan`'s latency less
its compile and scan step spans (result assembly and copies), over the
queries."""

LAYER = "front door"
UNIT = "ms"
MOVES = "query_p95_ms"


def read(run):
    if not run.ops:
        return None
    own = sum(run.latencies) - run.span_seconds("compile") \
        - run.span_seconds("scan_step")
    return 1e3 * own / run.ops
