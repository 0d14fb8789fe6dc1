"""Host pattern compile a query: the span of `ops/scan.prepare_patterns`
(`ops/regex.compile_pattern`), summed over the window, over the queries."""

LAYER = "host pattern compile"
UNIT = "ms"
MOVES = "query_p95_ms"


def read(run):
    return 1e3 * run.span_seconds("compile") / run.ops if run.ops else None
