"""The program's host pattern compile a query: its `dpq.compile` spans
(`ops/regex.compile_pattern`, one a pattern compiled), summed over the
window, over the queries."""

from portbench import spans

LAYER = "host pattern compile"
UNIT = "ms"
MOVES = "query_p95_ms"


def read(run):
    return spans.span_ms_per_op(run, "dpq.compile")
