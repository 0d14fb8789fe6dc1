"""The epsilon closures and the subset construction of the host pattern compile a
query: the program's `dpq.compile.subset` spans (inside
`ops/regex.compile_pattern`), summed over the window, over the queries."""

from portbench import spans

LAYER = "host pattern compile"
UNIT = "ms"
MOVES = "query_p95_ms"


def read(run):
    return spans.span_ms_per_op(run, "dpq.compile.subset")
