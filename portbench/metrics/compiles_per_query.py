"""Patterns compiled a query: the program's `compiles` counter (one a call
of `ops/regex.compile_pattern`) over the window, over the queries."""

from portbench import spans

LAYER = "host pattern compile"
UNIT = "compiles"
MOVES = "query_p95_ms"


def read(run):
    return spans.counter_per_op(run, "compiles")
