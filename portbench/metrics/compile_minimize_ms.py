"""The DFA minimization of the host pattern compile a query (the Moore
refinement and the renumbering): the program's `dpq.compile.minimize`
spans (`ops/regex.minimize_dfa`), summed over the window, over the
queries."""

from portbench import spans

LAYER = "host pattern compile"
UNIT = "ms"
MOVES = "query_p95_ms"


def read(run):
    return spans.span_ms_per_op(run, "dpq.compile.minimize")
