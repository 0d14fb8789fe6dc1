"""The front door's own time a query: the program's `dpq.query` spans (the
whole call of `ResidentColumn.scan`) less its `dpq.compile` and `dpq.step`
spans (what remains: matcher resolution, result assembly and copies),
summed over the window, over the queries."""

from portbench import spans

LAYER = "front door"
UNIT = "ms"
MOVES = "query_p95_ms"


def read(run):
    query = spans.span_ms(run, "dpq.query")
    if query is None or not run.ops:
        return None
    inner = sum(spans.span_ms(run, name) or 0.0
                for name in ("dpq.compile", "dpq.step"))
    return (query - inner) / run.ops
