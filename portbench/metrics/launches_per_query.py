"""Kernel launches a query: the program's launch counters of the stream
matcher (K1), the dictionary kernel (K2) and the table-DFA walk (K3) over
the window, over the queries."""

LAYER = "scan step"
UNIT = "launches"
MOVES = "query_p95_ms"


def read(run):
    return sum(run.launches.values()) / run.ops if run.ops else None
