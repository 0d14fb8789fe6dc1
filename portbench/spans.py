"""What the program itself records while a `--trace 1` window runs under the
profiler: its `dpq.*` spans (`torch.profiler.record_function` events, the
profile's user annotations) and its counters
(`duckdb_parquet_parser_tpu_torch.utils.tracing.counters`, which count only
while a profiler records, so their totals are the window's).

A program without such a span or counter gives None here, and the metric
that reads it is left out of the result line.
"""

from __future__ import annotations


def span_ms(run, name: str) -> float | None:
    """The durations of the program's spans `name` over the window, summed,
    in ms; None where the profile holds none."""
    if run.trace is None:
        return None
    durations = [d for n, _t, d in run.trace.host if n == name]
    return 1e-3 * sum(durations) if durations else None


def span_ms_per_op(run, name: str) -> float | None:
    """`span_ms` over the window's answered operations."""
    total = span_ms(run, name)
    return total / run.ops if total is not None and run.ops else None


def counter(name: str) -> int | None:
    """The program's counter `name` over the window; None where the program
    keeps no counters."""
    try:
        from duckdb_parquet_parser_tpu_torch.utils import tracing
    except ImportError:
        return None
    counters = getattr(tracing, "counters", None)
    return None if counters is None else int(counters().get(name, 0))


def counter_per_op(run, name: str) -> float | None:
    """`counter` over the window's answered operations."""
    total = counter(name)
    return total / run.ops if total is not None and run.ops else None
