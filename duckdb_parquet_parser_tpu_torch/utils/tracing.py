"""Profiling hooks: torch.profiler traces, named spans and counters.

Port of `duckdb_parquet_parser_tpu/utils/tracing.py`.  The switch is the
profiler itself: while a torch profiler records on the calling thread,
`stage(name)` opens a `torch.profiler.record_function` span (so Kineto puts
it on the timeline of the card's kernels and copies) and `count(name, n)`
adds to a process-wide total; otherwise each costs one check of the
profiler's state.  `annotate` is the decorator form of `stage`, and
`front_door` the span of a public entry point, `dpq.query`, opened by the
outermost such call of a thread only.  `counters()` returns a copy of the
totals, which hold what the traced windows of the process counted.  No
span or counter reads a device tensor or synchronises.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import torch

_profiling = torch.autograd._profiler_enabled
_off = contextlib.nullcontext()
_counts: dict[str, int] = {}
_counts_lock = threading.Lock()
_local = threading.local()


@contextmanager
def trace_session(out_dir: str | None):
    """Collects a torch.profiler trace of the enclosed block and writes it
    to `out_dir` as a Chrome trace (no-op if out_dir is None)."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(Path(out_dir) / f"trace-{os.getpid()}-{time.time_ns()}.json"))


def stage(name: str):
    """A context manager naming the enclosed work in profiler timelines:
    a `record_function` span while a profiler records, else nothing."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _off


def annotate(name: str):
    """Decorator form of `stage`: every call of the function is a span
    named `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            if not _profiling():
                return fn(*a, **kw)
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return wrapped
    return deco


def front_door(fn):
    """Decorator of a public entry point: its call is one `dpq.query` span,
    unless it runs inside another front door's call on this thread."""
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        if not _profiling() or getattr(_local, "in_query", False):
            return fn(*a, **kw)
        _local.in_query = True
        try:
            with torch.profiler.record_function("dpq.query"):
                return fn(*a, **kw)
        finally:
            _local.in_query = False
    return wrapped


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name` while a profiler records."""
    if _profiling():
        with _counts_lock:
            _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> dict[str, int]:
    """A copy of the counters' totals."""
    with _counts_lock:
        return dict(_counts)
