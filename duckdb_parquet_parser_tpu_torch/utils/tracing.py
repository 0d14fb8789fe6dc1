"""Profiling hooks: torch.profiler traces + named stage annotations.

Port of `duckdb_parquet_parser_tpu/utils/tracing.py`: every pipeline stage
can be wrapped so its host and device work shows up named in a
torch.profiler timeline, and on a CUDA machine as an NVTX range too;
`annotate` is the decorator form of `stage`.
"""

from __future__ import annotations

import functools
import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch


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


@contextmanager
def stage(name: str):
    """Names the enclosed work in profiler timelines."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def annotate(name: str):
    """Decorator form of `stage`: every call of the function is a span
    named `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with stage(name):
                return fn(*a, **kw)
        return wrapped
    return deco
