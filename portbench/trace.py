"""What a `--trace 1` run reads: spans from the benchmark's own wrappers
around the calls into the program's layers, and the device's work from
`torch.profiler`.

Wrapped calls (the span name, then the layer):

- `ops/scan.prepare_patterns` -> "compile": the host pattern compile
  (`ops/regex.compile_pattern` for each pattern of a query);
- `ops/scan.scan_buckets` -> "scan_step": the resident scan step, from the
  accept table to the counts back on the host;
- `host/reader.ParquetReader.prescan` -> "prescan": the native prescan (of
  the first row group, then of the whole column where `scan_streaming`
  finds pages over the split size and takes the resident route);
- `ops/scan.split_payload_pages` -> "split_plan": the native re-chunking of
  big pages at value boundaries;
- `ops/scan.resident_buckets` -> "upload": the column's arrays and byte
  stream copied to the card.

Each span also enters `torch.profiler.record_function`, so the trace shows
what the host was doing while the device sat idle.  Nothing inside the
program changes; the wrappers are removed when the window closes.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from duckdb_parquet_parser_tpu_torch.host.reader import ParquetReader
from duckdb_parquet_parser_tpu_torch.ops import scan as pscan

WRAPPED = [(pscan, "prepare_patterns", "compile"),
           (pscan, "scan_buckets", "scan_step"),
           (ParquetReader, "prescan", "prescan"),
           (pscan, "split_payload_pages", "split_plan"),
           (pscan, "resident_buckets", "upload")]
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Spans:
    """Installs the wrappers; `seconds[name]` sums each span's host time."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.count: dict[str, int] = {}
        self._lock = threading.Lock()
        self._undo = []
        for owner, attr, name in WRAPPED:
            self._wrap(owner, attr, name)

    def _wrap(self, owner, attr, name) -> None:
        original = getattr(owner, attr)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(name):
                    return original(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + dt
                    self.count[name] = self.count.get(name, 0) + 1

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, original))

    def close(self) -> None:
        for owner, attr, original in reversed(self._undo):
            setattr(owner, attr, original)
        self._undo = []


@dataclass
class Trace:
    """The device's operations [(name, cat, start us, duration us)] and the
    host's annotations [(name, start us, duration us)] of one window."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    def seconds_of(self, pred) -> float:
        return sum(d for n, c, _t, d in self.device if pred(n, c)) * 1e-6

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's operations, as [start, end) in us."""
        spans = sorted((t, t + d) for _n, _c, t, d in self.device)
        out: list[list[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_seconds(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def window(self) -> tuple[float, float] | None:
        """The traced window: from the first query's start to the last
        query's end, as the "query" annotations give them."""
        qs = [(t, t + d) for n, t, d in self.host if n == "query"]
        return (min(a for a, _ in qs), max(b for _, b in qs)) if qs else None

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the window, each named by the innermost host annotation
        under its middle ("host" where none is)."""
        by_name: dict[str, float] = {}
        for n, _c, _t, d in self.device:
            by_name[n] = by_name.get(n, 0.0) + d * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        win = self.window()
        gaps = []
        if win is not None:
            edges = [win[0]]
            for a, b in self.busy():
                edges += [a, b]
            edges.append(win[1])
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    gaps.append((a, b))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            under = [(t, n) for n, t, d in self.host if t <= mid < t + d]
            named.append([max(under)[1] if under else "host", (b - a) * 1e-6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def read_profile(prof, path: Path) -> Trace:
    """The profile's device operations and annotations, through its Chrome
    trace (written to `path`, a fixed file that the next run overwrites)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    tr = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            tr.device.append((e["name"], cat, float(e["ts"]), float(e["dur"])))
        elif cat == "user_annotation":
            tr.host.append((e["name"], float(e["ts"]), float(e["dur"])))
    return tr
