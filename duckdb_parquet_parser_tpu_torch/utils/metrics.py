"""Structured per-stage metrics; the port's own copy of
`duckdb_parquet_parser_tpu/utils/metrics.py` (SURVEY.md §5: the reference has only ad-hoc
prints; the engine emits JSON records per stage: pages decoded, GB/s/chip,
rows/s, shuffle bytes, skew factor)."""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Metrics:
    records: list = field(default_factory=list)
    sink: object = None  # file-like; default stderr

    def emit(self, stage: str, **kv) -> dict:
        rec = {"stage": stage, "ts": time.time(), **kv}
        self.records.append(rec)
        out = self.sink or sys.stderr
        print(json.dumps({"dpq_metric": rec}), file=out, flush=True)
        return rec

    @contextmanager
    def timed(self, stage: str, **kv):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            box.setdefault("seconds", time.perf_counter() - t0)
            self.emit(stage, **{**kv, **box})

    def summary(self) -> dict:
        out: dict = {}
        for r in self.records:
            out.setdefault(r["stage"], []).append(r)
        return out


def throughput(rows: int, nbytes: int, seconds: float) -> dict:
    return {
        "rows": rows,
        "bytes": nbytes,
        "seconds": seconds,
        "rows_per_s": rows / seconds if seconds else None,
        "gb_per_s": nbytes / seconds / 1e9 if seconds else None,
    }


def skew_factor(per_device_load) -> float:
    """max/mean load across devices (1.0 = perfectly balanced)."""
    import numpy as np

    load = np.asarray(per_device_load, dtype=float)
    mean = load.mean() if load.size else 0.0
    return float(load.max() / mean) if mean else 1.0


_global = Metrics()


def get_metrics() -> Metrics:
    return _global
