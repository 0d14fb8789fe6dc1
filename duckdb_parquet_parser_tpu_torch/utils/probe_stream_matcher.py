"""Probe of the stream matcher's launch shape on one GPU.

Times kernel K1 (`ops/kernels/stream_matcher.py`) on the larger bucket of
the resident 2M-row `l_comment` column with 32, 64, 128 and 256 lanes per
block, in alternating rounds on one card, and prints the least time of
each.  The block size the wrapper ships (`stream_matcher.THREADS`) was
chosen from this probe's numbers (PERF.md).

Usage: CXX=g++ python3 -m duckdb_parquet_parser_tpu_torch.utils.probe_stream_matcher
(needs one CUDA device; writes its fixture under build/fixtures/).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from ..models.scan import ScanEngine
from ..ops import strings
from ..ops.kernels import stream_matcher
from . import fixtures

ROOT = Path(__file__).resolve().parents[2]
ROWS = 2_000_000
PATTERNS = ["special.*requests", "[a-z ]{30,45}requests"]
BLOCKS = (32, 64, 128, 256)


def _ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_stream_matcher: no CUDA device", file=sys.stderr)
        return 2
    path = fixtures.lineitem(
        ROOT / "build" / "fixtures" / f"lineitem_{ROWS}.parquet", ROWS)
    col = ScanEngine(str(path)).resident("l_comment", device="cuda")
    bk = max(col._buckets, key=lambda b: b["stream"].numel())
    print(f"card: {torch.cuda.get_device_name(0)}; stream "
          f"{tuple(bk['stream'].shape)} u8", flush=True)
    shipped = stream_matcher.THREADS
    for pat in PATTERNS:
        irs = (strings.pattern_ir(pat),)
        best = {t: float("inf") for t in BLOCKS}
        for _ in range(3):
            for t in BLOCKS:
                stream_matcher.THREADS = t
                best[t] = min(best[t], _ms(lambda: stream_matcher.match_stream(
                    bk["stream"], bk["walk_plen"], bk["walk_nn"], irs,
                    bk["steps"])))
        stream_matcher.THREADS = shipped
        print(f"K1 {pat!r}: " + ", ".join(
            f"{t} lanes/block {ms:.4f} ms" for t, ms in best.items())
            + f" (least of 3 rounds of 20; shipped: {shipped})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
