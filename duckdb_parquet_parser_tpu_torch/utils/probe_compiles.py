"""Probe of the host pattern compile on the query routes, on one GPU.

For the package under `--root` (default: the checkout this file is in),
over the resident 2M-row `l_comment` column: the ms of one
`ops/regex.compile_pattern` of each pattern alone and of its register-machine
trace (`ops/strings.pattern_ir`, None for a table DFA); the warm resident query
(`ResidentColumn.scan`) of each; and `scan_streaming` on fresh engines, a
first call and repeated ones; each call on the host clock ending in a
synchronise, with the `compile_pattern` calls it made.  The patterns are
the benchmark's register machine `special.*requests` (kernel K1) and the
44-state table DFA `(furiously|carefully) (express|regular)+
(deposits|requests)` (kernel K3).  Every answer is held against the native
exact host scan.  Run it once a tree, in turns, to hold two trees against
each other on one card in one run (each tree builds its own kernels
under its own `build/`).  `counted_compiles` is shared with
`chip_smoke.py`.

Usage: CXX=g++ python3 duckdb_parquet_parser_tpu_torch/utils/probe_compiles.py
           [--root DIR] [--fixtures DIR] [--reps N]
(needs one CUDA device; prints the card, then one JSON line.)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

PATTERNS = {"register_machine": "special.*requests",
            "table_dfa": "(furiously|carefully) (express|regular)+ "
                         "(deposits|requests)"}
ROWS = 2_000_000
PACKAGE = "duckdb_parquet_parser_tpu_torch"


@contextlib.contextmanager
def counted_compiles():
    """Yields the list of patterns that `ops/regex.compile_pattern`
    compiles while the block runs: the name is rebound in every module of
    the port that bound it, and restored after."""
    from duckdb_parquet_parser_tpu_torch.ops import regex

    original = regex.compile_pattern
    calls = []

    def counting(*args, **kwargs):
        calls.append(args[0])
        return original(*args, **kwargs)

    bound = [m for name, m in list(sys.modules.items())
             if name.startswith(PACKAGE)
             and getattr(m, "compile_pattern", None) is original]
    for m in bound:
        m.compile_pattern = counting
    try:
        yield calls
    finally:
        for m in bound:
            m.compile_pattern = original


def _call(fn) -> tuple[float, int, object]:
    """(ms on the host clock, compiles, result) of one call of `fn`."""
    import torch

    torch.cuda.synchronize()
    with counted_compiles() as calls:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return ms, len(calls), out


def _summary(ms, compiles=None) -> dict:
    """{min, median, max} of the calls' ms, and each call's compiles."""
    out = {"min_ms": round(min(ms), 3),
           "median_ms": round(statistics.median(ms), 3),
           "max_ms": round(max(ms), 3)}
    if compiles is not None:
        out["compiles"] = compiles
    return out


def _calls(runs) -> dict:
    return _summary([r[0] for r in runs], [r[1] for r in runs])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--fixtures", default=None)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_compiles: no CUDA device", file=sys.stderr)
        return 2
    from duckdb_parquet_parser_tpu_torch import bench
    from duckdb_parquet_parser_tpu_torch.models import scan as models
    from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
    from duckdb_parquet_parser_tpu_torch.ops.regex import compile_pattern
    from duckdb_parquet_parser_tpu_torch.ops.strings import pattern_ir
    from duckdb_parquet_parser_tpu_torch.utils import fixtures

    card = bench.card_line()
    print(f"card: {card}; tree {root}", flush=True)
    bench.build_host_library()
    bench.build_kernels([(PATTERNS["register_machine"],)])
    fdir = Path(args.fixtures) if args.fixtures else root / "build" / "fixtures"
    path = str(fixtures.lineitem(fdir / f"lineitem_{ROWS}.parquet", ROWS))
    eng = ScanEngine(path)
    col = eng.resident("l_comment", device="cuda")
    out: dict = {"root": str(root), "card": card, "rows": ROWS}
    for label, pat in PATTERNS.items():
        exact = eng.cold_scan("l_comment", pat, exact_counts=True,
                              stats_prune=False)

        def held(res, what):
            if not (np.array_equal(res.page_gid, exact.page_gid)
                    and np.array_equal(res.match_counts, exact.match_counts)):
                raise AssertionError(f"{what} of {pat!r} differs from the "
                                     "native exact scan")

        alone = {}
        for name, fn in (("compile_pattern", compile_pattern),
                         ("pattern_ir", pattern_ir)):
            alone[name] = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                fn(pat)
                alone[name].append((time.perf_counter() - t0) * 1e3)
        held(col.scan(pat), "the resident query")  # warm-up
        query = [_call(lambda: col.scan(pat)) for _ in range(args.reps)]
        held(query[-1][2], "the resident query")
        cache = getattr(models, "_streaming_matchers", None)
        if cache is not None:
            cache.cache_clear()
        stream = [_call(lambda: ScanEngine(path).scan_streaming(
            "l_comment", pat, device="cuda")) for _ in range(args.reps + 1)]
        for _ms, _n, res in stream:
            held(res, "scan_streaming")
        out[label] = {
            "pattern": pat,
            **{name: _summary(ms) for name, ms in alone.items()},
            "resident_query": _calls(query),
            "scan_streaming_first": _calls(stream[:1]),
            "scan_streaming_repeated": _calls(stream[1:]),
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
