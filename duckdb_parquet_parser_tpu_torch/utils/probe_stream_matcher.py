"""Probe of kernel K1, the stream matcher, on one GPU.

Times `stream_matcher.match_stream` of the package under `--root` (default:
the checkout this file is in) on three layouts, on the card alone (the calls
queued behind a few ms of other work, so the host's launch cost hides) and a
call (CUDA events around back-to-back calls), the least of `--rounds`
rounds, every result held against the plain walk first:

* `lineitem bucket`: the larger PLAIN bucket of the resident 2M-row
  `l_comment` column (`[66, 53142, 16]` u8, `chip_smoke.py`'s K1 shape);
* `orders split`: with `--orders FILE`, the resident `o_comment` column of
  that Parquet file (the benchmark's TPC-H orders table: 8 KB pages, held as
  value-boundary segments of the split layout);
* `short values`: 53,142 lanes of 89 values each 0-15 bytes long, from a
  seeded generator (several value boundaries in most chunks).

Patterns: Q13's `%special%packages%` as the resident scan compiles it, and
`special.*requests`.  For each pattern tuple, where the toolkit has a
disassembler: registers, spill bytes and the machine instructions of the
loop that holds the chunk's load (and of the innermost loop); and the
seconds of one `nvcc` run of the tuple alone, built into a fresh directory.
Run it once a tree, in turns (parent, change, change, parent), to hold two
trees against each other on one card: each tree builds its own kernels
under its own `build/`.  `--blocks` times the lineitem bucket at 32-256
lanes per block instead (how `stream_matcher.THREADS` was chosen).

Usage: CXX=g++ python3 duckdb_parquet_parser_tpu_torch/utils/probe_stream_matcher.py
           [--root DIR] [--fixtures DIR] [--orders FILE] [--rounds N] [--blocks]
(needs one CUDA device; prints the card, then one JSON line.)
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROWS = 2_000_000
PATTERNS = {"q13": ("%special%packages%", True),
            "special.*requests": ("special.*requests", False)}
BLOCKS = (32, 64, 128, 256)
SHORT_LANES, SHORT_VALUES, SHORT_MAX = 53_142, 89, 15


def _ms(fn, reps: int, queued: bool) -> float:
    """ms per call of `fn` over `reps` calls between two CUDA events;
    `queued`: behind three 8192-wide half-precision products, so only the
    device's time is read."""
    import torch

    fn()
    torch.cuda.synchronize()
    if queued:
        a = torch.ones(8192, 8192, device="cuda", dtype=torch.float16)
        b = torch.empty_like(a)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queued:
        for _ in range(3):
            torch.mm(a, a, out=b)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def short_values(seed: int = 20, n: int = SHORT_LANES, device="cuda"):
    """(stream [chunks, n, 16] u8 on `device`, plen, nn, steps): n lanes of
    SHORT_VALUES values each 0-SHORT_MAX bytes long, letters and spaces,
    zero past each lane's end."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher

    rng = np.random.default_rng(seed)
    v = SHORT_VALUES
    lens = rng.integers(0, SHORT_MAX + 1, size=(n, v))
    ends = np.cumsum(lens + 4, axis=1)
    starts = ends - lens - 4
    plen = ends[:, -1]
    pitch = -(-int(plen.max()) // 16) * 16
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    pm = letters[rng.integers(0, len(letters), size=(n, pitch))]
    pm[np.arange(pitch)[None, :] >= plen[:, None]] = 0
    rows = np.repeat(np.arange(n), v)
    for b in range(4):
        pm[rows, (starts + b).ravel()] = ((lens >> (8 * b)) & 0xFF).ravel()
    pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(device)
    return (stream_matcher.chunk_stream(pt),
            torch.from_numpy(plen.astype(np.int32)).to(device),
            torch.full((n,), v, dtype=torch.int32, device=device), pitch)


def layouts(fixtures_dir: Path, orders: str | None) -> dict:
    """{label: (stream, plen, nn, steps)} of the three layouts."""
    from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
    from duckdb_parquet_parser_tpu_torch.utils import fixtures

    path = fixtures.lineitem(fixtures_dir / f"lineitem_{ROWS}.parquet", ROWS)
    col = ScanEngine(str(path)).resident("l_comment", device="cuda")
    bk = max(col._buckets, key=lambda b: b["stream"].numel())
    out = {"lineitem bucket": (bk["stream"], bk["walk_plen"], bk["walk_nn"],
                               bk["steps"])}
    if orders:
        ocol = ScanEngine(orders).resident("o_comment", device="cuda")
        (ob,) = [b for b in ocol._buckets if b["has_plain"]]
        out["orders split"] = (ob["stream"], ob["walk_plen"], ob["walk_nn"],
                               ob["steps"])
    out["short values"] = short_values()
    return out


def pattern_irs() -> dict:
    """{label: IR tuple} of PATTERNS, as the resident scan resolves them."""
    from duckdb_parquet_parser_tpu_torch.ops import scan

    out = {}
    for label, (pat, like) in PATTERNS.items():
        pats, dfas = scan.prepare_patterns([pat], like=like)
        irs, _dfa = scan.resolve_matchers(pats, dfas)
        out[label] = tuple(irs)
    return out


def compiled(irs) -> dict:
    """Registers, spills and loop instructions of the tuple's kernel, and
    the seconds of one `nvcc` run of it alone into a fresh directory."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import build, stream_matcher

    text = stream_matcher.render([irs])
    kept = build.BUILD_DIR
    with tempfile.TemporaryDirectory() as d:
        build.BUILD_DIR = Path(d)
        try:
            t0 = time.perf_counter()
            build.build_sources([text])
            out = {"nvcc_s": time.perf_counter() - t0}
        finally:
            build.BUILD_DIR = kept
    if build.disassembler() is None:
        return out
    tag = stream_matcher.tag_of(irs)
    for key, containing in (("chunk_loop", "LDG"), ("innermost_loop", None)):
        (info,) = [v for k, v in build.inspect_source(
            text, loop_containing=containing).items()
            if f"dpq_stream_{tag}" in k]
        loop = info["loop_instructions"]
        out.update(registers=info["registers"],
                   spill_bytes=info["spill_bytes"])
        out[key] = {"instructions": sum(loop.values()),
                    "int32": sum(n for op, n in loop.items()
                                 if op not in ("IMAD", "FFMA", "FMUL", "FADD",
                                               "BRA", "BSSY", "BSYNC",
                                               "NOP")),
                    "opcodes": loop}
    return out


def time_blocks(stream, plen, nn, steps, irs_by_label, rounds) -> dict:
    """{label: {threads: least ms per call}} over BLOCKS lanes a block."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher

    shipped = stream_matcher.THREADS
    out = {}
    try:
        for label, irs in irs_by_label.items():
            best = dict.fromkeys(BLOCKS, float("inf"))
            for _ in range(rounds):
                for t in BLOCKS:
                    stream_matcher.THREADS = t
                    best[t] = min(best[t], _ms(
                        lambda: stream_matcher.match_stream(
                            stream, plen, nn, irs, steps), 20, False))
            out[label] = best
    finally:
        stream_matcher.THREADS = shipped
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--fixtures", default=None)
    ap.add_argument("--orders", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--blocks", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("probe_stream_matcher: no CUDA device", file=sys.stderr)
        return 2
    from duckdb_parquet_parser_tpu_torch.bench import card_line
    from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher

    card = card_line()
    print(f"card: {card}; tree {root}", flush=True)
    irs_by_label = pattern_irs()
    stream_matcher.prepare(list(irs_by_label.values()))
    fdir = Path(args.fixtures) if args.fixtures else root / "build" / "fixtures"
    lay = layouts(fdir, args.orders)
    out: dict = {"root": str(root), "card": card, "threads":
                 stream_matcher.THREADS}
    if args.blocks:
        out["blocks"] = time_blocks(*lay["lineitem bucket"], irs_by_label,
                                    args.rounds)
        print(json.dumps(out), flush=True)
        return 0
    out["compiled"] = {label: compiled(irs)
                       for label, irs in irs_by_label.items()}
    for name, (stream, pl, nv, steps) in lay.items():
        plain = stream_matcher.unchunk_stream(stream, steps)
        entry: dict = {"shape": list(stream.shape), "walked_bytes": int(
            torch.where(nv > 0, pl.clamp(max=steps), 0).sum())}
        for label, irs in irs_by_label.items():
            def fn(irs=irs):
                return stream_matcher.match_stream(stream, pl, nv, irs, steps)
            h1, s1 = fn()
            h0, s0 = stream_matcher.match_stream_plain(plain, pl, nv, irs,
                                                       steps)
            if not (torch.equal(h1, h0) and torch.equal(s1, s0)):
                raise AssertionError(f"K1 differs from the plain walk on "
                                     f"{name}, {label}")
            best = {"values": int(s1.sum()), "hits": int(h1.sum())}
            for _ in range(args.rounds):
                for queued in (True, False):
                    key = "device_ms" if queued else "ms"
                    best[key] = min(best.get(key, float("inf")),
                                    _ms(fn, 20, queued))
            entry[label] = best
        del plain
        out[name] = entry
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
