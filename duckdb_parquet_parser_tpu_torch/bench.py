"""Benchmark program of the port: the counterpart of the reference's
`bench.py`, with the same routes, keys and last line.

Workload: a TPC-H-lineitem-like file (`utils/fixtures.lineitem`, byte for
byte the reference's); the headline is the sustained regex page-pruning
scan of its `l_comment` column resident on the device, in rows/s, against
the reference binary's single-CPU decode rows/s over the same file.  Beside
it the four pattern families, three fused patterns, big-page files (the
value-boundary split layout), the cold one-shot scans, stats-pruned and
dictionary-skipping host scans, `read_column`, the chunked index build,
fixed-width, dictionary and delta decodes on the device, a dictionary
string scan, and the scaling table of the sharded scan step.

How it measures:

  * every kernel is built before anything is timed: the native host
    library, one `nvcc` run for all the stream matcher's pattern tuples and
    one for the dictionary kernels, started together;
  * every route's answer is held once against an exact host answer before
    it is timed, and a mismatch raises (`BenchMismatch`): page counts
    against the native host scan (`cold_scan(..., exact_counts=True)`),
    decoded columns against `read_column` (the native column sweep), the
    index against the vectorized host build, and the routes over fixtures
    that are not files against the values they were made from;
  * a device route is timed with CUDA events around one call, after a
    warm-up call, its results staying on the device: the least of `reps`
    calls in each of ROUNDS rounds (a launch's host cost switches between
    two levels within seconds: `utils/probe_launch_cost.py`), the headline
    the least of the rounds, the band over the rounds;
  * host routes stay on the host clock, as in the reference;
  * the launches of one call of each device route are read from the kernel
    wrappers' counters (`launches` in the detail), and on the card a route
    that did not launch its kernel fails the run.

The reference's keys map to these routes: `scan_pallas_stream` is the
stream matcher (K1) over the whole column as one resident stream (one
launch), `scan_bucketed` the scan step over the resident column's length
buckets (`ops/scan.device_scan_step`, one launch a bucket), `scan_rows_per_s`
the better of the two; the families, the fused three patterns and the big
pages take the bucketed step; `scan_dict_strings` is the dictionary kernel's
fused count (K2's `dict_count`) over the resident level and index planes;
`decode_dict` launches K2's gather once a decode.  The relay and compiler
workarounds of the reference (marginal repetitions with perturbed inputs,
the compile cache) have no counterpart.  `LEFT_OUT` lists the reference's
keys this program does not produce, with the reason.

Prints the detail to stderr (a `{"detail": {...}}` line, then the card's
name and power limit as nvidia-smi gives them) and one JSON line last on
stdout: {"metric": "decode_regex_scan_rows_per_s", "value": N, "unit":
"rows/s", "vs_baseline": N or null}.  `vs_baseline` needs the reference
sources that `tests/oracle/build_oracle.py` names; the reference binary is
then compiled under the fixture directory.  Without them it is null.

Fixtures are cached under `build/bench/` of the checkout, or under
`DPQ_BENCH_DIR` when set.  `--device` defaults to `cuda` and the run raises
without a card; `--device cpu` runs every route with the kernels' plain
versions (a test of the program, not a measurement of a device).

Usage: python -m duckdb_parquet_parser_tpu_torch.bench [--rows N]
       [--reps R] [--quick] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .host import bindings
from .host import build as host_build
from .host.batch import to_tensor
from .host.reader import ParquetReader, _flatten_decoded
from .models.scan import ResidentColumn, ScanEngine
from .ops import decode as _decode
from .ops import delta as _delta
from .ops import scan as _scan
from .ops import strings
from .ops.index import build_index_for_column
from .ops.kernels import build, dfa_walk, dict_lookup, stream_matcher
from .ops.regex import compile_pattern
from .utils import fixtures

ROOT = Path(__file__).resolve().parents[1]

PATTERN = "special.*requests"  # TPC-H Q13-style filter
PATTERN_GENERAL = "spe[cs]ial.*requ[ea]sts"
PATTERN_ALT = "carefully|quickly|special"
PATTERN_WIDE = "[a-z ]{30,45}requests"
PATTERN_INTERIOR = "carefully[a-z ]{32,}requests"
FAMILIES = ((PATTERN_GENERAL, "scan_general"),
            (PATTERN_ALT, "scan_alternation"),
            (PATTERN_WIDE, "scan_wide"),
            (PATTERN_INTERIOR, "scan_interior_run"))
MULTI = (PATTERN, PATTERN_GENERAL, PATTERN_ALT)
# the stream matcher's pattern tuples, built in one nvcc run up front
PATTERN_TUPLES = [(PATTERN,)] + [(p,) for p, _ in FAMILIES] + [MULTI]
DICT_PATTERN = "^san.*o-[02]$"
PRUNE_PATTERN = "^user_0009"
SELECTIVE_PATTERN = "zurich"  # matches no city

ROUNDS = 6
SCALING_RANKS = (1, 2, 4, 8)
SCALING_ROWS = 60_000
CHILD_TIMEOUT_S = 900
# the reference's pauses before each host run: the cold scans, pruning,
# index and dictionary-skip runs, and the interleaved read_column runs
HOST_PAUSE_S = 0.05
READ_COLUMN_PAUSE_S = 0.08

# keys of the reference's detail that this program does not produce
LEFT_OUT = {
    "read_column_delta_i64_rows_per_s": (
        "needs a DELTA_BINARY_PACKED file; only pyarrow writes one, and the "
        "GPU machine has no pyarrow (the delta decode route runs over the "
        "same values packed in memory: decode_delta_i64_rows_per_s)"),
    "read_column_delta_i64": "the band of the key above",
}


class BenchMismatch(RuntimeError):
    """A route's answer differs from the exact host answer."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_dir() -> Path:
    return Path(os.environ.get("DPQ_BENCH_DIR", ROOT / "build" / "bench"))


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def band(times: list, total: float) -> dict:
    """The reference's band contract over per-run times of identical work,
    in rows/s: `min` the slowest run's rate, `med` the median run's,
    `spread` slowest over fastest, `n` runs."""
    ts = sorted(times)
    return {"min": round(total / ts[-1], 1),
            "med": round(total / ts[len(ts) // 2], 1),
            "spread": round(ts[-1] / ts[0], 3), "n": len(ts)}


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter."""
    return {"stream_matcher": stream_matcher.launches,
            "dict_lookup": dict_lookup.launches,
            "dfa_walk": dfa_walk.launches}


def launches_of(fn) -> tuple[object, dict]:
    """(result, {kernel: launches}) of one call of `fn`, read from the
    wrappers' counters."""
    before = launch_counts()
    res = fn()
    return res, {k: v - before[k] for k, v in launch_counts().items()}


class Bench:
    """One run's device, repetitions and results: `out` holds the detail
    keys, `bands` their bands, `launches` the kernel launches of one call
    of each device route."""

    def __init__(self, device, reps: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.reps, self.rounds = max(int(reps), 1), ROUNDS
        self.out: dict = {}
        self.bands: dict = {}
        self.launches: dict = {}

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def round_ms(self, fn) -> list[float]:
        """The least ms of `reps` calls of `fn` in each round, after a
        warm-up call: CUDA events around one call on the card, the host
        clock on the CPU (where the plain versions run synchronously)."""
        fn()
        self.sync()
        mins = []
        for _ in range(self.rounds):
            best = float("inf")
            for _ in range(self.reps):
                if self.cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    end.synchronize()
                    ms = start.elapsed_time(end)
                else:
                    t0 = time.perf_counter()
                    fn()
                    ms = (time.perf_counter() - t0) * 1e3
                best = min(best, ms)
            mins.append(best)
        return mins

    def device_rate(self, key: str, band_key: str, total: float, fn) -> float:
        """Times device route `fn` into `out[key]` (rows/s over `total`)
        and its band; returns the least ms a call."""
        mins = self.round_ms(fn)
        self.out[key] = total / (min(mins) / 1e3)
        self.bands[band_key] = band([m / 1e3 for m in mins], total)
        return min(mins)

    def host_rate(self, key: str, band_key: str, total: float,
                  times: list) -> None:
        self.out[key] = total / min(times)
        self.bands[band_key] = band(times, total)

    def count(self, route: str, fn):
        """Runs `fn` once, noting the kernel launches it made under
        `route`; returns its result."""
        res, self.launches[route] = launches_of(fn)
        self.sync()
        return res

    def require_launches(self) -> None:
        """On the card: the scans of PLAIN pages launched the stream matcher
        and not the dictionary kernel, the dictionary routes the dictionary
        kernel, and no route the table-DFA walk."""
        if not self.cuda:
            return
        for r, n in self.launches.items():
            walks = r.startswith("scan_") and r != "scan_dict_strings"
            dicts = r in ("decode_dict", "scan_dict_strings")
            if (walks and (n["stream_matcher"] < 1 or n["dict_lookup"])
                    or dicts and n["dict_lookup"] < 1 or n["dfa_walk"]):
                raise BenchMismatch(f"route {r} launched {n}")


def timed_host(fn, n: int) -> tuple[list, object]:
    """Per-run wall seconds of `n` runs of `fn` (HOST_PAUSE_S before
    each), and the last result."""
    times, res = [], None
    for _ in range(n):
        time.sleep(HOST_PAUSE_S)
        t0 = time.perf_counter()
        res = fn()
        times.append(time.perf_counter() - t0)
    return times, res


# ── exact answers ──────────────────────────────────────────────────────────


def hold_counts(label: str, gid, counts, ref, values=None) -> None:
    """Per-page match counts (and participating values) of a route, in
    page-id order, against a `PageMatchResult` of the exact host scan."""
    order, ref_order = np.argsort(gid), np.argsort(ref.page_gid)
    same = (np.array_equal(np.asarray(gid)[order], ref.page_gid[ref_order])
            and np.array_equal(np.asarray(counts)[order],
                               ref.match_counts[ref_order]))
    if same and values is not None:
        same = np.array_equal(np.asarray(values)[order],
                              ref.value_counts[ref_order])
    if not same:
        raise BenchMismatch(f"{label}: the page counts differ from the "
                            "exact host scan")


def hold_column(label: str, values, valid, ref) -> None:
    """A decoded column against `read_column`'s, compared as integers."""
    a, b = np.asarray(values), np.asarray(ref.values)
    view = {1: np.uint8, 4: np.int32, 8: np.int64}[b.dtype.itemsize]
    if not (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(np.asarray(valid), np.asarray(ref.valid))
            and np.array_equal(a.view(view), b.view(view))):
        raise BenchMismatch(f"{label}: the decoded column differs from "
                            "read_column")


def exact_scan(path: Path, column: str, pattern: str):
    return ScanEngine(str(path)).cold_scan(column, pattern,
                                           exact_counts=True,
                                           stats_prune=False)


def payload_values(batch) -> list[list[bytes]]:
    """The values of each page of a PS_PAYLOAD batch of PLAIN BYTE_ARRAY
    pages, read off their length prefixes."""
    out = []
    for row, plen in zip(batch.arrays["payload"],
                         batch.arrays["page_payload_len"]):
        buf, at, vals = row[:int(plen)].tobytes(), 0, []
        while at < len(buf):
            n = int.from_bytes(buf[at:at + 4], "little")
            vals.append(buf[at + 4:at + 4 + n])
            at += 4 + n
        out.append(vals)
    return out


# ── the device scan routes ─────────────────────────────────────────────────


def bucket_step(batch, buckets, patterns, device):
    """(step, answer) of the scan step over resident buckets for K fused
    patterns: `step()` launches the walk (and the dictionary kernel where a
    bucket holds dictionary pages) and leaves its results on the device;
    `answer(results)` gives the [K, N] counts and [N] values on the host,
    in the batch's page order."""
    # every pattern of the benchmark is a register machine (K1's tuples,
    # `build_kernels`): the walk needs no table DFA
    irs = tuple(strings.pattern_ir(p) for p in patterns)
    k = len(patterns)
    if int(batch.dims.get("dict_n", 0)) > 0:
        dfas = [compile_pattern(p) for p in patterns]
        table = _scan.accept_table(_scan.dict_accepts(batch, dfas), device)
    else:
        table = _scan.accept_table(np.zeros((k, 1), bool), device)

    def step():
        return [_scan.device_scan_step(
            bk["core"], bk["stream"], bk["walk_plen"], bk["walk_nn"], table,
            irs=irs, dfa=None, vmax=batch.vmax, nn_cap=batch.nn_cap,
            max_def=batch.max_def, negate=False, steps=bk["steps"],
            has_plain=bk["has_plain"], has_dict=bk["has_dict"],
            seg=bk["seg"]) for bk in buckets]

    def answer(results):
        counts = np.zeros((k, batch.n_pages), np.int64)
        values = np.zeros(batch.n_pages, np.int64)
        for bk, (c, v) in zip(buckets, results):
            counts[:, bk["idx"]] = c.cpu().numpy()
            values[bk["idx"]] = v.cpu().numpy()
        return counts, values

    return step, answer


def scan_routes(b: Bench, path: Path) -> dict:
    """Routes 1-3: the resident `l_comment` scans.  Returns what the cold
    routes read: the batch, its rows and the headline route's ms."""
    dev = b.device
    reader = ParquetReader(str(path))
    batch = reader.prescan("l_comment", pad_strings=8,
                           flags=bindings.PS_PAYLOAD)
    total = batch.total_rows
    arrays = batch.arrays
    refs = {pat: exact_scan(path, "l_comment", pat)
            for pat in dict.fromkeys([*MULTI, *(p for p, _ in FAMILIES)])}
    ref = refs[PATTERN]
    b.out["rows"] = total

    # the first query of a resident column, on the host clock
    col = ResidentColumn(reader, "l_comment", device=dev, batch=batch)
    b.sync()
    t0 = time.perf_counter()
    first = col.scan(PATTERN)
    t_first = time.perf_counter() - t0
    hold_counts("ResidentColumn.scan", first.page_gid, first.match_counts,
                ref, first.value_counts)
    b.out["scan_single_call_rows_per_s"] = total / t_first
    del col

    # K1 over the whole column as one resident stream: one launch
    is_dict = np.asarray(arrays["page_kind"]) == 1
    plen = np.asarray(arrays["page_payload_len"])
    steps = min(_scan.scan_steps(plen), arrays["payload"].shape[1])
    stream = _scan.resident_stream(arrays["payload"], steps, dev)
    wplen = to_tensor(np.where(is_dict, 0, plen), dev, dtype=np.int32)
    wnn = to_tensor(np.where(is_dict, 0, arrays["page_nn"]), dev,
                    dtype=np.int32)
    irs = (strings.pattern_ir(PATTERN),)

    def whole():
        return _scan.walk_hits(stream, wplen, wnn, irs, None, steps)

    hits = b.count("scan_pallas_stream", whole)
    hold_counts("the whole-stream walk", arrays["page_gid"],
                hits[0].cpu().numpy(), ref)
    ms_stream = b.device_rate("scan_pallas_stream_rows_per_s",
                              "scan_pallas_stream", total, whole)
    del stream

    # the scan step over the resident length buckets
    buckets, _split = _scan.resident_buckets(batch, dev)
    step, answer = bucket_step(batch, buckets, [PATTERN], dev)
    counts, values = answer(b.count("scan_bucketed", step))
    hold_counts("the bucketed step", arrays["page_gid"], counts[0], ref,
                values)
    ms_bucketed = b.device_rate("scan_bucketed_rows_per_s", "scan_bucketed",
                                total, step)
    best = "scan_bucketed" if ms_bucketed < ms_stream else "scan_pallas_stream"
    b.out["scan_rows_per_s"] = b.out[f"{best}_rows_per_s"]
    b.bands["scan_sustained"] = b.bands[best]
    log(f"scan {PATTERN!r}: whole stream {ms_stream:.4f} ms, "
        f"{len(buckets)} buckets {ms_bucketed:.4f} ms a call; "
        f"{total / ms_stream * 1e3:.4g} / {total / ms_bucketed * 1e3:.4g} "
        f"rows/s; first query {t_first * 1e3:.1f} ms")

    # the four pattern families, one pattern a walk
    for pat, key in FAMILIES:
        step, answer = bucket_step(batch, buckets, [pat], dev)
        counts, values = answer(b.count(key, step))
        hold_counts(key, arrays["page_gid"], counts[0], refs[pat], values)
        ms = b.device_rate(f"{key}_rows_per_s", key, total, step)
        log(f"{key} {pat!r}: {ms:.4f} ms a call")

    # three patterns fused into one walk
    step, answer = bucket_step(batch, buckets, MULTI, dev)
    counts, values = answer(b.count("scan_multi3", step))
    for j, pat in enumerate(MULTI):
        hold_counts(f"fused pattern {pat!r}", arrays["page_gid"], counts[j],
                    refs[pat], values)
    ms = b.device_rate("scan_multi3_pattern_rows_per_s", "scan_multi3",
                       3 * total, step)
    log(f"scan fused x3: {ms:.4f} ms a call, "
        f"{3 * total / ms * 1e3:.4g} pattern-rows/s")
    del buckets
    return {"batch": batch, "total": total, "ref": ref,
            "step_ms": min(ms_stream, ms_bucketed)}


def bigpage_route(b: Bench, rows: int) -> None:
    """Route 4: `rows` values in ~1 MiB pages, walked in the split layout
    (value-boundary segments whose counts sum back to pages); the answer
    is held against the host `re` over each page's values."""
    batch = fixtures.bigpage_arrays(rows)
    buckets, split = _scan.resident_buckets(batch, b.device)
    if not split:
        raise BenchMismatch("the big pages were not split")
    step, answer = bucket_step(batch, buckets, [PATTERN], b.device)
    counts, values = answer(b.count("scan_bigpage", step))
    rx = re.compile(PATTERN.encode())
    want = [sum(rx.search(v) is not None for v in page)
            for page in payload_values(batch)]
    if (counts[0].tolist() != want
            or values.tolist() != batch.arrays["page_nn"].tolist()):
        raise BenchMismatch("the big-page split walk differs from the host "
                            "re over the page values")
    ms = b.device_rate("scan_bigpage_rows_per_s", "scan_bigpage",
                       batch.total_rows, step)
    log(f"scan big pages ({batch.n_pages} pages, "
        f"{buckets[0]['walk_plen'].shape[0]} segments x "
        f"{buckets[0]['steps']} steps): {ms:.4f} ms a call")


def cold_routes(b: Bench, path: Path, scan: dict) -> None:
    """Route 5: the cold one-shot scans (a fresh engine a run) and the
    device cold path's decomposition."""
    total, ref = scan["total"], scan["ref"]
    first = ScanEngine(str(path)).cold_scan("l_comment", PATTERN)
    if not np.array_equal(first.match_counts > 0, ref.match_counts > 0):
        raise BenchMismatch("the cold one-shot scan's surviving pages "
                            "differ from the exact scan's")
    t_native, _ = timed_host(
        lambda: ScanEngine(str(path)).cold_scan("l_comment", PATTERN), 5)
    b.host_rate("scan_cold_e2e_rows_per_s", "scan_cold_one_shot", total,
                t_native)

    def streaming():
        return ScanEngine(str(path)).scan_streaming("l_comment", PATTERN,
                                                    device=b.device)

    res = b.count("scan_cold_device", streaming)
    hold_counts("scan_streaming", res.page_gid, res.match_counts, ref,
                res.value_counts)
    t_device, _ = timed_host(streaming, 3)
    b.out["scan_cold_device_rows_per_s"] = total / min(t_device)

    eng = ScanEngine(str(path))
    t0 = time.perf_counter()
    cold_b = eng.reader.prescan("l_comment", pad_strings=8,
                                flags=bindings.PS_PAYLOAD)
    t_pre = time.perf_counter() - t0
    host = torch.from_numpy(np.array(cold_b.arrays["payload"]))
    b.sync()
    t0 = time.perf_counter()
    up = host.to(b.device)
    b.sync()
    t_up = time.perf_counter() - t0
    del up
    t0 = time.perf_counter()
    torch.zeros(8, dtype=torch.uint8).to(b.device).cpu()
    t_rt = time.perf_counter() - t0
    mb = host.numel() / 1e6
    marg = scan["step_ms"] / 1e3
    b.out["scan_cold_device_decomp"] = {
        "prescan_ms": round(t_pre * 1e3, 1),
        "upload_ms": round(t_up * 1e3, 1),
        "payload_mb": round(mb, 1),
        "upload_mb_per_s": round(mb / max(t_up, 1e-9), 1),
        "tiny_roundtrip_ms": round(t_rt * 1e3, 3),
        "scan_marginal_ms": round(marg * 1e3, 4),
        "ex_transfer_rows_per_s": round(total / max(t_pre + marg, 1e-9), 1),
    }
    b.out["pruned_pages"] = int(len(ref.pruned_pages()))
    b.out["n_pages"] = scan["batch"].n_pages
    log(f"cold one-shot: native {min(t_native) * 1e3:.1f} ms, "
        f"scan_streaming {min(t_device) * 1e3:.1f} ms; "
        f"decomposition {b.out['scan_cold_device_decomp']}")


# ── host routes ────────────────────────────────────────────────────────────


def stats_prune_route(b: Bench, cache: Path, rows: int) -> None:
    """Route 6: the anchored scan of key-ordered strings, with and without
    ColumnIndex pruning."""
    spath = fixtures.sorted_keys(cache / f"sortedkeys_{rows}.parquet", rows)

    def scan(prune):
        return ScanEngine(str(spath)).cold_scan(
            "s_key", PRUNE_PATTERN, exact_counts=True, stats_prune=prune)

    pruned, unpruned = scan(True), scan(False)
    hold_counts("the stats-pruned scan", pruned.page_gid,
                pruned.match_counts, unpruned, pruned.value_counts)
    t_np, _ = timed_host(lambda: scan(False), 3)
    t_pr, rp = timed_host(lambda: scan(True), 5)
    total = ParquetReader(str(spath)).num_rows()
    b.host_rate("scan_stats_prune_rows_per_s", "scan_stats_prune", total,
                t_pr)
    b.out["scan_stats_prune_decomp"] = {
        "pages_skipped": int(rp.stats_pruned_pages),
        "n_pages": int(len(rp.page_gid)),
        "unpruned_ms": round(min(t_np) * 1e3, 1),
        "pruned_ms": round(min(t_pr) * 1e3, 1),
        "speedup": round(min(t_np) / max(min(t_pr), 1e-9), 2),
    }
    log(f"stats-pruned scan: {b.out['scan_stats_prune_decomp']}")


def read_column_route(b: Bench, path: Path) -> dict:
    """Route 7: `read_column` of three columns in six interleaved rounds.
    Returns the columns, the exact answers of the decode routes."""
    reader = ParquetReader(str(path))
    cols = (("l_quantity", "read_column_i64"),
            ("l_tax", "read_column_f64opt"),
            ("l_comment", "read_column_strings"))
    times = {key: [] for _, key in cols}
    got = {}
    for _ in range(6):
        for col, key in cols:
            time.sleep(READ_COLUMN_PAUSE_S)
            t0 = time.perf_counter()
            got[col] = reader.read_column(col)
            times[key].append(time.perf_counter() - t0)
    for col, key in cols:
        if len(got[col]) != reader.num_rows():
            raise BenchMismatch(f"read_column {col}: {len(got[col])} rows")
        b.host_rate(f"{key}_rows_per_s", key, len(got[col]), times[key])
        log(f"read_column {col}: {min(times[key]) * 1e3:.1f} ms")
    return got


def index_route(b: Bench, path: Path) -> None:
    """Route 8: the chunked inverted index of `l_comment`, native build,
    held against the vectorized host build."""
    reader = ParquetReader(str(path))
    want = build_index_for_column(reader, "l_comment", engine="numpy")
    got = build_index_for_column(reader, "l_comment")
    if not (got.num_chunks == want.num_chunks
            and np.array_equal(got.tuple_to_chunk, want.tuple_to_chunk)):
        raise BenchMismatch("the native index build differs from the "
                            "vectorized host build")
    times, cidx = timed_host(
        lambda: build_index_for_column(reader, "l_comment"), 9)
    b.host_rate("index_build_rows_per_s", "index_build", cidx.num_rows,
                times)
    b.out["index_chunks"] = cidx.num_chunks
    log(f"index build: {min(times) * 1e3:.1f} ms, {cidx.num_chunks} chunks")


def dict_selective_route(b: Bench, cpath: Path) -> None:
    """Route 13: a dictionary pattern that matches no entry, with the
    native all-miss short-circuit and without it (DPQ_NO_DICT_SKIP=1)."""
    def scan():
        return ScanEngine(str(cpath)).cold_scan("city", SELECTIVE_PATTERN)

    os.environ["DPQ_NO_DICT_SKIP"] = "1"
    try:
        walked = scan()
        t_walk, _ = timed_host(scan, 5)
    finally:
        os.environ.pop("DPQ_NO_DICT_SKIP", None)
    skipped = scan()
    ref = exact_scan(cpath, "city", SELECTIVE_PATTERN)
    if not (np.array_equal(skipped.match_counts, walked.match_counts)
            and np.array_equal(skipped.match_counts > 0,
                               ref.match_counts > 0)):
        raise BenchMismatch("the dictionary-skipping scan differs from the "
                            "walking one")
    t_skip, res = timed_host(scan, 5)
    total = ParquetReader(str(cpath)).num_rows()
    b.host_rate("scan_dict_selective_rows_per_s", "scan_dict_selective",
                total, t_skip)
    b.out["scan_dict_selective_decomp"] = {
        "pages_skipped": int(res.dict_skipped_pages),
        "n_pages": int(len(res.page_gid)),
        "walk_ms": round(min(t_walk) * 1e3, 1),
        "skip_ms": round(min(t_skip) * 1e3, 1),
        "speedup": round(min(t_walk) / max(min(t_skip), 1e-9), 2),
    }
    log(f"selective dictionary scan: {b.out['scan_dict_selective_decomp']}")


# ── device decodes and the dictionary string scan ──────────────────────────


def decode_route(b: Bench, path: Path, column: str, ref, key: str) -> float:
    """Routes 9 and 10: one column uploaded once, then decoded on the
    device (`decode_fixed_device`); returns ms a decode."""
    batch = ParquetReader(str(path)).prescan(column)
    core, plain, table, bits = _decode.upload_fixed(
        batch.arrays, batch.plain_planes, batch.dict_planes, batch.bool_bits,
        b.device)
    kw = dict(max_def=batch.max_def, out_len=batch.vmax, nn_len=batch.nn_cap,
              mode=batch.mode, device=b.device)

    def decode():
        return _decode.decode_fixed_device(core, plain, table, bits, **kw)

    planes, nonnull = b.count(key, decode)
    col = _flatten_decoded(batch, planes, nonnull)
    hold_column(f"decode {column}", col.values, col.valid, ref)
    return b.device_rate(f"{key}_rows_per_s", key, batch.total_rows, decode)


def dict_scan_route(b: Bench, cpath: Path) -> None:
    """Route 11: the dictionary string scan: the pattern matched against
    the dictionary entries on the host once, then the dictionary kernel's
    fused per-page count over the resident level and index planes."""
    batch = ParquetReader(str(cpath)).prescan("city", pad_strings=8,
                                              flags=bindings.PS_PAYLOAD)
    core = batch.to_device(b.device, _decode.DECODE_ARRAYS)
    table = _scan.accept_table(
        _scan.dict_accepts(batch, [compile_pattern(DICT_PATTERN)]), b.device)

    def count():
        return _scan.dict_counts(core, table, vmax=batch.vmax,
                                 nn_cap=batch.nn_cap, max_def=batch.max_def,
                                 negate=False)

    counts, values = b.count("scan_dict_strings", count)
    hold_counts("the dictionary string scan", batch.arrays["page_gid"],
                counts[0].cpu().numpy(), exact_scan(cpath, "city",
                                                    DICT_PATTERN),
                values.cpu().numpy())
    ms = b.device_rate("scan_dict_strings_rows_per_s", "scan_dict_strings",
                       batch.total_rows, count)
    log(f"scan dict strings ({DICT_PATTERN!r}, DN="
        f"{int(batch.dims.get('dict_n', 0))}): {ms:.4f} ms a call")


def delta_route(b: Bench, rows: int) -> None:
    """Route 12: DELTA_BINARY_PACKED INT64 planes uploaded once, then
    unpacked and prefix-summed on the device; held against the values
    they were packed from."""
    dims, arrays, values, nn = fixtures.delta_column_planes(rows)
    dev = {k: torch.from_numpy(np.ascontiguousarray(a)).to(b.device)
           for k, a in arrays.items()}
    out_len = int(dims["nn_cap"])

    def decode():
        return _delta.decode_delta_planes(dev, dims, out_len, 2)

    lo, hi = (p.cpu().numpy() for p in b.count("decode_delta_i64", decode))
    got = (hi.astype(np.int64) << 32) | (lo.astype(np.int64) & 0xFFFFFFFF)
    keep = np.arange(out_len)[None, :] < nn[:, None]
    if not np.array_equal(got[keep], values[keep]):
        raise BenchMismatch("the delta decode differs from the packed "
                            "values")
    ms = b.device_rate("decode_delta_i64_rows_per_s", "decode_delta_i64",
                       int(nn.sum()), decode)
    log(f"decode delta-i64 ({len(nn)} pages, widths "
        f"{list(_delta.delta_bws(arrays))}): {ms:.4f} ms a decode")


# ── the reference binary and the scaling table ─────────────────────────────


def reference_binary() -> Path | None:
    """The reference binary (the parity oracle's `dump`), compiled from the
    sources `tests/oracle/build_oracle.py` names into the fixture directory
    and keyed by their digest; None without those sources."""
    oracle = ROOT / "tests" / "oracle" / "build_oracle.py"
    if not oracle.exists():
        return None
    spec = importlib.util.spec_from_file_location("build_oracle", oracle)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref, main_src = mod.REF, mod.HERE / "dump_main.cpp"
    if not (ref / "include").is_dir():
        return None
    sources = [ref / s for s in mod._REF_SOURCES]
    h = hashlib.sha256(main_src.read_bytes())
    for src in sources:
        h.update(src.read_bytes())
    exe = bench_dir() / "oracle" / f"dump-{h.hexdigest()[:16]}"
    if not exe.exists():
        exe.parent.mkdir(parents=True, exist_ok=True)
        tmp = exe.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-std=c++17", "-O2", "-I",
                        str(ref / "include"), str(main_src), *map(str, sources),
                        "-o", str(tmp)], check=True, capture_output=True)
        os.replace(tmp, exe)
    return exe


def bench_reference(path: Path, reps: int) -> dict:
    """The reference binary's rates over the same file, as the reference's
    benchmark gets them; {} without the reference sources."""
    exe = reference_binary()
    if exe is None:
        log("reference unavailable; vs_baseline = null")
        return {}

    def run(*args):
        return subprocess.run([str(exe), str(path), *args],
                              capture_output=True, text=True, timeout=3600,
                              check=True).stdout.split()

    out = {}
    vals = run("bench-iter", "l_comment", str(reps))
    n_values = int(vals[1])
    out["ref_iter_rows_per_s"] = n_values / float(vals[5])
    for col, key in (("l_quantity", "ref_column_i64_rows_per_s"),
                     ("l_tax", "ref_column_f64opt_rows_per_s")):
        vals = run("bench-column", col, str(reps))
        out[key] = int(vals[1]) / float(vals[3])
    vals = run("bench-index", "l_comment", str(reps))
    if len(vals) >= 4:
        out["ref_index_rows_per_s"] = n_values / float(vals[3])
    log(f"reference: {out}")
    return out


def bench_scaling(ranks, rows: int) -> dict:
    """The scaling table of the sharded scan step on CPU ranks over gloo:
    one `torchrun` launch of `scaling_bench` a mesh size, in turn.  The
    one-rank row is the one-rank launch's; each larger size's row is read
    against the baseline its own launch measured.  A failed launch raises."""
    table, note = [], None
    for n in ranks:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), "-m",
             "duckdb_parquet_parser_tpu_torch.scaling_bench", "--device",
             "cpu", "--backend", "gloo", "--rows", str(rows)],
            capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
            cwd=str(ROOT))
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('{"metric"')]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"scaling_bench at {n} ranks exited with "
                               f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        res = json.loads(lines[-1])
        table.append(res["table"][-1])
        note = res["note"]
    log(f"scaling: {table}")
    return {"metric": "scan_scaling", "platform": "cpu",
            "note": (f"ranks {list(ranks)}, one torchrun launch each; "
                     f"the last launch's note: {note}"),
            "table": table}


# ── the run ────────────────────────────────────────────────────────────────


def build_host_library() -> Path:
    """The native host library, built with g++ (the setting is inherited
    by child processes started afterwards)."""
    # the library must link the shared libstdc++: a CXX that links it
    # statically into the library (some toolchain wrappers do) makes its
    # iostreams crash once loaded beside the interpreter's own
    os.environ["CXX"] = "g++"
    return host_build.build_library()


def build_kernels(patterns) -> None:
    """Every kernel of the package, one `nvcc` run a source, started
    together: the stream matcher for each tuple of `patterns`, the
    dictionary kernels and the table-DFA walk."""
    tuples = [tuple(strings.pattern_ir(p) for p in t) for t in patterns]
    build.build_sources([stream_matcher.source(tuples),
                         build.read_csrc("dict_lookup.cu"),
                         build.read_csrc("dfa_walk.cu")])
    stream_matcher.prepare(tuples)
    dict_lookup.prepare()
    dfa_walk.prepare()


def prepare(device: torch.device) -> None:
    """The native host library, then on the card every kernel."""
    t0 = time.perf_counter()
    build_host_library()
    log(f"native host library: {time.perf_counter() - t0:.1f} s")
    if device.type != "cuda":
        return
    t0 = time.perf_counter()
    build_kernels(PATTERN_TUPLES)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({len(PATTERN_TUPLES)} stream-matcher tuples, the dictionary "
        "kernels and the table-DFA walk, three nvcc runs at once)")


def run(rows: int, reps: int, device) -> tuple[dict, dict]:
    """Every route at `rows` rows; returns (the last line, the detail)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here (--device cpu "
                           "runs the plain versions)")
    t_start = time.perf_counter()
    prepare(device)
    cache = bench_dir()
    t0 = time.perf_counter()
    path = fixtures.lineitem(cache / f"lineitem_{rows}.parquet", rows)
    dpath = fixtures.dict_ints(cache / f"dictheavy_{rows}.parquet", rows)
    cpath = fixtures.dict_cities(cache / f"dictstrings_{rows}.parquet", rows)
    log(f"fixtures in {cache}: {time.perf_counter() - t0:.1f} s")
    # the page cache warm, so both sides measure decode work, not the disk
    with open(path, "rb") as f:
        while f.read(1 << 24):
            pass
    ref = bench_reference(path, reps)
    b = Bench(device, reps)
    scan = scan_routes(b, path)
    bigpage_route(b, rows)
    cold_routes(b, path, scan)
    stats_prune_route(b, cache, rows)
    columns = read_column_route(b, path)
    index_route(b, path)
    ms = decode_route(b, path, "l_tax", columns["l_tax"], "decode_f64opt")
    b.out["decode_f64opt_gb_per_s"] = scan["total"] * 8 / (ms / 1e3) / 1e9
    decode_route(b, dpath, "k", ParquetReader(str(dpath)).read_column("k"),
                 "decode_dict")
    dict_scan_route(b, cpath)
    delta_route(b, rows)
    dict_selective_route(b, cpath)
    b.require_launches()
    scaling = bench_scaling(SCALING_RANKS, SCALING_ROWS)

    value = b.out["scan_rows_per_s"]
    baseline = ref.get("ref_iter_rows_per_s")
    line = {"metric": "decode_regex_scan_rows_per_s",
            "value": round(value, 1), "unit": "rows/s",
            "vs_baseline": round(value / baseline, 2) if baseline else None}
    detail = {**ref, **b.out, "bands": b.bands, "launches": b.launches,
              "scaling": scaling,
              "scaling_note": (
                  "the scaling table runs the sharded scan step on CPU "
                  "ranks over gloo on this host; its wall efficiency is "
                  "bounded by the host's cores, shard skew shows the "
                  "sharding stays balanced"),
              "device": (torch.cuda.get_device_name(device) if b.cuda
                         else "cpu"),
              "left_out": LEFT_OUT,
              "wall_s": round(time.perf_counter() - t_start, 1)}
    if baseline:
        detail["vs_ref"] = {
            "scan_sustained": round(value / baseline, 1),
            "scan_cold_one_shot": round(
                b.out["scan_cold_e2e_rows_per_s"] / baseline, 1),
            "read_column_i64": round(b.out["read_column_i64_rows_per_s"]
                                     / ref["ref_column_i64_rows_per_s"], 1),
            "read_column_f64opt": round(
                b.out["read_column_f64opt_rows_per_s"]
                / ref["ref_column_f64opt_rows_per_s"], 1),
            "read_column_strings": round(
                b.out["read_column_strings_rows_per_s"] / baseline, 1),
        }
        if "ref_index_rows_per_s" in ref:
            detail["vs_ref"]["index_build"] = round(
                b.out["index_build_rows_per_s"]
                / ref["ref_index_rows_per_s"], 1)
    return line, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m duckdb_parquet_parser_tpu_torch.bench",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--quick", action="store_true",
                    help="200,000 rows and 3 reps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.quick:
        args.rows, args.reps = 200_000, 3
    line, detail = run(args.rows, args.reps, args.device)
    log(json.dumps({"detail": detail}))
    if torch.device(args.device).type == "cuda":
        log(card_line())
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
