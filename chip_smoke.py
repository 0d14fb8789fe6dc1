#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Builds the port's kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then drives the main
path — `ScanEngine(path).resident(column, device="cuda")` and its `scan` /
`scan_many` — on a 2M-row lineitem-like fixture and on a multi-row-group
dictionary-string fixture, and checks every per-page count against the
native host scan (`ScanEngine.cold_scan`, an independent C++
implementation).  Warm queries reuse kernels built up front; one cold
query, on a pattern built for the first time, includes its kernel build.
One warm query per fixture runs under torch.profiler for the device busy
time, the launches and the time per kernel (traces in build/profile/).
Each kernel is timed at the main path's shapes beside its plain version,
its bound (the larger of bytes over the card's memory rate and int32
operations over the card's int32 rate, for the work these inputs need) and,
for the dictionary gather, the one PyTorch call that computes the same.
The script imports only the port (`duckdb_parquet_parser_tpu_torch`), which
builds its own native host library and kernels from this checkout, and
refuses any import of JAX or of the JAX package.

Usage: python3 chip_smoke.py      (needs one CUDA device; no arguments)

Prints, in order: the card, build seconds, per-phase results, a JSON line
{"kernels": [...]}, the card's name and power limit as nvidia-smi reports
them, and last {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, without a CUDA device or without the repository beside it.
Fixtures and builds go under build/ in this checkout.
"""

from __future__ import annotations

import importlib.abc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the 11 patterns of the reference kernel's parity test
STREAM_PATTERNS = [
    "a.*z", "ab|cde|fg", "^ab", "q[ax]+x", "a?", "a{40}",
    "gr[ae]y|colou?r", "bc$", "[abq]{9}", "[a-gq-z]{9,12}x", "[abx ]{10}$",
]
FUSED = ("a.*z", "q[ax]+x", "[abq]{9}")
# the benchmark's five patterns; the last one's table DFA exceeds the
# compiler's state budget, so the resident scan refuses it (as the reference
# does) and it runs through the stream-matcher kernel directly
BENCH_PATTERNS = [
    "special.*requests", "spe[cs]ial.*requ[ea]sts", "carefully|quickly|special",
    "[a-z ]{30,45}requests", "carefully[a-z ]{32,}requests",
]
SCAN_PATTERNS = BENCH_PATTERNS[:4]
# a pattern no kernel is built for in advance: its first query pays the
# stream matcher's nvcc build, as a new ad-hoc pattern does
COLD_PATTERN = "furiously.*deposits"
DICT_PATTERNS = ["san.*-1[0-9]", "new (york|orleans)-2", "^bo", "ttle-3[0-9]*$"]
MAIN_ROWS = 2_000_000
K1_SOURCE = "duckdb_parquet_parser_tpu_torch/csrc/stream_matcher.cu.in"
K2_SOURCE = "duckdb_parquet_parser_tpu_torch/csrc/dict_lookup.cu"
K1_REPLACES = "duckdb_parquet_parser_tpu/ops/pallas/stream_matcher.py:94"
K2_REPLACES = "duckdb_parquet_parser_tpu/ops/pallas/dict_lookup.py:85"


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT32_LANES_PER_SM = 64    # int32 operations per SM and clock on Hopper


class _NoJax(importlib.abc.MetaPathFinder):
    """Refuses any import of JAX or of the JAX package: the port must run
    without them."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib",
                                  "duckdb_parquet_parser_tpu"):
            raise ImportError(f"the port imported {name}")
        return None


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def int32_ops_per_s() -> tuple[float, str]:
    """The card's peak int32 rate: SMs x 64 lanes x the maximum SM clock
    that nvidia-smi reports, and a note of where the numbers came from."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (sms * INT32_LANES_PER_SM * mhz * 1e6,
            f"{sms} SMs x {INT32_LANES_PER_SM} int32 lanes x {mhz:.0f} MHz "
            "(nvidia-smi clocks.max.sm)")


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take to move `n_bytes` and do `n_ops` int32 operations."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


_C_OPERATOR = re.compile(
    r"\+\+|<<|>>|<=|>=|==|!=|&&|\|\||\+=|[-+&|^~!<>?]")
# opcodes that the SM's multiply-add pipe executes beside the int32 lanes,
# and those that take a scheduler slot only
FMA_PIPE = ("IMAD", "FFMA", "FMUL", "FADD")
SLOT_ONLY = ("BRA", "BSSY", "BSYNC", "NOP")


def step_ops(irs) -> dict:
    """The work of one byte step of the stream matcher's walk for the
    pattern tuple `irs`: `nodes` (IR nodes that compute), `c_ops` (C
    operators of the emitted byte loop: the operator tokens between the
    head of the loop and its end, comments and preprocessor lines left out;
    a `?:` select counts once, casts and assignments do not count) and,
    where the toolkit has a disassembler, what the compiler made of them:
    `registers`, `spill_bytes`, `instructions` (machine instructions of the
    byte loop) and `int32_ops` (those the int32 lanes execute: all but the
    multiply-add pipe's and the branches).  `bound_ops` is the number the
    bound uses: the larger of `int32_ops` and half of `instructions` (an SM
    schedules 128 lanes a clock, twice its int32 lanes), or `c_ops` without a
    disassembler."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        build,
        stream_matcher,
    )

    src = stream_matcher.render([irs], host=True)
    body = src[src.index("for (int32_t j = 0;"):src.index("hits[0LL")]
    code = "\n".join(ln.split("//")[0] for ln in body.splitlines()
                     if not ln.lstrip().startswith("#"))
    out = {"nodes": sum(op not in ("const", "input")
                        for ir in irs for op, _kind, _args in ir.nodes),
           "c_ops": len(_C_OPERATOR.findall(code))}
    out["bound_ops"], out["counted"] = out["c_ops"], "C operators"
    if build.disassembler() is not None:
        (name, info), = [
            kv for kv in build.inspect_source(
                stream_matcher.render([irs])).items()
            if f"dpq_stream_{stream_matcher.tag_of(irs)}" in kv[0]]
        loop = info["loop_instructions"]
        total = sum(loop.values())
        int32 = total - sum(n for op, n in loop.items()
                            if op in FMA_PIPE + SLOT_ONLY)
        out.update(registers=info["registers"],
                   spill_bytes=info["spill_bytes"], instructions=total,
                   int32_ops=int32, bound_ops=max(int32, total / 2),
                   counted="machine instructions on the int32 lanes")
    return out


def timed(fn, reps: int) -> tuple[float, object]:
    """(ms per call, last result): CUDA events around `reps` calls after a
    warm-up call."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def random_pages(rng, n_pages, vals_per_page, maxlen,
                 alphabet=b"abcdefgqxyz "):
    """Pages of PLAIN BYTE_ARRAY payloads: ([n, pitch] u8, plen, nn)."""
    import numpy as np

    letters = np.frombuffer(alphabet, np.uint8)
    payloads, plens, nns = [], [], []
    for _ in range(n_pages):
        buf = bytearray()
        nv = int(rng.integers(1, vals_per_page + 1))
        for _ in range(nv):
            s = bytes(rng.choice(letters, int(rng.integers(0, maxlen))))
            buf += len(s).to_bytes(4, "little") + s
        payloads.append(bytes(buf))
        plens.append(len(buf))
        nns.append(nv)
    pm = np.zeros((n_pages, max(plens) + 8), np.uint8)
    for i, b in enumerate(payloads):
        pm[i, :len(b)] = np.frombuffer(b, np.uint8)
    return pm, np.array(plens, np.int32), np.array(nns, np.int32)


def check_stream_kernel(device, n_pages=2000):
    """K1 vs its plain version on random pages: the 11 patterns one by
    one, plus a fused K=3 tuple.  Exact equality."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.ops import strings
    from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher

    rng = np.random.default_rng(12)
    pm, plen, nn = random_pages(rng, n_pages, 6, 18)
    pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(device)
    chunked = stream_matcher.chunk_stream(pt)
    if not torch.equal(stream_matcher.unchunk_stream(chunked, pt.shape[0]), pt):
        raise AssertionError("the stream layout does not round-trip")
    pl = torch.from_numpy(plen).to(device)
    nv = torch.from_numpy(nn).to(device)
    cases = [(p,) for p in STREAM_PATTERNS] + [FUSED]
    for pats in cases:
        irs = tuple(strings.pattern_ir(p) for p in pats)
        h1, s1 = stream_matcher.match_stream(chunked, pl, nv, irs)
        h0, s0 = stream_matcher.match_stream_plain(pt, pl, nv, irs)
        if not (torch.equal(h1, h0) and torch.equal(s1, s0)):
            raise AssertionError(f"K1 disagrees with its plain version on {pats}")
    log(f"K1 vs plain: {len(cases)} cases over {n_pages} pages, exact")


def check_stream_kernel_split(col, device, n_pages=3000):
    """K1 vs its plain version on the split layout: the first pages of the
    resident column cut at value boundaries into short segment lanes; the
    segments' hits also sum back to the unsplit pages' hits."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.host.batch import to_tensor
    from duckdb_parquet_parser_tpu_torch.ops import scan, strings
    from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher

    arrays = {k: np.asarray(col._batch.arrays[k])[:n_pages]
              for k in ("payload", "page_payload_len", "page_nn", "page_kind")}
    sp = scan.split_payload_pages(arrays, trigger=256, target=256)
    if sp is None:
        raise AssertionError("the split plan cut nothing")
    seg_payload, seg_len, seg_nn, seg_page = sp
    steps = min(scan.scan_steps(seg_len), seg_payload.shape[1])
    seg_stream = scan.resident_stream(seg_payload, steps, device)
    seg_t = stream_matcher.unchunk_stream(seg_stream, steps)
    sl = to_tensor(seg_len, device, dtype=np.int32)
    sn = to_tensor(seg_nn, device, dtype=np.int32)
    seg = to_tensor(seg_page, device, dtype=np.int64)
    page_steps = scan.scan_steps(arrays["page_payload_len"])
    page_stream = scan.resident_stream(arrays["payload"], page_steps, device)
    pl = to_tensor(arrays["page_payload_len"], device, dtype=np.int32)
    pn = to_tensor(arrays["page_nn"], device, dtype=np.int32)
    cases = [(BENCH_PATTERNS[0],), (BENCH_PATTERNS[3],),
             tuple(BENCH_PATTERNS[:3])]
    for pats in cases:
        irs = tuple(strings.pattern_ir(p) for p in pats)
        h1, s1 = stream_matcher.match_stream(seg_stream, sl, sn, irs, steps)
        h0, s0 = stream_matcher.match_stream_plain(seg_t, sl, sn, irs, steps)
        if not (torch.equal(h1, h0) and torch.equal(s1, s0)):
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"the split layout, {pats}")
        whole, _seen = stream_matcher.match_stream(page_stream, pl, pn, irs,
                                                   page_steps)
        summed = torch.zeros_like(whole).index_add_(1, seg, h1)
        if not torch.equal(summed, whole):
            raise AssertionError(f"segment hits do not sum to page hits, {pats}")
    log(f"K1 vs plain on the split layout: {len(cases)} cases, "
        f"{len(seg_len)} segments of {n_pages} pages, exact; segment sums "
        "equal the unsplit walk")


def check_dict_kernel(device):
    """K2's gather entry vs its plain version: DN in {513, 4096, 8192},
    1-3 planes as a list and as one [P, DN] tensor, edge indices.  Exact
    equality."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import dict_lookup

    rng = np.random.default_rng(7)
    n = 0
    for dn in (513, 4096, 8192):
        for n_planes in (1, 2, 3):
            planes = [torch.from_numpy(
                rng.integers(-2**31, 2**31, dn, dtype=np.int64).astype(np.int32)
            ).to(device) for _ in range(n_planes)]
            g = rng.integers(0, dn, (300, 37)).astype(np.int32)
            g[0, :4] = [0, dn - 1, 0, dn - 1]
            g[-1, -2:] = [dn - 1, 0]
            gidx = torch.from_numpy(g).to(device)
            got = dict_lookup.dict_lookup(planes, gidx)
            want = dict_lookup.dict_lookup_plain(planes, gidx)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K2 disagrees at DN={dn} planes={n_planes}")
            table = torch.stack(planes)
            if not torch.equal(dict_lookup.dict_lookup(table, gidx),
                               dict_lookup.dict_lookup_plain(table, gidx)):
                raise AssertionError(f"K2 disagrees on a [P, DN] table at "
                                     f"DN={dn} planes={n_planes}")
            n += 2
    log(f"K2 gather entry vs plain: {n} cases, exact")


def random_dict_pages(rng, n, vmax, idx_w, lev_w, dn, k, max_def):
    """Random inputs of the fused count entry: nulls, out-of-range and
    negative indices, rows of PLAIN kind, short and empty pages."""
    import numpy as np

    num_values = rng.integers(0, vmax + 1, n).astype(np.int32)
    num_values[:3] = [0, vmax, vmax + 5]  # empty, full, longer than V
    kind = (rng.random(n) > 0.15).astype(np.int32)
    kind[3] = 0
    size = rng.integers(1, 40, n).astype(np.int32)
    base = rng.integers(0, max(dn - 40, 1), n).astype(np.int32)
    idx = rng.integers(-1, 44, (n, idx_w)).astype(np.int32)
    idx[rng.random((n, idx_w)) < 0.02] = 2**31 - 1
    lev = (rng.random((n, lev_w)) > 0.2).astype(np.uint8) * max(max_def, 1)
    table = (rng.random((k, dn)) > 0.6).astype(np.uint8)
    return idx, (lev if max_def > 0 else None), num_values, kind, base, size, table


def check_dict_count_kernel(device, dcol):
    """K2's fused count entry vs `dict_count_plain`: random pages (K in
    {1, 3, 6}, nulls, out-of-range indices, negate both ways, plane widths
    off the load width and narrower or wider than V, a REQUIRED column,
    rows of PLAIN kind, rows longer than one warp serves), then the dict
    fixture's resident bucket with real accept tables.  Exact equality."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.ops import scan
    from duckdb_parquet_parser_tpu_torch.ops.kernels import dict_lookup

    rng = np.random.default_rng(23)
    n_cases = 0
    # (N, V, idx width, level width, DN, K, max_def)
    shapes = [(300, 512, 512, 512, 6000, 1, 1), (300, 512, 512, 512, 6000, 3, 1),
              (257, 37, 37, 37, 513, 3, 1), (257, 100, 64, 128, 700, 1, 2),
              (100, 96, 128, 80, 90, 6, 1), (64, 48, 48, 0, 1, 2, 0),
              (40, 2500, 2500, 2512, 8192, 3, 1), (33, 1100, 1104, 1104, 50, 5, 1)]
    for n, vmax, idx_w, lev_w, dn, k, max_def in shapes:
        arrs = random_dict_pages(rng, n, vmax, idx_w, lev_w, dn, k, max_def)
        tens = [None if a is None else torch.from_numpy(a).to(device)
                for a in arrs]
        for negate in (False, True):
            kw = dict(vmax=vmax, max_def=max_def, negate=negate)
            c1, v1 = dict_lookup.dict_count(*tens, **kw)
            c0, v0 = dict_lookup.dict_count_plain(*tens, **kw)
            if not (torch.equal(c1, c0) and torch.equal(v1, v0)):
                raise AssertionError(
                    f"K2 count entry disagrees at N={n} V={vmax} widths="
                    f"({idx_w}, {lev_w}) DN={dn} K={k} max_def={max_def} "
                    f"negate={negate}")
            n_cases += 1
    b = dcol._batch
    core = dcol._buckets[0]["core"]
    for pats in ([DICT_PATTERNS[0]], DICT_PATTERNS[:3]):
        _p, dfas = scan.prepare_patterns(pats)
        table = scan.accept_table(scan.dict_accepts(b, dfas), device)
        for negate in (False, True):
            kw = dict(vmax=b.vmax, max_def=b.max_def, negate=negate)
            args = (core["idx_vals"], core.get("def_levels"),
                    core["page_num_values"], core["page_kind"],
                    core["page_dict_base"], core["page_dict_size"], table)
            c1, v1 = dict_lookup.dict_count(*args, **kw)
            c0, v0 = dict_lookup.dict_count_plain(*args, **kw)
            if not (torch.equal(c1, c0) and torch.equal(v1, v0)):
                raise AssertionError(f"K2 count entry disagrees on the dict "
                                     f"fixture, {pats} negate={negate}")
            n_cases += 1
    log(f"K2 count entry vs plain: {n_cases} cases (random pages and the "
        f"dict fixture at idx_vals {tuple(core['idx_vals'].shape)}, "
        f"DN={table.shape[1]}), exact")


def assert_same(res, eng, column, pattern, negate):
    """Per-page counts of a device scan against the port's native exact
    host scan (an independent C++ implementation)."""
    import numpy as np

    ref = eng.cold_scan(column, pattern, negate=negate, exact_counts=True,
                        stats_prune=False)
    order_a, order_b = np.argsort(res.page_gid), np.argsort(ref.page_gid)
    if not (np.array_equal(res.page_gid[order_a], ref.page_gid[order_b])
            and np.array_equal(res.match_counts[order_a],
                               ref.match_counts[order_b])
            and np.array_equal(res.value_counts[order_a],
                               ref.value_counts[order_b])):
        raise AssertionError(f"{column} ~ {pattern!r} (negate={negate}) "
                             "disagrees with the native host scan")
    return int(np.sum(res.match_counts)), int(np.sum(res.match_counts == 0))


def device_profile(fn, trace: Path):
    """One call of `fn` under torch.profiler after a warm-up: (wall ms
    under the profiler, device busy ms, kernel launches, {kernel: ms}).
    Busy is the union of kernel / memcpy / memset intervals in the
    exported trace; None when the profiler recorded no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    if not events:
        return wall, None, 0, {}
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: float(e["ts"])):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    by_name: dict = {}
    for e in events:
        name = e["name"] if e["cat"] == "kernel" else e["cat"]
        by_name[name] = by_name.get(name, 0.0) + float(e["dur"]) / 1e3
    launches = sum(e["cat"] == "kernel" for e in events)
    return wall, busy / 1e3, launches, by_name


def run_main_path(device, rows, dict_rows_per_rg, dict_distinct,
                  fixtures: Path):
    """The port's main path through the user entry points.  Returns the
    per-phase report and the inputs the kernel timings reuse."""
    import torch

    from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
    from duckdb_parquet_parser_tpu_torch.ops import strings
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        build,
        dict_lookup,
        stream_matcher,
    )
    from duckdb_parquet_parser_tpu_torch.ops.scan import prepare_patterns
    from duckdb_parquet_parser_tpu_torch.utils import fixtures as fx

    t0 = time.perf_counter()
    path = fx.lineitem(fixtures / f"lineitem_{rows}.parquet", rows)
    dpath = fx.dict_strings(
        fixtures / f"dict_cities_{dict_rows_per_rg}_{dict_distinct}.parquet",
        rows_per_rg=dict_rows_per_rg, n_rg=4, distinct=dict_distinct)
    log(f"fixtures ready in {time.perf_counter() - t0:.1f} s")
    eng = ScanEngine(str(path))
    deng = ScanEngine(str(dpath))
    stream_matcher.launches = 0
    dict_lookup.launches = 0
    t0 = time.perf_counter()
    col = eng.resident("l_comment", device=device)
    dcol = deng.resident("city", device=device)
    torch.cuda.synchronize()
    log(f"resident upload in {time.perf_counter() - t0:.2f} s "
        f"({col.n_pages} + {dcol.n_pages} pages)")
    dn = int(dcol._batch.dims["dict_n"])
    if not 513 <= dn <= 8192:
        raise AssertionError(f"dict fixture has {dn} dictionary entries")

    report = []
    n_rows = eng.reader.num_rows()
    for pat in SCAN_PATTERNS:
        ms, res = timed(lambda p=pat: col.scan(p), 3)
        hits, pruned = assert_same(res, eng, "l_comment", pat, False)
        report.append(("l_comment", pat, False, ms, n_rows, hits, pruned))
        # the query's host share: the pattern's DFA compile (per query,
        # as in the reference)
        t0 = time.perf_counter()
        prepare_patterns([pat])
        log(f"host DFA compile of {pat!r}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    ms, res = timed(lambda: col.scan(BENCH_PATTERNS[0], negate=True), 3)
    hits, pruned = assert_same(res, eng, "l_comment",
                               BENCH_PATTERNS[0], True)
    report.append(("l_comment", BENCH_PATTERNS[0], True, ms, n_rows, hits,
                   pruned))
    ms, many = timed(lambda: col.scan_many(BENCH_PATTERNS[:3]), 3)
    for pat, res in zip(BENCH_PATTERNS[:3], many):
        assert_same(res, eng, "l_comment", pat, False)
    report.append(("l_comment", "scan_many(first 3)", False, ms, 3 * n_rows,
                   None, None))
    d_rows = deng.reader.num_rows()
    for pat in DICT_PATTERNS:
        ms, res = timed(lambda p=pat: dcol.scan(p), 3)
        hits, pruned = assert_same(res, deng, "city", pat, False)
        report.append(("city", pat, False, ms, d_rows, hits, pruned))

    cold_irs = (strings.pattern_ir(COLD_PATTERN),)
    if stream_matcher.tag_of(cold_irs) in stream_matcher._registry:
        raise AssertionError(f"{COLD_PATTERN!r} was built in advance")
    n_so = len(list(build.BUILD_DIR.glob("*.so")))
    t0 = time.perf_counter()
    res = col.scan(COLD_PATTERN)
    cold_ms = (time.perf_counter() - t0) * 1e3
    built = len(list(build.BUILD_DIR.glob("*.so"))) > n_so
    hits, pruned = assert_same(res, eng, "l_comment", COLD_PATTERN, False)
    report.append(("l_comment", f"{COLD_PATTERN} (cold: first query, nvcc "
                   f"{'ran' if built else 'cached'})", False, cold_ms,
                   n_rows, hits, pruned))
    ms, res = timed(lambda: col.scan(COLD_PATTERN), 3)
    report.append(("l_comment", f"{COLD_PATTERN} (warm)", False, ms, n_rows,
                   hits, pruned))
    launches = {"stream_matcher": stream_matcher.launches,
                "dict_lookup": dict_lookup.launches}
    return report, launches, col, dcol


def query_launches(fn) -> dict:
    """Kernel launches of one call of `fn`, from the wrappers' counters."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dict_lookup,
        stream_matcher,
    )

    before = stream_matcher.launches, dict_lookup.launches
    fn()
    return {"stream_matcher": stream_matcher.launches - before[0],
            "dict_lookup": dict_lookup.launches - before[1]}


def best_of(fns: dict, reps: int, rounds: int = 2) -> dict:
    """{name: least ms per call} over `rounds` rounds that time each of
    `fns` in turn, so neighbours on the card's host disturb all alike."""
    best = {name: float("inf") for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            best[name] = min(best[name], timed(fn, reps)[0])
    return best


def time_kernels(col, dcol, device, ops_per_s):
    """Each kernel at the main path's shapes (the largest l_comment
    bucket; the dict fixture's bucket) beside its plain version, its bound
    and, for the gather, the one PyTorch call that computes the same.
    Returns the two entries of the kernels line (without launches)."""
    import torch

    from duckdb_parquet_parser_tpu_torch.ops import scan, strings
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dict_lookup,
        stream_matcher,
    )

    # K1 ---------------------------------------------------------------
    bk = max(col._buckets, key=lambda b: b["stream"].numel())
    n = bk["walk_plen"].shape[0]
    plain_stream = stream_matcher.unchunk_stream(bk["stream"], bk["steps"])
    active = torch.where(bk["walk_nn"] > 0,
                         bk["walk_plen"].clamp(max=bk["steps"]), 0)
    walked = int(active.sum())
    k1 = None
    for pats in ([BENCH_PATTERNS[0]], [BENCH_PATTERNS[3]],
                 BENCH_PATTERNS[:3]):
        irs = tuple(strings.pattern_ir(p) for p in pats)
        args = (bk["walk_plen"], bk["walk_nn"], irs, bk["steps"])
        ms, (h1, s1) = timed(
            lambda: stream_matcher.match_stream(bk["stream"], *args), 20)
        ops = step_ops(irs)
        n_bytes = walked + 8 * n + 4 * (len(irs) + 1) * n
        b_ms, b_by = bound(n_bytes, ops["bound_ops"] * walked, ops_per_s)
        made = ("" if "instructions" not in ops else
                f"; compiled to {ops['instructions']} machine instructions a "
                f"step, {ops['int32_ops']} of them on the int32 lanes, "
                f"{ops['registers']} registers, {ops['spill_bytes']} spill "
                "bytes")
        log(f"K1 {pats} at {tuple(bk['stream'].shape)} u8, K={len(irs)}: "
            f"kernel {ms:.4f} ms per call; {walked} bytes walked, a step is "
            f"{ops['c_ops']} C operators ({ops['nodes']} IR nodes + "
            f"{ops['c_ops'] - ops['nodes']} of control){made}; {n_bytes} "
            f"bytes moved: bound {b_ms:.4f} ms by {b_by} ({ops['bound_ops']:g} "
            f"{ops['counted']} a step); the bound is {100 * b_ms / ms:.1f}% "
            "of the kernel's time")
        if k1 is None:
            plain_ms, (h0, s0) = timed(
                lambda: stream_matcher.match_stream_plain(plain_stream,
                                                          *args), 1)
            err = max(int((h1 - h0).abs().max()), int((s1 - s0).abs().max()))
            k1 = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            log(f"K1 plain version: {plain_ms:.1f} ms per call; no single "
                "PyTorch call computes the walk (library_ms null)")
    both = [b for b in col._buckets if b["has_plain"]]
    irs = (strings.pattern_ir(BENCH_PATTERNS[0]),)
    ms, _ = timed(lambda: [stream_matcher.match_stream(
        b["stream"], b["walk_plen"], b["walk_nn"], irs, b["steps"])
        for b in both], 20)
    log(f"K1 over all {len(both)} PLAIN buckets of one l_comment query: "
        f"{ms:.4f} ms")
    for pat in BENCH_PATTERNS[len(SCAN_PATTERNS):]:
        irs = (strings.pattern_ir(pat),)
        args = (bk["walk_plen"], bk["walk_nn"], irs, bk["steps"])
        h1, s1 = stream_matcher.match_stream(bk["stream"], *args)
        h0, s0 = stream_matcher.match_stream_plain(plain_stream, *args)
        if not (torch.equal(h1, h0) and torch.equal(s1, s0)):
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{pat!r} at the main path's shape")
        log(f"K1 vs plain on {pat!r} over the resident l_comment bucket: "
            f"exact, {int(h1.sum())} hits")
    del plain_stream

    # K2, the fused count entry (the scan's) ------------------------------
    b = dcol._batch
    core = dcol._buckets[0]["core"]
    _p, dfas = scan.prepare_patterns([DICT_PATTERNS[0]])
    table = scan.accept_table(scan.dict_accepts(b, dfas), device)
    kw = dict(vmax=b.vmax, max_def=b.max_def, negate=False)
    args = (core["idx_vals"], core.get("def_levels"), core["page_num_values"],
            core["page_kind"], core["page_dict_base"], core["page_dict_size"],
            table)
    t = best_of({"kernel": lambda: dict_lookup.dict_count(*args, **kw),
                 "plain": lambda: dict_lookup.dict_count_plain(*args, **kw)},
                200)
    c1, v1 = dict_lookup.dict_count(*args, **kw)
    c0, v0 = dict_lookup.dict_count_plain(*args, **kw)
    err = max(int((c1 - c0).abs().max()), int((v1 - v0).abs().max()))
    n, idx_w = core["idx_vals"].shape
    k, dn = table.shape
    is_dict = core["page_kind"] == 1
    cells = int(torch.where(is_dict, core["page_num_values"].clamp(
        max=min(b.vmax, idx_w)), 0).sum())
    n_bytes = (cells * (4 + (1 if b.max_def > 0 else 0)) + 16 * n + k * dn
               + 4 * (k + 1) * n)
    # a cell: unpack and test the level (3), test the index (3), base add
    # and clamp (3), count (1); a pattern: address, load test, xor, add (4)
    b_ms, b_by = bound(n_bytes, cells * (10 + 4 * k), ops_per_s)
    log(f"K2 count entry at idx_vals {(n, idx_w)}, DN={dn}, K={k}: kernel "
        f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms per call (least of "
        f"2 rounds of 200); {cells} cells, {n_bytes} bytes moved: bound "
        f"{b_ms:.5f} ms by {b_by}")
    k2 = {"max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
          "bound_ms": b_ms, "bound_by": b_by}

    # K2, the gather entry, beside the one PyTorch call ---------------------
    idx = core["idx_vals"][:, :b.vmax].to(torch.int32)
    g = (core["page_dict_base"][:, None] + idx.clamp(min=0)).clamp(
        0, dn - 1).to(torch.int32).contiguous()
    planes = table.to(torch.int32)
    t = best_of({
        "kernel": lambda: dict_lookup.dict_lookup(planes, g),
        "library": lambda: planes[0][g.long()],
        "plain": lambda: dict_lookup.dict_lookup_plain(planes, g)}, 200)
    got = dict_lookup.dict_lookup(planes, g)
    if not torch.equal(got, dict_lookup.dict_lookup_plain(planes, g)):
        raise AssertionError("K2 gather entry differs from its plain version")
    g_bytes = 4 * g.numel() + 4 * planes.numel() + 4 * got.numel()
    g_ms, g_by = bound(g_bytes, 4 * g.numel(), ops_per_s)
    log(f"K2 gather entry at gidx {tuple(g.shape)}, DN={dn}, 1 plane: kernel "
        f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, the PyTorch call "
        f"plane[gidx.long()] {t['library']:.4f} ms per call (least of 2 "
        f"rounds of 200); {g_bytes} bytes moved: bound {g_ms:.5f} ms by "
        f"{g_by}")
    k2.update(library_ms=t["library"], gather_ms=t["kernel"],
              gather_plain_ms=t["plain"], gather_bound_ms=g_ms,
              library_call="plane[gidx.long()], beside gather_ms")
    return k1, k2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "duckdb_parquet_parser_tpu_torch").is_dir():
        print("chip_smoke: the repository is not beside this script",
              file=sys.stderr)
        return 2
    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("DPQ_BUILD_CACHE", str(ROOT / "build" / "native"))
    # The native host library must link the shared libstdc++: a CXX that
    # links it statically into the library (some toolchain wrappers do)
    # makes its iostreams crash once loaded beside the interpreter's own
    # libstdc++.
    os.environ["CXX"] = "g++"
    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    ops_per_s, ops_note = int32_ops_per_s()
    log(f"peaks used for the bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s of "
        f"device memory; {ops_per_s / 1e12:.3f} T int32 operations/s = "
        f"{ops_note}")

    from duckdb_parquet_parser_tpu_torch.host import build as host_build
    from duckdb_parquet_parser_tpu_torch.ops import strings
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dict_lookup,
        stream_matcher,
    )

    t0 = time.perf_counter()
    lib = host_build.build_library()
    log(f"native host library: {time.perf_counter() - t0:.1f} s "
        f"({lib.name})")
    tuples = ([(p,) for p in STREAM_PATTERNS + BENCH_PATTERNS + DICT_PATTERNS]
              + [FUSED, tuple(BENCH_PATTERNS[:3])])
    t0 = time.perf_counter()
    stream_matcher.prepare([tuple(strings.pattern_ir(p) for p in t)
                            for t in tuples])
    t1 = time.perf_counter()
    dict_lookup.prepare()
    log(f"kernel build: {t1 - t0:.1f} s for {len(tuples)} stream-matcher "
        f"tuples in one nvcc run, {time.perf_counter() - t1:.1f} s for the "
        "dictionary kernels")

    check_stream_kernel(device)
    check_dict_kernel(device)
    report, launches, col, dcol = run_main_path(
        device, MAIN_ROWS, 100_000, 1500, ROOT / "build" / "fixtures")
    for column, pat, neg, ms, rows, hits, pruned in report:
        extra = "" if hits is None else f", {hits} hits, {pruned} pages pruned"
        log(f"{column} ~ {pat!r}{' negate' if neg else ''}: {ms:.3f} ms/query, "
            f"{rows / ms * 1e3:.4g} rows/s{extra}; equal to native scan")
    log(f"main-path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    check_stream_kernel_split(col, device)
    check_dict_count_kernel(device, dcol)

    queries = (("l_comment", col, lambda: col.scan(BENCH_PATTERNS[0])),
               ("city", dcol, lambda: dcol.scan(DICT_PATTERNS[0])))
    per_query = {}
    for label, rc, fn in queries:
        per_query[label] = query_launches(fn)
        want = {"stream_matcher": sum(b["has_plain"] for b in rc._buckets),
                "dict_lookup": sum(b["has_dict"] for b in rc._buckets)}
        log(f"launches of one {label} query: {per_query[label]} "
            f"({len(rc._buckets)} buckets; PLAIN in {want['stream_matcher']}, "
            f"dictionary pages in {want['dict_lookup']})")
        if per_query[label] != want:
            raise AssertionError(f"{label}: a kernel ran on a bucket that "
                                 "holds none of its pages, or missed one")
    for label, _rc, fn in queries:
        wall, busy, n, by_name = device_profile(
            fn, ROOT / "build" / "profile" / f"{label}.json")
        if busy is None:
            raise AssertionError(f"profile {label}: the profiler recorded "
                                 "no device events")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        k1_dev = sum(v for k, v in by_name.items()
                     if k.startswith("dpq_stream_"))
        k2_dev = sum(v for k, v in by_name.items() if "dict_" in k)
        log(f"profile {label} (one warm query under torch.profiler): wall "
            f"{wall:.3f} ms, device busy {busy:.4f} ms "
            f"({100 * (1 - busy / wall):.2f}% idle), {n} kernel launches; "
            f"K1 {k1_dev:.4f} ms, K2 {k2_dev:.4f} ms on the device; top: "
            + "; ".join(f"{k[:48]} {v:.4f} ms" for k, v in top))
        ranks = [k for k in by_name if "scan_innermost" in k or "cumsum" in k]
        if ranks:
            raise AssertionError(f"profile {label}: the rank prefix sum "
                                 f"still runs: {ranks}")

    k1, k2 = time_kernels(col, dcol, device, ops_per_s)
    for name, entry in (("K1", k1), ("K2", k2)):
        if entry["max_abs_err"] != 0:
            raise AssertionError(f"{name} differs from its plain version")
    kernels = [
        {"name": "stream_matcher", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["stream_matcher"],
         "launches_per_query": {q: v["stream_matcher"]
                                for q, v in per_query.items()}, **k1},
        {"name": "dict_lookup", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["dict_lookup"],
         "launches_per_query": {q: v["dict_lookup"]
                                for q, v in per_query.items()}, **k2},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
