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
The script imports only the port (`duckdb_parquet_parser_tpu_torch`) and
refuses any import of JAX.

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


class _NoJax(importlib.abc.MetaPathFinder):
    """Refuses any import of JAX: the port must run without it."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"the port imported {name}")
        return None


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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
    pl = torch.from_numpy(plen).to(device)
    nv = torch.from_numpy(nn).to(device)
    cases = [(p,) for p in STREAM_PATTERNS] + [FUSED]
    for pats in cases:
        irs = tuple(strings.pattern_ir(p) for p in pats)
        h1, s1 = stream_matcher.match_stream(pt, pl, nv, irs)
        h0, s0 = stream_matcher.match_stream_plain(pt, pl, nv, irs)
        if not (torch.equal(h1, h0) and torch.equal(s1, s0)):
            raise AssertionError(f"K1 disagrees with its plain version on {pats}")
    log(f"K1 vs plain: {len(cases)} cases over {n_pages} pages, exact")


def check_dict_kernel(device):
    """K2 vs its plain version: DN in {513, 4096, 8192}, 1-3 planes, edge
    indices.  Exact equality."""
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
            n += 1
    log(f"K2 vs plain: {n} cases, exact")


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


def time_kernels(col, dcol, device):
    """Each kernel and its plain version at the main path's shapes (the
    largest l_comment bucket; the dict fixture's lookup)."""
    import torch

    from duckdb_parquet_parser_tpu_torch.ops import decode, strings
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dict_lookup,
        stream_matcher,
    )
    from duckdb_parquet_parser_tpu_torch.ops.scan import map_dict_accepts

    bk = max(col._buckets, key=lambda b: b["payload_t"].numel())
    irs = (strings.pattern_ir(BENCH_PATTERNS[0]),)
    args = (bk["payload_t"], bk["plen"], bk["core"]["page_nn"], irs,
            bk["steps"])
    k1_ms, (h1, s1) = timed(lambda: stream_matcher.match_stream(*args), 10)
    k1_plain_ms, (h0, s0) = timed(
        lambda: stream_matcher.match_stream_plain(*args), 1)
    k1_err = max(int((h1 - h0).abs().max()), int((s1 - s0).abs().max()))
    for pat in BENCH_PATTERNS[len(SCAN_PATTERNS):]:
        irs = (strings.pattern_ir(pat),)
        h1, s1 = stream_matcher.match_stream(*args[:3], irs, args[4])
        h0, s0 = stream_matcher.match_stream_plain(*args[:3], irs, args[4])
        if not (torch.equal(h1, h0) and torch.equal(s1, s0)):
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{pat!r} at the main path's shape")
        log(f"K1 vs plain on {pat!r} over the resident l_comment bucket: "
            f"exact, {int(h1.sum())} hits")

    core = dcol._buckets[0]["core"]
    b = dcol._batch
    nonnull, nn_idx = decode.decode_levels(core, b.max_def, b.vmax)
    dict_idx, _ok = decode.decode_dict_indices(core, nn_idx, b.nn_cap,
                                               nonnull=nonnull)
    dn = int(b.dims["dict_n"])
    table = (torch.arange(dn, device=device, dtype=torch.int32) % 3 == 0
             ).to(torch.int32)
    base = core["page_dict_base"][:, None]
    g = (base + dict_idx.clamp(min=0)).clamp(0, dn - 1).to(
        torch.int32).contiguous()
    k2_ms, got = timed(lambda: dict_lookup.dict_lookup([table], g), 20)
    k2_plain_ms, want = timed(
        lambda: dict_lookup.dict_lookup_plain([table], g), 20)
    k2_err = int((got[0] - want[0]).abs().max())
    via_scan = map_dict_accepts(core, [table], dict_idx)[0]
    if not torch.equal(via_scan, want[0]):
        raise AssertionError("map_dict_accepts disagrees with the plain lookup")
    shapes = {"k1": f"{tuple(bk['payload_t'].shape)} u8, K=1",
              "k2": f"gidx {tuple(g.shape)}, DN={dn}, 1 plane"}
    return (k1_ms, k1_plain_ms, k1_err), (k2_ms, k2_plain_ms, k2_err), shapes


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

    from duckdb_parquet_parser_tpu_torch.ops import strings
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dict_lookup,
        stream_matcher,
    )

    tuples = ([(p,) for p in STREAM_PATTERNS + BENCH_PATTERNS + DICT_PATTERNS]
              + [FUSED, tuple(BENCH_PATTERNS[:3])])
    t0 = time.perf_counter()
    stream_matcher.prepare([tuple(strings.pattern_ir(p) for p in t)
                            for t in tuples])
    dict_lookup.prepare()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({len(tuples)} stream-matcher tuples + dict lookup)")

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

    for label, fn in (
            ("l_comment", lambda: col.scan(BENCH_PATTERNS[0])),
            ("city", lambda: dcol.scan(DICT_PATTERNS[0]))):
        wall, busy, n, by_name = device_profile(
            fn, ROOT / "build" / "profile" / f"{label}.json")
        if busy is None:
            log(f"profile {label}: wall {wall:.3f} ms; device time not "
                "measured (the profiler recorded no device events)")
            continue
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        k1_dev = sum(v for k, v in by_name.items()
                     if k.startswith("dpq_stream_"))
        k2_dev = sum(v for k, v in by_name.items()
                     if k.startswith("dpq_dict_lookup"))
        log(f"profile {label} (one warm query under torch.profiler): wall "
            f"{wall:.3f} ms, device busy {busy:.4f} ms "
            f"({100 * (1 - busy / wall):.2f}% idle), {n} kernel launches; "
            f"K1 {k1_dev:.4f} ms, K2 {k2_dev:.4f} ms on the device; top: "
            + "; ".join(f"{k[:48]} {v:.4f} ms" for k, v in top))

    k1, k2, shapes = time_kernels(col, dcol, device)
    log(f"K1 at {shapes['k1']}: kernel {k1[0]:.4f} ms, plain {k1[1]:.1f} ms "
        "per call")
    log(f"K2 at {shapes['k2']}: kernel {k2[0]:.4f} ms, plain {k2[1]:.4f} ms "
        "per call")
    for name, (_ms, _pms, err) in (("K1", k1), ("K2", k2)):
        if err != 0:
            raise AssertionError(f"{name} differs from its plain version")
    kernels = [
        {"name": "stream_matcher", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["stream_matcher"],
         "max_abs_err": k1[2], "ms": k1[0], "plain_ms": k1[1]},
        {"name": "dict_lookup", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["dict_lookup"],
         "max_abs_err": k2[2], "ms": k2[0], "plain_ms": k2[1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
