"""Probe of kernel K3's page walk at the main path's shapes, on one GPU.

Times `dfa_walk.stream_walk` of the package under `--root` (default: the
checkout this file is in) over the resident 2M-row `l_comment` column under
`(furiously|carefully) (express|regular)+ (deposits|requests)`: on both
length buckets and on the split layout (its pages cut into 256-byte
segments at value boundaries), on the card alone (the calls queued behind a
few ms of other work, so the host's launch cost hides) and a call (CUDA
events around back-to-back calls), the least of several rounds.  Every
result is checked against the plain loop.
Run it once a tree, in turns, to hold two trees against each other in one
run on one card (each tree builds its own kernels under its own
`build/`).  `--ablate` builds csrc/dfa_walk.cu as it is and under each of
ABLATIONS (the stream's loads alone, the walk over zero bytes, the walk
without its boundary control) and times them on the larger bucket.

Usage: CXX=g++ python3 duckdb_parquet_parser_tpu_torch/utils/probe_stream_walk.py
           [--root DIR] [--fixtures DIR] [--rounds N] [--ablate]
(needs one CUDA device; prints the card, then one JSON line.)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

PATTERN = "(furiously|carefully) (express|regular)+ (deposits|requests)"
ROWS = 2_000_000
_KERNEL = "template <int MODE>\n__global__ void __launch_bounds__(kPageThreads"
_LANE_CALL = "dpq_page_lane<MODE>(pay, n, lane, steps, plen[lane], nn[lane]"

# A lane's chunks loaded, one after another, and nothing walked.
_LOADS = """
template <int MODE>
__device__ __forceinline__ void dpq_page_loads(
    const uint8_t* __restrict__ pay, long long n, long long lane,
    int32_t steps, int32_t pl, int32_t nv, const uint8_t* __restrict__,
    uint32_t, int32_t, int32_t, int32_t* __restrict__ hits,
    int32_t* __restrict__ seen)
{
    const int32_t lim = pl < steps ? pl : steps;
    const int32_t n_chunks = nv > 0 ? (lim + 15) >> 4 : 0;
    uint64_t x = 0;
    for (int32_t ch = 0; ch < n_chunks; ++ch) {
        const dpq_chunk c = dpq_load_chunk(pay + 16 * ((long long)ch * n + lane));
        x ^= c.lo ^ c.hi;
    }
    hits[lane] = (int32_t)x;
    seen[lane] = (int32_t)(x >> 32);
}
"""
# Every byte of a lane's chunks walked as one value: the same loads and
# unrolled steps, no prefix, no value boundary.
_NO_CONTROL = """
template <int MODE>
__device__ __forceinline__ void dpq_page_nocontrol(
    const uint8_t* __restrict__ pay, long long n, long long lane,
    int32_t steps, int32_t pl, int32_t nv, const uint8_t* __restrict__ table,
    uint32_t start, int32_t n_classes, int32_t accept0,
    int32_t* __restrict__ hits, int32_t* __restrict__ seen)
{
    const int32_t lim = nv > 0 ? (pl < steps ? pl : steps) : 0;
    const int32_t n_chunks = (lim + 15) >> 4;
    const uint8_t* p = pay + 16 * lane;
    const long long pitch = 16 * n;
    dpq_chunk cur = {0, 0}, nxt = {0, 0};
    if (n_chunks > 0) cur = dpq_load_chunk(p);
    if (n_chunks > 1) nxt = dpq_load_chunk(p + pitch);
    uint32_t st = start, acc = (uint32_t)accept0;
    for (int32_t ch = 0; ch < n_chunks; ++ch) {
        dpq_chunk ahead = {0, 0};
        if (ch + 2 < n_chunks) ahead = dpq_load_chunk(p + (ch + 2) * pitch);
        const int32_t hi = lim - 16 * ch < 16 ? lim - 16 * ch : 16;
        uint32_t st_b = start, acc_b = (uint32_t)accept0;
        dpq_page_step<0, MODE>(cur, (1u << hi) - 1u, 0u, st, acc, st_b,
                               acc_b, table, n_classes);
        cur = nxt;
        nxt = ahead;
    }
    hits[lane] = (int32_t)dpq_value_accept<MODE>(st, acc, table);
    seen[lane] = n_chunks;
}
"""
# {label: [(old, new), ...]}: cuts of the page kernel that take one cost
# away each (for the folded table the main pattern takes).
ABLATIONS = {
    "loads alone": [(_KERNEL, _LOADS + _KERNEL),
                    (_LANE_CALL, _LANE_CALL.replace("dpq_page_lane",
                                                    "dpq_page_loads"))],
    "walk over zero bytes": [
        ("const uint32_t b = dpq_page_byte<J>(q);", "const uint32_t b = 0;")],
    "boundary control off": [(_KERNEL, _NO_CONTROL + _KERNEL),
                             (_LANE_CALL, _LANE_CALL.replace(
                                 "dpq_page_lane", "dpq_page_nocontrol"))],
}


def ablate(stream, plen, nn, steps, dfa, want, rounds: int) -> dict:
    """{label: ms on the card alone} of the page walk as built and under
    each of ABLATIONS, all `nvcc` runs at once; only the build as it is
    is checked against `want`."""
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import build, dfa_walk
    from duckdb_parquet_parser_tpu_torch.utils.probe_value_walk import _ms

    src = build.read_csrc("dfa_walk.cu")
    texts = {"as built": src}
    for label, cuts in ABLATIONS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise AssertionError(f"ablation {label!r}: {old!r} is not in "
                                     "the source once")
            text = text.replace(old, new)
        texts[label] = text
    build.build_sources(list(texts.values()))
    dev = torch.cuda.current_device()
    packed, table = dfa_walk._device_table(dfa, stream.device)
    mode, nbytes = dfa_walk.table_mode(packed, dev, False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = stream.shape[1]
    hits = torch.empty(n, dtype=torch.int32, device=stream.device)
    seen = torch.empty_like(hits)
    fns = {}
    for label, text in texts.items():
        lib = build.load_source(text)
        lib.dpq_dfa_stream.argtypes = dfa_walk._lib().dpq_dfa_stream.argtypes
        lib.dpq_dfa_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        grid = sms * lib.dpq_dfa_blocks_per_sm(
            dfa_walk.walk_code(False, mode == dfa_walk.FOLDED), nbytes)

        def fn(lib=lib, grid=grid):
            rc = lib.dpq_dfa_stream(
                stream.data_ptr(), n, steps, plen.data_ptr(), nn.data_ptr(),
                table.data_ptr(), table.numel(), packed.n_states,
                packed.n_classes, packed.accept0, mode, grid,
                hits.data_ptr(), seen.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError {rc}")
            return hits, seen

        if label == "as built" and not all(map(torch.equal, fn(), want)):
            raise AssertionError("the build differs from the plain walk")
        fns[label] = fn
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(rounds):
        for label, fn in fns.items():
            best[label] = min(best[label], _ms(fn, 20, True))
    return best


def layouts(col) -> dict:
    """{label: (stream, plen, nn, steps)}: the resident column's buckets
    with PLAIN pages and its pages cut into 256-byte segments."""
    import numpy as np

    from duckdb_parquet_parser_tpu_torch.host.batch import to_tensor
    from duckdb_parquet_parser_tpu_torch.ops import scan

    out = {f"bucket {list(b['stream'].shape)}": (
        b["stream"], b["walk_plen"], b["walk_nn"], b["steps"])
        for b in col._buckets if b["has_plain"]}
    payload, seg_len, seg_nn, _page = scan.split_payload_pages(
        col._batch.arrays, trigger=256, target=256)
    steps = min(scan.scan_steps(seg_len), payload.shape[1])
    stream = scan.resident_stream(payload, steps, col.device)
    out[f"split {list(stream.shape)}"] = (
        stream, to_tensor(seg_len, col.device, dtype=np.int32),
        to_tensor(seg_nn, col.device, dtype=np.int32), steps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--fixtures", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("probe_stream_walk: no CUDA device", file=sys.stderr)
        return 2
    from duckdb_parquet_parser_tpu_torch.bench import card_line
    from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dfa_walk,
        stream_matcher,
    )
    from duckdb_parquet_parser_tpu_torch.ops.regex import compile_pattern
    from duckdb_parquet_parser_tpu_torch.utils import fixtures
    from duckdb_parquet_parser_tpu_torch.utils.probe_value_walk import _ms

    card = card_line()
    print(f"card: {card}; tree {root}", flush=True)
    fdir = Path(args.fixtures) if args.fixtures else root / "build" / "fixtures"
    path = fixtures.lineitem(fdir / f"lineitem_{ROWS}.parquet", ROWS)
    col = ScanEngine(str(path)).resident("l_comment", device="cuda")
    dfa = compile_pattern(PATTERN)
    out: dict = {"root": str(root), "card": card}
    lay = layouts(col)
    wants = {}
    for label, (stream, pl, nv, steps) in lay.items():
        want = wants[label] = dfa_walk.stream_walk_plain(
            stream_matcher.unchunk_stream(stream, steps), pl, nv, dfa, steps)
        def walk():
            return dfa_walk.stream_walk(stream, pl, nv, dfa, steps)

        if not all(map(torch.equal, walk(), want)):
            raise AssertionError(f"page walk differs from the plain one on "
                                 f"{label}")
        best: dict = {"walked_bytes": int(torch.where(
            nv > 0, pl.clamp(max=steps), 0).sum())}
        for _ in range(args.rounds):
            for queued in (True, False):
                key = f"page_{'device_' if queued else ''}ms"
                best[key] = min(best.get(key, float("inf")),
                                _ms(walk, 20, queued))
        out[label] = best
    if args.ablate:
        big = max((k for k in lay if k.startswith("bucket")),
                  key=lambda k: lay[k][0].numel())
        out["ablate"] = {"layout": big, **ablate(*lay[big], dfa, wants[big],
                                                 args.rounds)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
