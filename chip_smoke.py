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
Then the decode path at the same scale: three fixed-width lineitem columns
and a dictionary-encoded INT64 column of 2M rows are prescanned, uploaded
once and decoded on the card (`decode_fixed_device`, `_materialize_fixed`),
and must equal, bit for bit, what `read_column` gives through the native
column sweep (independent C++ code); small random batches (boolean bits,
mixed PLAIN / dictionary pages, out-of-range indices, run expansion) decode
on the card as on the CPU; 2M seeded DELTA_BINARY_PACKED values decode to
their seed; and the block scans (`scan_batched`, `scan_streaming`), the
row-level matches (`matching_rows`) and the fused single step
(`single_chip_forward`) equal the native scan.
Then the table-DFA path (kernel K3, for patterns outside the
register-machine family): K3's page walk against the plain version on both
resident l_comment buckets and its split layout (256-byte segments) for
three such patterns and under random tables of 300 and 4,096 states (staged
in shared memory / read from device memory), its per-value walk in every
variant on l_comment's `str_padded`, city's `dict_padded` and 20 edge
shapes of its blocks, grid and windows (rows 1-300000, pitches 13-256, rows
off 16-byte alignment); the resident queries (plain and negated),
`scan_streaming` and `matching_rows` against the native scan, with K3's
launches counted and none of K1's; the pattern's host compiles
(`ops/regex.compile_pattern`) in one resident query and in a first and a
repeated `scan_streaming`, which must be 1, 1 and 0, with each call's ms
and the card's name and power limit; a never-seen table-DFA pattern's first
query, which builds nothing; K3 timed beside its plain version and its
bound (the page walk on both buckets and the split layout, its bound
recounted from the operations it needs a byte and a value, the shared
loads' floor beside it; the per-value walk with the 32-byte sectors the
rows need); one warm query profiled with K3 and with the plain loop it
replaced, and the K3 launches its profiles record.
Then the front door and the sharded paths: the command line (`cli.main`:
file info, a regex scan on the card that prints what the native scan
prints, `index ... l_comment` with its 18767 chunks); one rank over NCCL on
the card at full width (`ScanEngine(mesh=...)`, `distributed_decode`,
`distributed_index_build` in both exchange modes, an elastic scan) against
the native scan, `read_column` and `build_index_for_column`; and four ranks
over gloo that share the card, started as a group by
`utils/probe_sharded.run_group` on a 500,000-row file, each holding its
results against the one-rank answers;
then `python -m duckdb_parquet_parser_tpu_torch.launch` (`scan`, `index`,
`scaling-bench`) as three one-rank NCCL processes whose JSON lines must
agree with the sharded phase; one NCCL rank also scans a table-DFA pattern.
Then the multi-device dry run, `python -m duckdb_parquet_parser_tpu_torch.dryrun
2 --backend gloo --device cuda`: two gloo ranks that share the card, started
by the module, must print the reference's line at two devices, and each
rank must have launched K1 and K2; every call of the kernels' wrappers that
the ranks recorded (`--record`) is made again on the card, the kernel
beside its plain version on the same tensors, compared exactly.
Then the benchmark program, `python -m duckdb_parquet_parser_tpu_torch.bench
--quick` (200,000 rows), runs as a child process: it holds every route
against the native host before timing it, must exit 0 and end with the
reference benchmark's JSON line, and its detail is logged.
Each kernel is timed at the main path's shapes beside its plain version,
its bound (the larger of bytes over the card's memory rate and int32
operations over the card's int32 rate, for the work these inputs need) and,
for the dictionary gather, the one PyTorch call that computes the same;
the gather's inputs at the emission decode's shapes are the tensors the
index build itself passed to the wrapper, recorded in those runs.
The script imports only the port (`duckdb_parquet_parser_tpu_torch`), which
builds its own native host library and kernels from this checkout, and the
lanes at K1's chunk edges (`tests/page_edges.py`, NumPy alone, shared with
the CPU tests), and refuses any import of JAX or of the JAX package.

Usage: python3 chip_smoke.py      (needs one CUDA device; no arguments)
       (`--profile-probe [late]` is how it starts its fresh-process
       profiles of K3)

Prints, in order: the card, build seconds, per-phase results, a JSON line
{"kernels": [...]}, the card's name and power limit as nvidia-smi reports
them, and last {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, without a CUDA device or without the repository beside it.
Fixtures and builds go under build/ in this checkout.
"""

from __future__ import annotations

import contextlib
import importlib.abc
import importlib.util
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
# the pattern of the fused single step on `build_example_batch`'s file
EXAMPLE_PATTERN = "word_[0-3]_"
MAIN_ROWS = 2_000_000
# the decode path: (fixture, column) at MAIN_ROWS rows, four row groups
DECODE_COLUMNS = [("lineitem", "l_quantity"), ("lineitem", "l_extendedprice"),
                  ("lineitem", "l_tax"), ("dict_ints", "k")]
DELTA_PAGES, DELTA_VALUES_PER_PAGE = 2000, 1000
# the sharded paths' second scale: four ranks share the card
SHARD_ROWS, SHARD_RANKS, FAILED_RANK = 500_000, 4, 2
CHILD_TIMEOUT_S = 420
BENCH_TIMEOUT_S = 600  # the benchmark program at --quick, builds included
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
L_COMMENT_CHUNKS = 18767  # chunks of the 2M-row l_comment at 4096 bytes
# patterns outside the register-machine family: K3 walks their table DFA
TABLE_PATTERNS = ["(furiously|carefully) (express|regular)+ (deposits|requests)",
                  "(ly )+requests", "[a-z]+ly (final|bold)+ "]
# the multi-device dry run on the card: two gloo ranks that share it, and
# the reference's line at two devices (`__graft_entry__.dryrun_multichip(2)`,
# to which tests/test_torch_dryrun.py holds the port's), with its notes of
# the sections that need pyarrow
DRYRUN_RANKS = 2
DRYRUN_LINE = (
    "dryrun_multichip(2): scan totals=[134, 211] exchange=211 entries across "
    "6 chunks (skew 1.12); skewed fixture: byte skew 1.00, capacity ratio "
    "1.02; elastic recovery ok (reran 2 pages); sharded decode checksum "
    "345280; {nested}; {delta}; sub-meshes: n/a — OK")
# a table-DFA pattern no query has seen: K3's table is data, so its first
# query builds nothing
COLD_TABLE_PATTERN = "(slyly|quickly) (pending|final)+ (packages|accounts)"
K1_SOURCE = "duckdb_parquet_parser_tpu_torch/csrc/stream_matcher.cu.in"
K2_SOURCE = "duckdb_parquet_parser_tpu_torch/csrc/dict_lookup.cu"
K3_SOURCE = "duckdb_parquet_parser_tpu_torch/csrc/dfa_walk.cu"
K1_REPLACES = "duckdb_parquet_parser_tpu/ops/pallas/stream_matcher.py:94"
K2_REPLACES = "duckdb_parquet_parser_tpu/ops/pallas/dict_lookup.py:85"
# no Pallas kernel: the matrix-unit transition inside the page walk's
# lax.scan (ops/strings.py::_match_stream_multi) and ops/scan.py::dfa_match
K3_REPLACES = "duckdb_parquet_parser_tpu/ops/mxu_dfa.py:178"


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




# The work of K1's walk (csrc/stream_matcher.cu.in) beside the transition
# its IR needs, one machine instruction each, as the template states it:
# each byte of a chunk, walked unrolled ...
K1_PAGE_OPS_PER_BYTE = {
    "take the byte out of the chunk": (1, "int32"),
    "the byte's bits of the chunk's two masks": (2, "int32"),
}
# ... where the tuple's byte half is a table (stream_matcher.table_words),
# the IR's state half alone and, for the byte half, the table's address
# (the loads of the tuple's words share it; a load is memory, not an
# operation) and, for each word, its move from the registers it was loaded
# into a chunk ahead ...
K1_TABLE_OPS_PER_BYTE = {"the table's address, 4 * byte": (1, "fma")}
K1_TABLE_OPS_PER_WORD = (1, "fma")
# ... for each state register, keep it inside a value and 0 outside (an AND
# with the byte's mask); for each pattern, add its accept where the byte
# ends a value ...
K1_PAGE_OPS_PER_REGISTER = (1, "int32")
K1_PAGE_OPS_PER_PATTERN = (1, "fma")
# ... once a chunk: the chunk after next (its test and address) and the
# test of the value's end against the chunk ...
K1_PAGE_OPS_PER_CHUNK = {
    "the chunk after next: its test and address": (3, "fma"),
    "the value's end against the chunk": (1, "int32"),
}
# ... and once a value: its end (its bytes' and last byte's masks, its
# count) and the next value's prefix (read from two chunks)
K1_PAGE_OPS_PER_VALUE = {
    "the value's bytes in the chunk as a mask, or it in": (5, "int32"),
    "its last byte's bit, or it in": (2, "int32"),
    "a zero length?, count the value": (2, "fma"),
    "the lane's tests: nn values seen, the next prefix inside the walk": (
        2, "int32"),
    "take the 4-byte prefix out of two chunks (pick the words, shift)": (
        3, "int32"),
    "the value's first byte and end, the bytes left to the walk's end": (
        3, "fma"),
    "the value ends inside the walk": (1, "int32"),
}


_LOGIC = ("and", "or", "xor")


def ir_ops(irs) -> dict:
    """What the IR of the pattern tuple `irs` needs a byte as K1 walks it:
    `nodes` (the IR nodes that compute, one operation each; where the
    tuple's byte half is a table, `table_words` of them a byte, those of
    the state half alone, `bitprog.byte_only` left out); `fused`, those one
    three-input logic instruction (LOP3) does with the node that uses them:
    the single-use `and` with a constant under a zero test (LOP3 with a
    predicate out), and a single-use logic node under another where the two
    take at most three inputs; `either_pipe`, the adds, subtractions and
    left shifts (all by a constant), which the multiply-add pipe can take
    (IMAD.IADD, IMAD.SHL)."""
    from duckdb_parquet_parser_tpu_torch.ops import bitprog
    from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher

    words = stream_matcher.table_words(irs)
    out = {"nodes": 0, "fused": 0, "either_pipe": 0, "table_words": words}
    for ir in irs:
        table = bitprog.byte_only(ir) if words else [False] * len(ir.nodes)
        computes = {i: (op, args) for i, (op, _kind, args)
                    in enumerate(ir.nodes)
                    if op not in ("const", "input") and not table[i]}
        uses: dict = {}
        for op, args in computes.values():
            # a shift's second argument is its amount, not a node
            for a in args[:1] if op in ("shl", "shr") else args:
                uses[a] = uses.get(a, 0) + 1
        out["nodes"] += len(computes)
        inputs: dict = {}  # a logic node: the inputs of its LOP3
        for i, (op, args) in computes.items():  # in order: args come first
            if op in ("shl", "add", "sub"):
                out["either_pipe"] += 1
                continue
            const = [ir.nodes[a][0] == "const" for a in args]
            if op in ("ne", "eq"):
                zero = any(c and ir.nodes[a][2] == (0,)
                           for a, c in zip(args, const))
                out["fused"] += zero and any(
                    computes.get(a, ("",))[0] == "and" and uses[a] == 1
                    and any(ir.nodes[b][0] == "const" for b in ir.nodes[a][2])
                    for a in args)
            elif op in _LOGIC:
                inputs[i] = set(args)
                for a in args:
                    if a in inputs and uses[a] == 1 and computes[a][0] in _LOGIC:
                        merged = inputs[a] | (set(args) - {a})
                        if len(merged) <= 3:
                            inputs[i] = merged
                            out["fused"] += 1
                            break
    return out


def step_ops(irs) -> dict:
    """The work of K1's walk for the pattern tuple `irs`: `per_byte`, what
    a byte of a chunk needs (the IR's operations: `nodes` less those `fused`
    into a LOP3 with their user, the `either_pipe` ones on either pipe;
    `ir_ops`; then K1_PAGE_OPS_PER_BYTE, K1_TABLE_OPS_PER_BYTE where the
    byte half is a table and K1_TABLE_OPS_PER_WORD for each of its words,
    K1_PAGE_OPS_PER_REGISTER for each
    state register and K1_PAGE_OPS_PER_PATTERN for each pattern),
    `per_chunk` (K1_PAGE_OPS_PER_CHUNK) and `per_value`
    (K1_PAGE_OPS_PER_VALUE), each on the int32 lanes, or half of all where
    that is more (`needed_ops`).  Beside it: `c_ops` (C operators of a
    byte's step in the emitted chunk walk: the operator tokens of the
    unrolled loop's body, comments and preprocessor lines left out; a `?:`
    select counts once, casts and assignments do not count) and, where the
    toolkit has a disassembler, what the compiler made of the chunk loop
    (the loop that holds the chunk's load, and the table's where there is
    one): `registers`, `spill_bytes`, `instructions` and `int32_ops`
    (those the int32 lanes execute: all but the multiply-add pipe's, the
    loads and stores and the branches), for its 16 byte steps and its
    value boundaries together."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        build,
        stream_matcher,
    )

    src = stream_matcher.render([irs], host=True)
    body = src[src.index("for (int j = 0; j < 16; ++j) {"):
               src.index("c0 += 16;")]
    code = "\n".join(ln.split("//")[0] for ln in body.splitlines()
                     if not ln.lstrip().startswith("#"))
    ir = ir_ops(irs)
    n_regs = sum(x.n_regs for x in irs)
    per_byte = {"the IR's logic, compares and selects, LOP3-fused": (
                    ir["nodes"] - ir["fused"] - ir["either_pipe"], "int32"),
                "the IR's adds and constant shifts": (ir["either_pipe"],
                                                      "fma"),
                **K1_PAGE_OPS_PER_BYTE,
                **(K1_TABLE_OPS_PER_BYTE if ir["table_words"] else {}),
                "hold each table word a chunk": (
                    ir["table_words"] * K1_TABLE_OPS_PER_WORD[0],
                    K1_TABLE_OPS_PER_WORD[1]),
                "keep each state register": (
                    n_regs * K1_PAGE_OPS_PER_REGISTER[0],
                    K1_PAGE_OPS_PER_REGISTER[1]),
                "add each pattern's accept": (
                    len(irs) * K1_PAGE_OPS_PER_PATTERN[0],
                    K1_PAGE_OPS_PER_PATTERN[1])}
    out = {**ir, "registers_of_state": n_regs,
           "c_ops": len(_C_OPERATOR.findall(code)),
           "per_byte": needed_ops(per_byte),
           "per_chunk": needed_ops(K1_PAGE_OPS_PER_CHUNK),
           "per_value": needed_ops(K1_PAGE_OPS_PER_VALUE),
           "counted": "operations the IR needs a byte and the boundary "
                      "control a byte, a chunk and a value"}
    if build.disassembler() is not None:
        # the chunk loop: the one with the table's loads where there is a
        # table (the block's copy of it loops over a global load too)
        chunk = "LDS" if ir["table_words"] else "LDG"
        (name, info), = [
            kv for kv in build.inspect_source(
                stream_matcher.render([irs]), loop_containing=chunk).items()
            if f"dpq_stream_{stream_matcher.tag_of(irs)}" in kv[0]]
        loop = info["loop_instructions"]
        total = sum(loop.values())
        int32 = total - sum(n for op, n in loop.items()
                            if op in FMA_PIPE + SLOT_ONLY + MEMORY_OPS)
        out.update(registers=info["registers"],
                   spill_bytes=info["spill_bytes"], instructions=total,
                   int32_ops=int32)
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


def check_stream_kernel_edges(device):
    """K1 vs its plain version at the edges of its 16-byte chunks: every
    lane of tests/page_edges.py's PAGE_EDGES (prefixes straddling two
    chunks, values ending on byte 15, runs of zero-length values, values of
    1-3 bytes several a chunk, `plen` and `nn` mid-chunk, bit-31 lengths,
    empty lanes) in one launch, under each cut of `steps`, for a bitprog
    pattern, a bitap chain and a fused tuple.  Exact equality."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher
    from tests.page_edges import (
        K1_EDGE_WALKS,
        PAGE_EDGE_STEPS,
        PAGE_EDGES,
        k1_edge_irs,
        page_edge,
    )

    pm, plen, nn = page_edge(list(PAGE_EDGES))
    pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(device)
    chunked = stream_matcher.chunk_stream(pt)
    pl = torch.from_numpy(plen).to(device)
    nv = torch.from_numpy(nn).to(device)
    walks = {w: k1_edge_irs(w) for w in K1_EDGE_WALKS}
    stream_matcher.prepare(list(walks.values()))
    for walk, irs in walks.items():
        for steps in PAGE_EDGE_STEPS:
            h1, s1 = stream_matcher.match_stream(chunked, pl, nv, irs, steps)
            h0, s0 = stream_matcher.match_stream_plain(pt, pl, nv, irs, steps)
            if not (torch.equal(h1, h0) and torch.equal(s1, s0)):
                raise AssertionError(f"K1 disagrees with its plain version at "
                                     f"the chunk edges: {walk}, steps {steps}")
    log(f"K1 vs plain at the chunk edges: {len(plen)} lanes of "
        f"{len(PAGE_EDGES)} edges x {len(PAGE_EDGE_STEPS)} cuts of steps x "
        f"{len(walks)} walks ({', '.join(walks)}), exact")


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
    host scan (an independent C++ implementation); (hits, pruned pages)."""
    import numpy as np

    from duckdb_parquet_parser_tpu_torch.bench import hold_counts

    ref = eng.cold_scan(column, pattern, negate=negate, exact_counts=True,
                        stats_prune=False)
    hold_counts(f"{column} ~ {pattern!r} (negate={negate})", res.page_gid,
                res.match_counts, ref, res.value_counts)
    return int(np.sum(res.match_counts)), int(np.sum(res.match_counts == 0))


NOT_PROFILED = ("not measured: the profiler recorded no device events in "
                "three tries")


def device_profile(fn, trace: Path, cpu: bool = True, launches: int = 0):
    """One call of `fn` under torch.profiler after a warm-up: (wall ms
    under the profiler, device busy ms, kernel launches, {kernel: ms}).
    Busy is the union of kernel / memcpy / memset intervals in the
    exported trace.  The profiler now and then loses one profile's device
    events, so a profile without any is tried again, three in all; busy is
    None when all three recorded none.  A profile is a measurement: the
    run's checks (results, launch counters) do not hang on it.  `cpu=False`
    records the device's activity only (a call of tens of thousands of
    launches); a profile that shows fewer than `launches` kernels lost some
    and is tried again too."""
    fn()
    for _ in range(3):
        found = _profile_once(fn, trace, cpu)
        if found[1] is not None and found[2] >= launches:
            break
    return found


def _profile_once(fn, trace: Path, cpu: bool = True):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
    from duckdb_parquet_parser_tpu_torch.utils import tracing

    t0 = time.perf_counter()
    path = fx.lineitem(fixtures / f"lineitem_{rows}.parquet", rows)
    dpath = fx.dict_strings(
        fixtures / f"dict_cities_{dict_rows_per_rg}_{dict_distinct}.parquet",
        rows_per_rg=dict_rows_per_rg, n_rg=4, distinct=dict_distinct)
    log(f"fixtures ready in {time.perf_counter() - t0:.1f} s")
    eng = ScanEngine(str(path))
    deng = ScanEngine(str(dpath))
    stream_matcher.launches = 0
    stream_matcher.table_launches = 0
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
    # every pattern of the path has its byte half in a table: each K1
    # launch counts in table_launches, and in k1_table_launches while a
    # profiler records
    if stream_matcher.table_launches != stream_matcher.launches:
        raise AssertionError(f"{stream_matcher.table_launches} of "
                             f"{stream_matcher.launches} K1 launches read "
                             "the byte half's table")
    k1, counted = stream_matcher.launches, tracing.counters().get(
        "k1_table_launches", 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        col.scan(BENCH_PATTERNS[0], negate=True)
    counted = tracing.counters().get("k1_table_launches", 0) - counted
    if counted != stream_matcher.launches - k1 or counted < 1:
        raise AssertionError(f"k1_table_launches counted {counted} of "
                             f"{stream_matcher.launches - k1} K1 launches")
    log(f"K1 launches on the main path: {k1}, each with its byte half from "
        f"the table (table_launches {stream_matcher.table_launches - counted}"
        f"); a traced query: k1_table_launches {counted} of {counted} "
        "launches")
    return report, launches, col, dcol, eng, deng


def reset_launches() -> None:
    """Sets every wrapper's launch counter to 0."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dfa_walk,
        dict_lookup,
        stream_matcher,
    )

    stream_matcher.launches = 0
    dict_lookup.launches = 0
    dfa_walk.launches = 0


def best_of(fns: dict, reps: int, rounds: int = 6) -> dict:
    """{name: least ms per call} over `rounds` rounds that time each of
    `fns` in turn, so neighbours on the card's host disturb all alike.
    These calls cost what the host spends on a launch, and that switches
    between two levels within seconds, whatever the process did before
    (utils/probe_launch_cost.py), so the slowest round is logged beside
    the least."""
    best = {name: float("inf") for name in fns}
    worst = {name: 0.0 for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            ms = timed(fn, reps)[0]
            best[name] = min(best[name], ms)
            worst[name] = max(worst[name], ms)
    log(f"{rounds} rounds of {reps} calls, least-slowest round: "
        + ", ".join(f"{name} {best[name]:.4f}-{worst[name]:.4f} ms"
                    for name in fns))
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
    chunks = int(((active + 15) // 16).sum())
    k1 = None
    for pats in ([BENCH_PATTERNS[0]], [BENCH_PATTERNS[3]],
                 BENCH_PATTERNS[:3]):
        irs = tuple(strings.pattern_ir(p) for p in pats)
        args = (bk["walk_plen"], bk["walk_nn"], irs, bk["steps"])
        ms, (h1, s1) = timed(
            lambda: stream_matcher.match_stream(bk["stream"], *args), 20)
        values = int(s1.sum())
        ops = step_ops(irs)
        n_ops = (ops["per_byte"] * walked + ops["per_chunk"] * chunks
                 + ops["per_value"] * values)
        n_bytes = walked + 8 * n + 4 * (len(irs) + 1) * n
        b_ms, b_by = bound(n_bytes, n_ops, ops_per_s)
        made = ("" if "instructions" not in ops else
                f"; the compiled chunk loop (16 byte steps and the value "
                f"boundaries) is {ops['instructions']} machine instructions, "
                f"{ops['int32_ops']} of them on the int32 lanes "
                f"({ops['instructions'] / 16:.1f} / "
                f"{ops['int32_ops'] / 16:.1f} a byte), {ops['registers']} "
                f"registers, {ops['spill_bytes']} spill bytes")
        half = ("" if not ops["table_words"] else
                f" of the state half, the byte half's {ops['table_words']} "
                f"word(s) from the table ({K1_TABLE_OPS_PER_BYTE}, a "
                f"word's move {K1_TABLE_OPS_PER_WORD})")
        log(f"K1 {pats} at {tuple(bk['stream'].shape)} u8, K={len(irs)}: "
            f"kernel {ms:.4f} ms per call; {walked} bytes walked in {chunks} "
            f"chunks, {values} values; the walk needs {ops['per_byte']:g} "
            f"int32 operations a byte ({ops['nodes']} IR nodes{half}, "
            f"{ops['fused']} of them fused into a LOP3 with their user, "
            f"{ops['either_pipe']} adds and constant shifts that the "
            "multiply-add pipe may take, the byte's control "
            f"{K1_PAGE_OPS_PER_BYTE}, {ops['registers_of_state']} state "
            f"registers kept, {len(irs)} accepts added), "
            f"{ops['per_chunk']:g} a chunk and {ops['per_value']:g} a value "
            f"({K1_PAGE_OPS_PER_CHUNK}, {K1_PAGE_OPS_PER_VALUE}); the "
            f"emitted byte step is {ops['c_ops']} C operators{made}; "
            f"{n_bytes} bytes moved: bound {b_ms:.4f} ms by {b_by}; the "
            f"bound is {100 * b_ms / ms:.1f}% of the kernel's time")
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
        f"6 rounds of 200); {cells} cells, {n_bytes} bytes moved: bound "
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
        f"plane[gidx.long()] {t['library']:.4f} ms per call (least of 6 "
        f"rounds of 200); {g_bytes} bytes moved: bound {g_ms:.5f} ms by "
        f"{g_by}")
    k2.update(library_ms=t["library"], gather_ms=t["kernel"],
              gather_plain_ms=t["plain"], gather_bound_ms=g_ms,
              library_call="plane[gidx.long()], beside gather_ms")
    return k1, k2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def profile_line(label: str, fn) -> str:
    """One call of `fn` under torch.profiler: its kernel launches, device
    busy time and the kernels that took most of it."""
    _wall, busy, n, by_name = device_profile(
        fn, ROOT / "build" / "profile" / f"{label}.json")
    if busy is None:
        return NOT_PROFILED
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return (f"{n} kernel launches, {busy:.4f} ms device busy under the "
            "profiler; top: "
            + "; ".join(f"{k[:40]} {v:.4f} ms" for k, v in top))


def same_column(label, values, valid, ref):
    """A decoded column against `read_column`'s: the validity, and the
    values compared as integers (never as floats: NaN payloads and -0.0
    must survive)."""
    import numpy as np

    a, b = np.asarray(values), np.asarray(ref.values)
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{label}: {a.dtype}{a.shape} decoded, "
                             f"{b.dtype}{b.shape} read")
    view = {1: np.uint8, 4: np.int32, 8: np.int64}[a.dtype.itemsize]
    if not (np.array_equal(np.asarray(valid), np.asarray(ref.valid))
            and np.array_equal(a.view(view), b.view(view))):
        raise AssertionError(f"{label} differs from the native column sweep")


def flatten_planes(batch, planes, nonnull):
    """(values, valid) of a decoded batch, page-major, as
    `_materialize_fixed` flattens them."""
    from duckdb_parquet_parser_tpu_torch.host.reader import _flatten_decoded

    col = _flatten_decoded(batch, planes, nonnull)
    return col.values, col.valid


def run_decode_path(device, rows, fixtures: Path, ops_per_s):
    """The decode path at the benchmark's scale: each column is prescanned,
    uploaded once, decoded on the card by `decode_fixed_device` and by
    `_materialize_fixed`, and held bit for bit against `read_column` (the
    native PS_COLUMN sweep).  Returns the dictionary column's lookup inputs
    (`table`, `gidx`) and the launches of both kernels in one decode of it,
    read from the wrappers' counters around that decode."""
    import torch

    from duckdb_parquet_parser_tpu_torch.host.reader import (
        ParquetReader,
        _materialize_fixed,
    )
    from duckdb_parquet_parser_tpu_torch.bench import launches_of
    from duckdb_parquet_parser_tpu_torch.ops import decode
    from duckdb_parquet_parser_tpu_torch.utils import fixtures as fx

    t0 = time.perf_counter()
    paths = {
        "lineitem": fx.lineitem(fixtures / f"lineitem_{rows}.parquet", rows),
        "dict_ints": fx.dict_ints(fixtures / f"dict_ints_{rows}.parquet",
                                  rows)}
    log(f"decode fixtures ready in {time.perf_counter() - t0:.1f} s")
    lookup_inputs = None  # of the dictionary column, for the kernel timing
    for fixture, col in DECODE_COLUMNS:
        label = f"decode {col}"
        reader = ParquetReader(str(paths[fixture]))
        if (reader.num_rows() != rows
                or reader.num_row_groups() != -(-rows // 500_000)):
            raise AssertionError(f"{fixture}: {reader.num_rows()} rows in "
                                 f"{reader.num_row_groups()} row groups")
        t0 = time.perf_counter()
        ref = reader.read_column(col)
        read_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        batch = reader.prescan(col)
        prescan_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core, plain, table, bits = decode.upload_fixed(
            batch.arrays, batch.plain_planes, batch.dict_planes,
            batch.bool_bits, device)
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3
        kw = dict(max_def=batch.max_def, out_len=batch.vmax,
                  nn_len=batch.nn_cap, mode=batch.mode, device=device)
        _, counted = launches_of(lambda: decode.decode_fixed_device(
            core, plain, table, bits, **kw))
        per_decode = counted["dict_lookup"]
        if per_decode != (1 if batch.mode != "plain" else 0):
            raise AssertionError(f"{label}: {per_decode} dictionary-kernel "
                                 f"launches in one {batch.mode} decode")
        if counted["stream_matcher"] != 0:
            raise AssertionError(f"{label}: the stream matcher was launched "
                                 f"{counted['stream_matcher']} times in a "
                                 "decode")
        # three rounds of 3 calls after a warm-up: the decode is a dozen
        # eager launches, so a round on a busy host, or one in which the
        # caching allocator still calls cudaMalloc, reads several times the
        # least; both are printed, with the cudaMalloc calls
        # made while timing
        mallocs = torch.cuda.memory_stats()["num_device_alloc"]
        times = []
        for _ in range(3):
            t, (planes, nonnull) = timed(lambda: decode.decode_fixed_device(
                core, plain, table, bits, **kw), 3)
            times.append(t)
        ms, worst = min(times), max(times)
        mallocs = torch.cuda.memory_stats()["num_device_alloc"] - mallocs
        same_column(label, *flatten_planes(batch, planes, nonnull), ref)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = _materialize_fixed(batch, device=device)
        mat_ms = (time.perf_counter() - t0) * 1e3
        same_column(f"_materialize_fixed {col}", got.values, got.valid, ref)
        # what one decode must move: the planes it reads, once, and the
        # planes and the validity it writes, once
        if batch.mode == "plain":
            read = nbytes(*plain, core["page_num_values"]) + (
                nbytes(core["def_levels"]) if batch.max_def > 0 else 0)
        else:
            read = nbytes(core["idx_vals"], core["page_dict_base"],
                          core["page_dict_size"], table)
        moved = read + nbytes(*planes, nonnull)
        b_ms, _by = bound(moved, 0, ops_per_s)
        uploaded = nbytes(*core.values(), *plain,
                          *([table] if len(table) else []),
                          *([] if bits is None else [bits]))
        log(f"{label} ({batch.type.name}, max_def {batch.max_def}, mode "
            f"{batch.mode}, {batch.n_pages} pages x {batch.vmax}): "
            f"{ms:.4f} ms per decode on the card (least of 3 rounds of 3 "
            f"calls; the slowest round {worst:.4f} ms, {mallocs} cudaMalloc "
            "allocations while timing), "
            f"{rows / ms * 1e3:.4g} rows/s, {per_decode} dictionary-kernel "
            f"launch(es); {moved} bytes "
            f"must move: bound {b_ms:.4f} ms ({100 * b_ms / ms:.1f}% of the "
            f"decode); upload {upload_ms:.1f} ms for {uploaded} bytes, host "
            f"prescan {prescan_ms:.1f} ms; _materialize_fixed on the card "
            f"{mat_ms:.1f} ms, read_column (native host sweep) {read_ms:.1f} "
            "ms; all equal bit for bit")
        log(f"profile {label}: " + profile_line(
            f"decode_{col}", lambda: decode.decode_fixed_device(
                core, plain, table, bits, **kw)))
        if col == "k":
            wall, busy, n, _by_name = device_profile(
                lambda: _materialize_fixed(batch, device=device),
                ROOT / "build" / "profile" / "materialize_k.json")
            log("profile _materialize_fixed(k) on the card: " + (
                NOT_PROFILED if busy is None else
                f"wall {wall:.3f} ms, device busy {busy:.4f} ms "
                f"({100 * (1 - busy / wall):.2f}% idle), {n} kernel launches"))
            dn = table.shape[1]
            idx = decode.fit_columns(core["idx_vals"], batch.vmax, -1).to(
                torch.int32)
            gidx = (core["page_dict_base"][:, None] + idx.clamp(min=0)).clamp(
                0, dn - 1).to(torch.int32).contiguous()
            lookup_inputs = {"table": table, "gidx": gidx,
                             "launches": counted}
    return lookup_inputs


def queued_ms(fn, reps: int = 50) -> float:
    """ms per call of `fn` on the card alone: the calls are enqueued behind
    a few ms of other work (three 8192-wide half-precision products), so
    the host runs ahead, its launch cost hides, and the time between the
    two events is the device's."""
    import torch

    a = torch.ones(8192, 8192, device="cuda", dtype=torch.float16)
    b = torch.empty_like(a)
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        torch.mm(a, a, out=b)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_decode_lookup(table, gidx, ops_per_s, prefix="decode",
                       where="inside the decode of k") -> dict:
    """K2's gather entry at a caller's shape (the dictionary decode's, the
    index build's emission decode's) beside its plain version, the one
    PyTorch call and its bound; the keys carry `prefix`."""
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import dict_lookup

    t = best_of({
        "kernel": lambda: dict_lookup.dict_lookup(table, gidx),
        "library": lambda: table[:, gidx.long()],
        "plain": lambda: dict_lookup.dict_lookup_plain(table, gidx)}, 50)
    got = dict_lookup.dict_lookup(table, gidx)
    err = int((got - dict_lookup.dict_lookup_plain(table, gidx)).abs().max())
    on_card = min(queued_ms(lambda: dict_lookup.dict_lookup(table, gidx))
                  for _ in range(3))
    moved = nbytes(table, gidx, got)
    b_ms, b_by = bound(moved, gidx.numel() * table.shape[0], ops_per_s)
    log(f"K2 gather entry {where}, gidx {tuple(gidx.shape)}, "
        f"P={table.shape[0]}, DN={table.shape[1]}: kernel "
        f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, the PyTorch call "
        f"table[:, gidx.long()] {t['library']:.4f} ms per call (least of 6 "
        f"rounds of 50); on the card alone {on_card:.4f} ms per call (50 "
        f"calls queued behind other work, least of 3); {moved} bytes moved: "
        f"bound {b_ms:.5f} ms by {b_by} ({100 * b_ms / t['kernel']:.1f}% of "
        f"a call, {100 * b_ms / on_card:.1f}% of the time on the card)")
    return {f"{prefix}_shape": f"gidx {list(gidx.shape)}, "
                               f"P={table.shape[0]}, DN={table.shape[1]}",
            f"{prefix}_max_abs_err": err, f"{prefix}_ms": t["kernel"],
            f"{prefix}_device_ms": on_card,
            f"{prefix}_plain_ms": t["plain"],
            f"{prefix}_library_ms": t["library"],
            f"{prefix}_bound_ms": b_ms, f"{prefix}_bound_by": b_by}


def check_small_decodes(device, fixtures: Path):
    """Device decode against CPU decode on a few thousand small pages:
    boolean bits, mixed PLAIN / dictionary pages, a dictionary page with
    out-of-range indices and a narrow index plane, a REQUIRED dictionary
    column, each with materialized planes and with PS_RUNS_ONLY run
    expansion.  Exact equality."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.host import bindings
    from duckdb_parquet_parser_tpu_torch.host.reader import ParquetReader
    from duckdb_parquet_parser_tpu_torch.host.schema import ParquetType
    from duckdb_parquet_parser_tpu_torch.host.writer import (
        ColumnSpec,
        ParquetWriter,
    )
    from duckdb_parquet_parser_tpu_torch.ops import decode

    path = fixtures / "small_decodes.parquet"
    if not path.exists():
        rng = np.random.default_rng(17)
        w = ParquetWriter(str(path), [
            ColumnSpec("flag", ParquetType.BOOLEAN, optional=True),
            ColumnSpec("v", ParquetType.INT64, optional=True),
            ColumnSpec("code", ParquetType.INT32),
            ColumnSpec("f", ParquetType.DOUBLE, optional=True)])
        for rg in range(12):
            n = int(rng.integers(4000, 9000))
            valid = (rng.random(n) > 0.15).astype(np.uint8)
            v = (rng.integers(0, 9, n) * 1_000_003 if rg % 2 == 0
                 else rng.integers(-(2**62), 2**62, n))   # dictionary / PLAIN
            w.write_row_group({
                "flag": (rng.random(n) > 0.5, valid),
                "v": (v, valid),
                "code": np.asarray(rng.choice([7, 11, 13, 17], n), np.int32),
                "f": (rng.standard_normal(n), valid)})
        w.close()
    # the writer dictionary-encodes a column chunk with few distinct values,
    # so PLAIN boolean pages (packed bits) come from row groups of 8 rows
    bits_path = fixtures / "small_bool_bits.parquet"
    if not bits_path.exists():
        rng = np.random.default_rng(19)
        w = ParquetWriter(str(bits_path), [
            ColumnSpec("bits", ParquetType.BOOLEAN, optional=True)])
        for _rg in range(600):
            w.write_row_group({"bits": (rng.random(8) > 0.5,
                                        (rng.random(8) > 0.1).astype(np.uint8))})
        w.close()
    readers = {c: ParquetReader(str(path)) for c in ("flag", "v", "code", "f")}
    readers["bits"] = ParquetReader(str(bits_path))

    def both(batch, arrays):
        kw = dict(max_def=batch.max_def, out_len=batch.vmax,
                  nn_len=batch.nn_cap, mode=batch.mode)
        args = (arrays, batch.plain_planes, batch.dict_planes, batch.bool_bits)
        return (decode.decode_fixed_device(*args, **kw, device=device),
                decode.decode_fixed_device(*args, **kw, device="cpu"))

    n_cases = n_pages = 0
    modes = set()
    rng = np.random.default_rng(18)
    for col, reader in readers.items():
        for flags in (0, bindings.PS_RUNS_ONLY):
            batch = reader.prescan(col, flags=flags)
            if col == "bits" and batch.bool_bits is None:
                raise AssertionError("the boolean fixture has no PLAIN page")
            cases = [("", batch.arrays)]
            if col == "code" and flags == 0:
                idx = np.array(batch.arrays["idx_vals"])
                hit = rng.random(idx.shape) < 0.05
                idx[hit] = rng.choice([4, 5, 100, 30000], int(hit.sum()))
                cases += [(" with out-of-range indices",
                           {**batch.arrays, "idx_vals": idx}),
                          (" with a narrow index plane",
                           {**batch.arrays, "idx_vals": idx.astype(np.int16)})]
            for what, arrays in cases:
                (gp, gn), (wp, wn) = both(batch, arrays)
                if not (torch.equal(gn.cpu(), wn) and len(gp) == len(wp)
                        and all(torch.equal(a.cpu(), b)
                                for a, b in zip(gp, wp))):
                    raise AssertionError(
                        f"decode of {col}{what} (flags {flags}) on the card "
                        "differs from the CPU's")
                tampered = np.zeros(tuple(gn.shape), bool)
                if what:
                    w = min(hit.shape[1], tampered.shape[1])
                    tampered[:, :w] = hit[:, :w]
                if bool(gn.cpu().numpy()[tampered].any()):
                    raise AssertionError("an out-of-range index decoded to a "
                                         "value")
                n_cases += 1
                n_pages += batch.n_pages
            modes.add((col, batch.mode))
    if not ({("flag", "dict"), ("v", "mixed"), ("code", "dict"),
             ("f", "plain")} <= modes
            and modes & {("bits", "plain"), ("bits", "mixed")}):
        raise AssertionError(f"small decodes covered {sorted(modes)}")
    log(f"small decodes, card vs CPU: {n_cases} cases over {n_pages} pages "
        "(boolean bits, mixed PLAIN / dictionary pages, out-of-range and "
        "narrow indices, REQUIRED dictionary, run expansion), exact")


def run_delta(device, ops_per_s):
    """`decode_delta_planes` on the card over 2M seeded values (miniblock
    widths 0-64, int64 wrap) equals the values they were packed from."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.ops import delta
    from duckdb_parquet_parser_tpu_torch.utils import fixtures as fx

    t0 = time.perf_counter()
    dims, arrays, values, nn = fx.delta_planes(29, DELTA_PAGES,
                                               DELTA_VALUES_PER_PAGE)
    gen_s = time.perf_counter() - t0
    n_values = int(nn.sum())
    if n_values != 2_000_000:
        raise AssertionError(f"the delta fixture holds {n_values} values")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for k, a in arrays.items()}
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    out_len = int(dims["nn_cap"])
    times = []
    for _ in range(3):
        t, planes = timed(
            lambda: delta.decode_delta_planes(dev, dims, out_len, 2), 3)
        times.append(t)
    ms, worst = min(times), max(times)
    lo, hi = (p.cpu().numpy() for p in planes)
    got = (hi.astype(np.int64) << 32) | (lo.astype(np.int64) & 0xFFFFFFFF)
    if not np.array_equal(got, values):
        raise AssertionError("delta decode on the card differs from the "
                             "seed's values")
    widths = sorted(int(b) for b in np.unique(arrays["delta_bw"]))
    if widths[0] != 0 or widths[-1] != 64:
        raise AssertionError(f"delta fixture widths {widths}")
    moved = nbytes(*dev.values(), *planes)
    b_ms, _by = bound(moved, 0, ops_per_s)
    log(f"delta: {n_values} values in {DELTA_PAGES} pages, {len(widths)} "
        f"miniblock widths {widths[0]}-{widths[-1]}: {ms:.4f} ms per decode "
        f"on the card (least of 3 rounds of 3 calls; the slowest round "
        f"{worst:.4f} ms), {n_values / ms * 1e3:.4g} rows/s; {moved} bytes must "
        f"move: bound {b_ms:.4f} ms ({100 * b_ms / ms:.1f}% of the decode); "
        f"upload {upload_ms:.1f} ms, fixture made in {gen_s:.1f} s; equal to "
        "the seed's values")
    log("profile delta: " + profile_line(
        "delta", lambda: delta.decode_delta_planes(dev, dims, out_len, 2)))


def run_block_scans(device, eng, deng, fixtures: Path):
    """`scan_batched` and `scan_streaming` against the native exact scan,
    `matching_rows` on the card against `match_rows` on the CPU, and the
    fused single step against the resident scan."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.bench import launches_of
    from duckdb_parquet_parser_tpu_torch.models.scan import (
        ResidentColumn,
        build_example_batch,
        single_chip_forward,
    )
    from duckdb_parquet_parser_tpu_torch.ops import scan
    from duckdb_parquet_parser_tpu_torch.utils.metrics import get_metrics

    pat = BENCH_PATTERNS[0]
    n_rows = eng.reader.num_rows()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.scan_streaming("l_comment", pat, device=device)
    cold_ms = (time.perf_counter() - t0) * 1e3
    hits, pruned = assert_same(res, eng, "l_comment", pat, False)
    log(f"scan_streaming l_comment ~ {pat!r}, first call on a file that is "
        f"not resident (kernel built before): {cold_ms:.1f} ms, "
        f"{n_rows / cold_ms * 1e3:.4g} rows/s, {hits} hits, {pruned} pages "
        "pruned; equal to native scan page for page")
    for name, fn in (
            ("scan_streaming", lambda **kw: eng.scan_streaming(
                "l_comment", pat, device=device, **kw)),
            ("scan_streaming(block_pages=4096)", lambda **kw:
                eng.scan_streaming("l_comment", pat, block_pages=4096,
                                   device=device, **kw)),
            ("scan_batched", lambda **kw: eng.scan_batched(
                "l_comment", pat, device=device, **kw))):
        for negate in (False, True):
            t0 = time.perf_counter()
            _, launches = launches_of(
                lambda: assert_same(fn(negate=negate), eng, "l_comment", pat,
                                    negate))
            log(f"{name} l_comment ~ {pat!r}{' negate' if negate else ''}: "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms with its check, "
                f"launches {launches}; equal to native scan")
            least = (eng.reader.num_row_groups()
                     if name.startswith("scan_streaming") else 1)
            if launches["stream_matcher"] < least:
                raise AssertionError(f"{name}: the stream matcher ran "
                                     f"{launches['stream_matcher']} times")
    stages = get_metrics().summary()
    prescan, dispatch = stages["prescan"][-1], stages["scan_dispatch"][-1]
    log(f"scan_batched's stages (its own metrics): host prescan "
        f"{prescan['seconds'] * 1e3:.1f} ms for {prescan['pages']} pages; "
        f"dispatch of {dispatch['batches']} blocks "
        f"{dispatch['seconds'] * 1e3:.1f} ms, of which the host's copies "
        f"into the pinned block buffers "
        f"{dispatch['host_copy_seconds'] * 1e3:.1f} ms")
    for name, fn in (("scan_streaming", deng.scan_streaming),
                     ("scan_batched", deng.scan_batched)):
        _, launches = launches_of(lambda: assert_same(
            fn("city", DICT_PATTERNS[0], device=device), deng, "city",
            DICT_PATTERNS[0], False))
        log(f"{name} city ~ {DICT_PATTERNS[0]!r}: launches {launches}; equal "
            "to native scan")
        if launches["dict_lookup"] < 1:
            raise AssertionError(f"{name}: the dictionary kernel did not run")

    t0 = time.perf_counter()
    rows = eng.matching_rows("l_comment", pat, device=device)
    rows_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu_rows = scan.match_rows(eng.reader.prescan("l_comment", pad_strings=8),
                               pat, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(rows, cpu_rows) and len(rows) == hits):
        raise AssertionError("matching_rows on the card differs from "
                             "match_rows on the CPU or from the page counts")
    log(f"matching_rows l_comment ~ {pat!r}: {len(rows)} rows in "
        f"{rows_ms:.1f} ms on the card ({cpu_ms:.1f} ms on the CPU), equal, "
        "and as many as the page scan's matches")

    example = fixtures / "example"
    example.mkdir(parents=True, exist_ok=True)
    reader, batch = build_example_batch(str(example))
    fn, args = single_chip_forward(batch, EXAMPLE_PATTERN, device=device)
    _, launches = launches_of(lambda: fn(*args))
    counts = fn(*args).cpu().numpy()
    want = ResidentColumn(reader, "s", device=device).scan(EXAMPLE_PATTERN)
    if not np.array_equal(counts, want.match_counts):
        raise AssertionError("single_chip_forward differs from the resident "
                             "scan")
    if launches != {"stream_matcher": 1, "dict_lookup": 1, "dfa_walk": 0}:
        raise AssertionError(f"single_chip_forward launched {launches}")
    log(f"single_chip_forward on the example batch ({batch.n_pages} pages): "
        f"{int(counts.sum())} matches, launches {launches}; equal to the "
        "resident scan")


def random_dfa(rng, n_states: int, n_classes: int):
    """A random automaton over `n_classes` byte classes (each one used)."""
    import numpy as np

    from duckdb_parquet_parser_tpu_torch.ops.regex import DFA

    class_of = rng.permutation(np.concatenate([
        np.arange(n_classes), rng.integers(0, n_classes, 256 - n_classes)]))
    table = rng.integers(0, n_states, (n_states, n_classes))[:, class_of]
    return DFA(table.astype(np.int32), rng.random(n_states) < 0.4,
               f"random {n_states}x{n_classes}")


def value_variant(packed, values: bool = True) -> str:
    """The table the wrapper's walk (`values`: the per-value walk, else the
    page walk) holds under `packed`."""
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import dfa_walk

    mode, nbytes = dfa_walk.table_mode(packed, torch.cuda.current_device(),
                                       values)
    return f"{dfa_walk.MODE_NAMES[mode]} ({nbytes} bytes staged)"


# The per-value walk's edges (csrc/dfa_walk.cu: a persistent grid of
# 512-thread blocks whose threads walk every stride-th row in 64-byte
# windows, loads of 16, 8, 4 or 1 bytes): (rows, pitch, lengths, byte offset
# of the first row), as tests/test_torch_dfa_walk.py's VALUE_EDGES.
VALUE_EDGES = [(1, 64, "random", 0), (31, 64, "random", 0),
               (32, 64, "random", 0), (33, 64, "random", 0),
               (511, 64, "random", 0), (512, 64, "random", 0),
               (513, 64, "random", 0), (2049, 64, "random", 0),
               (300_000, 64, "skew", 0),
               (300, 13, "random", 0), (300, 13, "random", 13),
               (300, 64, "random", 1), (300, 64, "random", 8),
               (300, 20, "random", 0), (300, 24, "random", 0),
               (300, 200, "random", 0), (300, 256, "random", 0),
               (1000, 64, "same", 0), (1000, 64, "skew", 0),
               (1000, 256, "skew", 0)]


def check_value_edges(device):
    """K3's per-value walk against its plain version at the edges of its
    blocks, grid, windows and loads (`VALUE_EDGES`), under the pattern's
    folded table, the random 300 x 256 (staged packed, 153,856 bytes) and
    4,096 x 256 (device memory) tables, in every variant that can launch
    and the one the wrapper picks, one launch a call."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import dfa_walk
    from duckdb_parquet_parser_tpu_torch.ops.regex import compile_pattern

    rng = np.random.default_rng(61)
    dfas = [compile_pattern(TABLE_PATTERNS[0]), random_dfa(rng, 300, 256),
            random_dfa(rng, 4096, 256)]
    words = np.frombuffer(b" ".join(
        [b"furiously", b"carefully", b"express", b"regular", b"deposits",
         b"requests", b"slyly", b"final"] * 80), np.uint8)
    n_calls = 0
    for n, pitch, kind, offset in VALUE_EDGES:
        starts = rng.integers(0, len(words) - pitch, n)
        rows = torch.from_numpy(words[starts[:, None] + np.arange(pitch)])
        buf = torch.zeros(offset + n * pitch, dtype=torch.uint8,
                          device=device)
        chars = buf[offset:].view(n, pitch)
        chars.copy_(rows)
        if kind == "same":
            lens = np.full(n, pitch, np.int32)
        elif kind == "skew":
            lens = np.where(rng.random(n) < 0.9, rng.integers(0, 4, n),
                            pitch + 5).astype(np.int32)
        else:
            lens = rng.integers(0, pitch + 10, n).astype(np.int32)
            lens[:2] = [0, pitch + 9][:n]
        ln = torch.from_numpy(lens).to(device)
        for dfa in dfas:
            want = dfa_walk.value_walk_plain(chars, ln, dfa)
            fits = value_stageable(dfa)
            for staged in (None, False) + ((True,) if fits else ()):
                before = dfa_walk.launches
                got = dfa_walk.value_walk(chars, ln, dfa, staged=staged)
                if dfa_walk.launches != before + 1 or not torch.equal(got,
                                                                      want):
                    raise AssertionError(
                        f"K3's per-value walk (staged={staged}) disagrees "
                        f"with its plain version at [{n}, {pitch}], lengths "
                        f"{kind}, offset {offset}, under {dfa.pattern}")
                n_calls += 1
    torch.cuda.synchronize()
    log(f"K3 per-value walk vs plain at {len(VALUE_EDGES)} edge shapes "
        f"(rows 1-300000, pitch 13-256, offsets 0-13, lengths random / same / "
        f"skewed) under 3 tables: {n_calls} calls exact, one launch each")


def check_table_kernels(col, eng, deng, device):
    """(a) K3's page walk against its plain version, bit for bit, in both
    variants (the table staged in shared memory, and read from device
    memory) and in the one the wrapper picks, on both resident l_comment
    buckets and on its split layout
    (256-byte segments) for each table-DFA pattern, and on random pages
    under a random 300-state table of 256 byte classes (153,856 bytes,
    staged above 48 KB when forced) and a 4,096-state one (too large to
    stage: device memory only); (b) its per-value walk against its plain version, in every
    variant, on l_comment's `str_padded` and city's `dict_padded`, under
    the random tables and at the edge shapes
    of its blocks and windows (`check_value_edges`).  Returns the
    str_padded tensors, which (f) times."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.host.batch import to_tensor
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dfa_walk,
        stream_matcher,
    )
    from duckdb_parquet_parser_tpu_torch.ops.regex import compile_pattern
    from duckdb_parquet_parser_tpu_torch.utils.probe_stream_walk import (
        layouts,
    )

    per_block = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    for label, (stream, pl, nv, steps) in layouts(col).items():
        plain_stream = stream_matcher.unchunk_stream(stream, steps)
        for pat in TABLE_PATTERNS:
            dfa = compile_pattern(pat)
            args = (pl, nv, dfa, steps)
            t0 = time.perf_counter()
            h0, s0 = dfa_walk.stream_walk_plain(plain_stream, *args)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            for staged in (None, False, True):
                h1, s1 = dfa_walk.stream_walk(stream, *args, staged=staged)
                if not (torch.equal(h1, h0) and torch.equal(s1, s0)):
                    raise AssertionError(
                        f"K3 (staged={staged}) disagrees with its plain "
                        f"version on {pat!r}, {label}")
            log(f"K3 page walk vs plain on {pat!r} ({dfa.n_states} states, "
                f"{dfa.byte_classes().n_classes} classes; the wrapper picks "
                f"the {value_variant(dfa_walk.pack_table(dfa), False)}) over "
                f"the l_comment {label}: both variants exact, "
                f"{int(h1.sum())} hits ({plain_s:.1f} s for the plain loop)")
        del plain_stream
    rng = np.random.default_rng(53)
    pm, plen, nn = random_pages(rng, 3000, 6, 40, alphabet=bytes(range(256)))
    pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(device)
    pl = torch.from_numpy(plen).to(device)
    nv = torch.from_numpy(nn).to(device)
    chars = torch.from_numpy(rng.integers(0, 256, (20000, 48),
                                          dtype=np.uint8)).to(device)
    lens = torch.from_numpy(rng.integers(0, 60, 20000).astype(np.int32)).to(
        device)
    for n_states, fits in ((300, True), (4096, False)):
        dfa = random_dfa(rng, n_states, 256)
        packed = dfa_walk.pack_table(dfa)
        size = len(packed.data)
        if (size <= per_block) != fits:
            raise AssertionError(f"a {size}-byte table against {per_block} "
                                 "bytes of shared memory a block")
        h0, s0 = dfa_walk.stream_walk_plain(pt, pl, nv, dfa)
        v0 = dfa_walk.value_walk_plain(chars, lens, dfa)
        v_fits = value_stageable(dfa)
        for staged in (None, False, True):
            if not staged or fits:
                h1, s1 = dfa_walk.stream_walk(stream_matcher.chunk_stream(pt),
                                              pl, nv, dfa, staged=staged)
            if not staged or v_fits:
                v1 = dfa_walk.value_walk(chars, lens, dfa, staged=staged)
            if not (torch.equal(h1, h0) and torch.equal(s1, s0)
                    and torch.equal(v1, v0)):
                raise AssertionError(f"K3 (staged={staged}) disagrees with "
                                     f"its plain version under {dfa.pattern}")
        log(f"K3 vs plain under a {dfa.pattern} table ({size} bytes; "
            f"{per_block} bytes of shared memory a block; the wrapper picks "
            f"the {value_variant(packed, False)} for the page walk, the "
            f"{value_variant(packed)} for the per-value "
            f"walk): page walk over {len(plen)} random pages exact in "
            f"{'both variants' if fits else 'device memory'}, per-value walk "
            f"over {tuple(chars.shape)} in "
            f"{'both variants' if v_fits else 'device memory'}, "
            f"{int(h1.sum())} hits, {int(v1.sum())} values accepted")
    check_value_edges(device)

    t0 = time.perf_counter()
    sbatch = eng.reader.prescan("l_comment", pad_strings=8)
    dbatch = deng.reader.prescan("city", pad_strings=8)
    prescan_ms = (time.perf_counter() - t0) * 1e3
    str_chars = to_tensor(sbatch.arrays["str_padded"], device)
    str_lens = to_tensor(sbatch.arrays["str_lens"], device, dtype=np.int32)
    dict_chars = to_tensor(dbatch.arrays["dict_padded"], device)
    dict_lens = to_tensor(dbatch.arrays["dict_lens"], device, dtype=np.int32)
    for label, c, ln, pats in (
            ("l_comment str_padded", str_chars, str_lens, TABLE_PATTERNS),
            ("city dict_padded", dict_chars, dict_lens,
             TABLE_PATTERNS + DICT_PATTERNS[:1])):
        for pat in pats:
            dfa = compile_pattern(pat)
            v0 = dfa_walk.value_walk_plain(c, ln, dfa)
            for staged in (None, False, True):
                v1 = dfa_walk.value_walk(c, ln, dfa, staged=staged)
                if not torch.equal(v1, v0):
                    raise AssertionError(
                        f"K3's per-value walk (staged={staged}) disagrees "
                        f"with its plain version on {label}, {pat!r}")
        log(f"K3 per-value walk vs plain on {label} {tuple(c.shape)}: "
            f"{len(pats)} patterns exact in every variant (last: "
            f"{int(v1.sum())} accepted, the wrapper picks the "
            f"{value_variant(dfa_walk.pack_table(dfa))})")
    log(f"(prescans with pad_strings for the per-value walk: {prescan_ms:.1f} "
        "ms)")
    return str_chars, str_lens


def run_table_dfa_path(col, eng, device):
    """(c) The resident table-DFA queries, plain and negated, against the
    native exact host scan, with K3's launches per query (one a bucket
    with PLAIN pages) and none of K1's; (d) `scan_streaming` and
    `matching_rows` of the first pattern against the native answers;
    (e) one query on a table-DFA pattern never seen, which must build
    nothing.  The caller sets the counters to 0 before and reads them
    after.  Returns the report rows and the launches that the first
    pattern's resident query made.  Also the compiles of the pattern in
    one resident query (1) and in a first and a repeated `scan_streaming`
    (1, then 0: its matchers are cached), each with its ms."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.bench import card_line, launches_of
    from duckdb_parquet_parser_tpu_torch.models import scan as models
    from duckdb_parquet_parser_tpu_torch.ops import scan
    from duckdb_parquet_parser_tpu_torch.ops.kernels import build
    from duckdb_parquet_parser_tpu_torch.utils.probe_compiles import (
        counted_compiles,
    )

    report = []
    n_rows = eng.reader.num_rows()
    want = {"stream_matcher": 0, "dict_lookup": 0,
            "dfa_walk": sum(b["has_plain"] for b in col._buckets)}
    first_query = None  # the launches of the first pattern's query
    for pat in TABLE_PATTERNS:
        res, per_query = launches_of(lambda p=pat: col.scan(p))
        if per_query != want:
            raise AssertionError(f"{pat!r}: one resident query launched "
                                 f"{per_query}, not {want}")
        first_query = first_query or per_query
        hits, pruned = assert_same(res, eng, "l_comment", pat, False)
        ms, _res = timed(lambda p=pat: col.scan(p), 3)
        report.append(("l_comment", pat, False, ms, n_rows, hits, pruned))
        res = col.scan(pat, negate=True)
        n_hits, n_pruned = assert_same(res, eng, "l_comment", pat, True)
        report.append(("l_comment", pat, True, None, n_rows, n_hits,
                       n_pruned))
    pat = TABLE_PATTERNS[0]
    card = card_line()
    with counted_compiles() as compiled:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = col.scan(pat)
        query_ms = (time.perf_counter() - t0) * 1e3
    assert_same(res, eng, "l_comment", pat, False)
    if len(compiled) != 1:
        raise AssertionError(f"one resident query of {pat!r} compiled the "
                             f"pattern {len(compiled)} times, not once")
    log(f"compiles: one resident query l_comment ~ {pat!r}: {len(compiled)} "
        f"compile, {query_ms:.1f} ms ({card})")
    models._streaming_matchers.cache_clear()
    stream = []  # (ms, compiles, launches) of a first and a repeated call
    for _call in range(2):
        with counted_compiles() as compiled:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, launched = launches_of(
                lambda: eng.scan_streaming("l_comment", pat, device=device))
            stream.append(((time.perf_counter() - t0) * 1e3, len(compiled),
                           launched))
        hits, pruned = assert_same(res, eng, "l_comment", pat, False)
        if (launched["dfa_walk"] < eng.reader.num_row_groups()
                or launched["stream_matcher"]):
            raise AssertionError(f"scan_streaming of {pat!r} launched "
                                 f"{launched}")
    stream_ms, _n, launched = stream[0]
    log(f"scan_streaming l_comment ~ {pat!r}: {stream_ms:.1f} ms, launches "
        f"{launched}; equal to native scan")
    log(f"compiles: scan_streaming l_comment ~ {pat!r}: first call "
        f"{stream[0][1]} compile, {stream[0][0]:.1f} ms; repeated call "
        f"{stream[1][1]} compiles, {stream[1][0]:.1f} ms ({card})")
    if [n for _ms, n, _l in stream] != [1, 0]:
        raise AssertionError(f"scan_streaming of {pat!r} compiled the "
                             f"pattern {[n for _ms, n, _l in stream]} times "
                             "in a first and a repeated call, not [1, 0]")
    t0 = time.perf_counter()
    rows = eng.matching_rows("l_comment", pat, device=device)
    rows_ms = (time.perf_counter() - t0) * 1e3
    cpu_rows = scan.match_rows(eng.reader.prescan("l_comment", pad_strings=8),
                               pat, device="cpu")
    if not (np.array_equal(rows, cpu_rows) and len(rows) == hits):
        raise AssertionError(f"matching_rows of {pat!r} on the card differs "
                             "from match_rows on the CPU or from the page "
                             "counts")
    log(f"matching_rows l_comment ~ {pat!r}: {len(rows)} rows in "
        f"{rows_ms:.1f} ms on the card, equal to the CPU's and to the page "
        "scan's matches")
    n_so = len(list(build.BUILD_DIR.glob("*.so")))
    t0 = time.perf_counter()
    res = col.scan(COLD_TABLE_PATTERN)
    cold_ms = (time.perf_counter() - t0) * 1e3
    if len(list(build.BUILD_DIR.glob("*.so"))) != n_so:
        raise AssertionError("a table-DFA pattern's first query built a "
                             "kernel")
    hits, pruned = assert_same(res, eng, "l_comment", COLD_TABLE_PATTERN,
                               False)
    report.append(("l_comment", f"{COLD_TABLE_PATTERN} (cold: first query, "
                   "no nvcc run)", False, cold_ms, n_rows, hits, pruned))
    return report, first_query


@contextlib.contextmanager
def plain_table_walk():
    """Routes the page walk of the table DFA through its plain loop on the
    card (the route before K3), for a "before" reading in the same run."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dfa_walk,
        stream_matcher,
    )

    real = dfa_walk.stream_walk

    def plain(chunked, plen, nn, dfa, steps=None):
        steps = min(int(steps), chunked.shape[0] * stream_matcher.CHUNK)
        return dfa_walk.stream_walk_plain(
            stream_matcher.unchunk_stream(chunked, steps), plen, nn, dfa,
            steps)

    dfa_walk.stream_walk = plain
    try:
        yield
    finally:
        dfa_walk.stream_walk = real


# The operations K3's page walk needs, one machine instruction each, as
# csrc/dfa_walk.cu states it: a value byte of a chunk, walked unrolled
# through the folded table (its load is memory, not an operation) ...
K3_PAGE_OPS_PER_BYTE = {
    "take the byte out of the chunk": (1, "int32"),
    "the next row's address, row + 4 * byte": (1, "fma"),
    "the byte's bit of the chunk's mask": (1, "int32"),
}
# ... and a value's boundary, once a value (the accept's load is memory).
K3_PAGE_OPS_PER_VALUE = {
    "add the accept, count the value": (2, "fma"),
    "the lane's tests: nn values seen, the next prefix inside the walk": (
        2, "int32"),
    "take the 4-byte prefix out of two chunks (pick the words, shift)": (
        3, "int32"),
    "the value's first byte and end, the bytes left to the walk's end": (
        3, "fma"),
    "the value ends inside the walk": (1, "int32"),
    "reset the state": (1, "fma"),
    "the masks of its first and last chunks": (4, "int32"),
}
K3_VALUE_OPS_PER_BYTE = {
    "take the byte out of the chunk": (1, "int32"),
    "the next entry's address, row + 4 * byte": (1, "fma"),
    "the value's length test": (1, "int32"),
}
K3_VALUE_OPS_PER_VALUE = 1  # the accept, read from the last state's row
MEMORY_OPS = ("LDS", "LDG", "LDC", "LD", "LDL", "ULDC", "STS", "STG", "ST",
              "STL")


def needed_ops(table: dict) -> float:
    """The number a bound uses for the operations of `table` (a byte's):
    those on the int32 lanes, or half of all of them where that is more
    (an SM issues 128 lanes a clock, twice its int32 lanes)."""
    total = sum(n for n, _pipe in table.values())
    int32 = sum(n for n, pipe in table.values() if pipe == "int32")
    return max(int32, total / 2)


def loop_ops(kernel: str, variant: str) -> dict:
    """What the compiler made of the innermost loop that loads from shared
    memory in K3's `kernel`, the instance whose mangled template arguments
    are `variant`: machine instructions, the memory ones among them, those
    on the int32 lanes, registers and spills.  A reading beside the bound,
    not its source."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import build

    (name, info), = [kv for kv in build.inspect_source(
        build.read_csrc("dfa_walk.cu"), loop_containing="LDS").items()
        if f"{kernel}{variant}" in kv[0]]
    loop = info["loop_instructions"]
    total = sum(loop.values())
    memory = sum(n for op, n in loop.items() if op in MEMORY_OPS)
    int32 = total - memory - sum(n for op, n in loop.items()
                                 if op in FMA_PIPE + SLOT_ONLY)
    return {"registers": info["registers"], "spill_bytes": info["spill_bytes"],
            "instructions": total, "memory": memory, "int32_ops": int32,
            "opcodes": loop}


def time_variants(walk, dfas: dict, stageable=lambda dfa: True) -> dict:
    """{label: (device-memory ms, staged ms)} of `walk(dfa, staged)` under
    each table of `dfas`, the least of 3 alternating rounds of 10 calls;
    staged ms None where `stageable(dfa)` says the staged variant cannot
    launch."""
    best = {}
    for _ in range(3):
        for label, dfa in dfas.items():
            ms = tuple(timed(lambda st=st: walk(dfa, st), 10)[0]
                       if not st or stageable(dfa) else None
                       for st in (False, True))
            best[label] = tuple(m if b is None else b if m is None
                                else min(b, m)
                                for b, m in zip(best.get(label, ms), ms))
    return best


def value_stageable(dfa) -> bool:
    """Whether the per-value walk's staged variant launches under `dfa`
    (not where its table outgrows a block's shared memory)."""
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import dfa_walk

    index = torch.cuda.current_device()
    mode, nbytes = dfa_walk.value_mode(dfa_walk.pack_table(dfa), index, True)
    return dfa_walk.blocks_per_sm(index, 1 + mode, nbytes) > 0


def time_page_walk(col, dfa, ops_per_s):
    """(f) K3's page walk under `dfa` at the main path's shapes: on both
    l_comment buckets and on the split layout (its pages cut into 256-byte
    segments), per call and on the card alone; on the larger bucket beside
    its plain version and against its bound, counted from the operations
    the walk needs a byte and a value (`K3_PAGE_OPS_PER_BYTE`,
    `K3_PAGE_OPS_PER_VALUE`) and from the bytes it must read; the shared
    loads' floor and the compiled chunk loop beside them.  Returns (the
    kernels line's entry, the larger bucket)."""
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dfa_walk,
        stream_matcher,
    )
    from duckdb_parquet_parser_tpu_torch.utils.probe_stream_walk import (
        layouts,
    )

    dev_index = torch.cuda.current_device()
    packed = dfa_walk.pack_table(dfa)
    mode, staged_bytes = dfa_walk.table_mode(packed, dev_index, False)
    grid = dfa_walk.grid(dev_index, False, mode, staged_bytes)
    bk = max(col._buckets, key=lambda b: b["stream"].numel())
    big = f"bucket {list(bk['stream'].shape)}"
    timings = {}
    for label, (stream, pl, nv, steps) in layouts(col).items():
        def walk():
            return dfa_walk.stream_walk(stream, pl, nv, dfa, steps)

        ms = best_of({"kernel": walk}, 20)["kernel"]
        alone = min(queued_ms(walk, 20) for _ in range(3))
        timings[label] = {"ms": ms, "device_ms": alone}
        log(f"K3 page walk on {label} (n = {stream.shape[1]}, steps "
            f"{steps}): {ms:.4f} ms per call, {alone:.4f} ms on the card "
            "alone")
    args = (bk["walk_plen"], bk["walk_nn"], dfa, bk["steps"])
    plain_stream = stream_matcher.unchunk_stream(bk["stream"], bk["steps"])
    plain_ms, (h0, s0) = timed(
        lambda: dfa_walk.stream_walk_plain(plain_stream, *args), 1)
    del plain_stream
    h1, s1 = dfa_walk.stream_walk(bk["stream"], *args)
    err = max(int((h1 - h0).abs().max()), int((s1 - s0).abs().max()))
    n = bk["walk_plen"].shape[0]
    active = torch.where(bk["walk_nn"] > 0,
                         bk["walk_plen"].clamp(max=bk["steps"]), 0)
    walked = int(active.sum())
    values = int(s0.sum())
    value_bytes = walked - 4 * values  # the prefixes are read, not walked
    per_byte = needed_ops(K3_PAGE_OPS_PER_BYTE)
    per_value = needed_ops(K3_PAGE_OPS_PER_VALUE)
    n_bytes = walked + 16 * n + len(packed.data)
    b_ms, b_by = bound(n_bytes, per_byte * value_bytes + per_value * values,
                       ops_per_s)
    # one shared load a value byte and a value: 32 a clock an SM at best
    # (no two lanes of a warp on one bank), half the int32 lanes' rate
    loads = value_bytes + values
    lds_ms = loads / (ops_per_s / 2) * 1e3
    ops = loop_ops("dfa_stream_kernel", f"ILi{mode}E")
    t = timings[big]
    run = -(-n // grid)  # a block's lanes, as csrc/dfa_walk.cu cuts them
    threads = min(1024, -(-run // 32) * 32)
    log(f"K3 page walk {dfa.pattern!r} at {list(bk['stream'].shape)} u8, "
        f"the wrapper's {dfa_walk.MODE_NAMES[mode]} ({staged_bytes} bytes "
        f"staged), grid {-(-n // threads)} blocks of {threads} threads (the "
        f"SMs hold {grid}): {t['ms']:.4f} ms per call, {t['device_ms']:.4f} ms "
        f"on the card alone; plain loop {plain_ms:.1f} ms; {walked} bytes "
        f"walked, {values} values ({value_bytes} value bytes); the walk needs "
        f"{per_byte:g} int32 operations a value byte and {per_value:g} a value "
        f"({sum(k for k, _p in K3_PAGE_OPS_PER_BYTE.values())} and "
        f"{sum(k for k, _p in K3_PAGE_OPS_PER_VALUE.values())} in all: "
        f"{K3_PAGE_OPS_PER_BYTE}, {K3_PAGE_OPS_PER_VALUE}); {n_bytes} bytes "
        f"moved: bound {b_ms:.4f} ms by {b_by} "
        f"({100 * b_ms / t['device_ms']:.1f}% of the time on the card); "
        f"{loads} shared "
        f"loads: {lds_ms:.4f} ms at 32 a clock an SM, no bank conflicts "
        f"({100 * lds_ms / t['device_ms']:.1f}%); the compiled chunk loop "
        f"(16 byte steps): {ops['instructions']} machine instructions "
        f"({ops['memory']} memory, {ops['int32_ops']} int32; "
        f"{ops['opcodes']}), {ops['registers']} registers, "
        f"{ops['spill_bytes']} spill bytes")
    k3 = {"max_abs_err": err, "ms": t["ms"], "device_ms": t["device_ms"],
          "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
          "library_ms": None, "shape": f"stream {list(bk['stream'].shape)}, "
          f"{walked} bytes walked, {values} values, {dfa.n_states} states",
          "ops_per_byte": per_byte,
          "ops_per_value": per_value, "shared_load_floor_ms": lds_ms,
          "table_mode": dfa_walk.MODE_NAMES[mode], "grid": grid,
          "loop_instructions": ops["instructions"],
          "registers": ops["registers"], "spill_bytes": ops["spill_bytes"],
          "layouts": timings}
    return k3, bk


def time_table_kernel(col, str_chars, str_lens, ops_per_s):
    """(f) K3 at the main path's shapes: the page walk (`time_page_walk`)
    and the per-value walk on l_comment's str_padded, each beside its
    plain version, on the card alone and against its bound; both variants
    under the pattern's table and a 153,856-byte random one; then one warm query's wall time, launches and idle share
    with K3 and, in the same run, with the plain loop."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import dfa_walk
    from duckdb_parquet_parser_tpu_torch.ops.regex import compile_pattern
    from duckdb_parquet_parser_tpu_torch.utils.probe_value_walk import (
        fetch_floor,
    )

    pat = TABLE_PATTERNS[0]
    dfa = compile_pattern(pat)
    table_bytes = len(dfa_walk.pack_table(dfa).data)
    k3, bk = time_page_walk(col, dfa, ops_per_s)

    def walk_value():
        return dfa_walk.value_walk(str_chars, str_lens, dfa)

    t = best_of({"kernel": walk_value,
                 "plain": lambda: dfa_walk.value_walk_plain(str_chars,
                                                            str_lens, dfa)},
                5)
    want = dfa_walk.value_walk_plain(str_chars, str_lens, dfa)
    err = int((walk_value() != want).sum())
    on_card = min(queued_ms(walk_value, 20) for _ in range(3))
    walked = int(str_lens.clamp(max=str_chars.shape[1]).sum())
    count = str_chars.shape[0]
    floor = fetch_floor(str_chars, str_lens)
    floor_ms = floor / HBM_BYTES_PER_S * 1e3
    v_per_byte = needed_ops(K3_VALUE_OPS_PER_BYTE)
    mode, nbytes = dfa_walk.value_mode(dfa_walk.pack_table(dfa),
                                       torch.cuda.current_device())
    # the kernel's instance: its table mode and its load width
    piece = next(p for p in (16, 8, 4, 1)
                 if (str_chars.data_ptr() | str_chars.shape[1]) % p == 0)
    vops = loop_ops("dfa_values_kernel", f"ILi{mode}ELi{piece}E")
    n_bytes = walked + 5 * count + table_bytes
    v_ms, v_by = bound(n_bytes, v_per_byte * walked
                       + K3_VALUE_OPS_PER_VALUE * count, ops_per_s)
    log(f"K3 per-value walk {pat!r} on str_padded {tuple(str_chars.shape)}, "
        f"the wrapper's {dfa_walk.MODE_NAMES[mode]} ({nbytes} bytes "
        f"staged): {t['kernel']:.4f} ms per call, {on_card:.4f} ms on the "
        f"card alone; plain {t['plain']:.4f} ms; {walked} bytes walked; the walk "
        f"needs {v_per_byte:g} int32 operations a byte and "
        f"{K3_VALUE_OPS_PER_VALUE} a value; {n_bytes} bytes moved: bound "
        f"{v_ms:.4f} ms by {v_by} ({100 * v_ms / on_card:.1f}% of the time "
        f"on the card); the 32-byte sectors that "
        f"hold the walked bytes: {floor} bytes, {floor_ms:.4f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s ({100 * floor_ms / on_card:.1f}% "
        f"of the time on the card); the compiled window loop (64 bytes of "
        f"a row a thread, {piece}-byte loads): {vops['instructions']} machine "
        f"instructions ({vops['memory']} memory, {vops['int32_ops']} int32; "
        f"{vops['opcodes']}), {vops['registers']} registers, "
        f"{vops['spill_bytes']} spill bytes")
    k3.update(values_shape=f"chars {list(str_chars.shape)}",
              values_max_abs_err=err, values_ms=t["kernel"],
              values_device_ms=on_card, values_plain_ms=t["plain"],
              values_bound_ms=v_ms, values_bound_by=v_by,
              values_fetch_floor_bytes=floor, values_fetch_floor_ms=floor_ms,
              values_variant=dfa_walk.MODE_NAMES[mode],
              values_loop_instructions=vops["instructions"],
              values_registers=vops["registers"],
              values_spill_bytes=vops["spill_bytes"])

    # where the table sits: both variants at the path's shapes, under the
    # pattern's table and a random 300 x 256 one (153,856 bytes)
    big = random_dfa(np.random.default_rng(59), 300, 256)
    dfas = {f"{table_bytes} B": dfa,
            f"{len(dfa_walk.pack_table(big).data)} B": big}
    variants = {
        "page walk": time_variants(
            lambda d, st: dfa_walk.stream_walk(
                bk["stream"], bk["walk_plen"], bk["walk_nn"], d, bk["steps"],
                staged=st), dfas),
        "per-value walk": time_variants(
            lambda d, st: dfa_walk.value_walk(str_chars, str_lens, d,
                                              staged=st), dfas,
            value_stageable)}
    for walk, by_table in variants.items():
        picks = {label: value_variant(dfa_walk.pack_table(d),
                                      walk == "per-value walk")
                 for label, d in dfas.items()}
        log(f"K3 {walk}, table in device memory / staged in shared memory "
            "(least of 3 rounds of 10): " + "; ".join(
                f"{label} table {dev_ms:.4f} / "
                + ("cannot be staged" if sh_ms is None else f"{sh_ms:.4f} ms")
                + ", the wrapper "
                f"picks the {picks[label]}"
                for label, (dev_ms, sh_ms) in by_table.items()))
    k3["variants_ms"] = {walk: {label: {"device_memory": d, "shared": sh}
                                for label, (d, sh) in by_table.items()}
                         for walk, by_table in variants.items()}

    # the warm query, with K3 and with the plain loop it replaces
    for label, ctx in (("K3", contextlib.nullcontext()),
                       ("plain loop", plain_table_walk())):
        with ctx:
            ms, _res = timed(lambda: col.scan(pat), 1)
            wall, busy, launches, by_name = device_profile(
                lambda: col.scan(pat),
                ROOT / "build" / "profile" / f"table_{label[:5]}.json",
                cpu=label == "K3",
                launches=sum(b["has_plain"] for b in col._buckets))
        k3_dev = sum(v for k, v in by_name.items() if "dfa_stream" in k)
        line = (NOT_PROFILED if busy is None else
                f"wall {wall:.3f} ms under the profiler, device busy "
                f"{busy:.4f} ms ({100 * (1 - busy / wall):.2f}% idle), "
                f"{launches} kernel launches, K3 {k3_dev:.4f} ms")
        log(f"warm query l_comment ~ {pat!r} with {label}: {ms:.3f} ms "
            f"(CUDA events); profile: {line}")
        k3[f"query_ms_{label.split()[0].lower()}"] = ms
        if label == "K3":
            k3["query_profiled_k3_launches"] = profiled_k3_launches(col, pat)
    return k3


def profile_counts(fn, trace: Path) -> dict:
    """One profile (host and device activities) of `fn` after a warm-up:
    the K3 launches the wrapper counted, the launch calls and the K3
    kernels the trace records, and each recorded kernel's start less its
    launch call's start (µs on the trace's clock; a kernel cannot start
    before its launch, so a negative lead is how far the device's converted
    timestamps run early)."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import dfa_walk

    fn()
    before = dfa_walk.launches
    _profile_once(fn, trace, True)
    counted = dfa_walk.launches - before
    events = json.loads(trace.read_text())["traceEvents"]
    calls = {e["args"]["correlation"]: float(e["ts"]) for e in events
             if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]
             and "correlation" in e.get("args", {})}
    k3 = [e for e in events
          if e.get("cat") == "kernel" and "dfa_stream" in e["name"]]
    return {"counted": counted, "launch_calls": len(calls),
            "recorded": len(k3),
            "launch_lead_us": [round(float(e["ts"]) - calls[c], 1)
                               for e in k3 for c in
                               [e.get("args", {}).get("correlation")]
                               if c in calls]}


def profile_probe(late: bool) -> int:
    """(`--profile-probe [late]`, a child process) Profiles of two K3 page
    walks over random pages in a fresh process: first, then after a
    profile of 20,000 small PyTorch launches (device only, as the plain
    loop's is taken), then after one with host activities too.  `late`: a
    profile of other kernels starts the profiler before K3's first launch.
    Prints one JSON line {when: profile_counts}."""
    import numpy as np
    import torch

    setup_environment()
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dfa_walk,
        stream_matcher,
    )
    from duckdb_parquet_parser_tpu_torch.ops.regex import compile_pattern

    rng = np.random.default_rng(53)
    pm, plen, nn = random_pages(rng, 3000, 6, 40, alphabet=bytes(range(256)))
    stream = stream_matcher.chunk_stream(
        torch.from_numpy(np.ascontiguousarray(pm.T)).cuda())
    pl, nv = torch.from_numpy(plen).cuda(), torch.from_numpy(nn).cuda()
    dfa = compile_pattern(TABLE_PATTERNS[0])

    def two_walks():
        for _ in range(2):
            dfa_walk.stream_walk(stream, pl, nv, dfa)

    x = torch.zeros(1024, device="cuda")

    def many():
        for _ in range(20_000):
            x.add_(1)

    trace = ROOT / "build" / "profile" / "k3_fresh.json"
    if late:
        _profile_once(many, trace, True)
    out = {"first": profile_counts(two_walks, trace)}
    for cpu in (False, True):
        _profile_once(many, trace, cpu)
        out[f"after 20000 launches profiled ({'host and ' * cpu}device)"] = (
            profile_counts(two_walks, trace))
    print(json.dumps(out), flush=True)
    return 0


def profiled_k3_launches(col, pat) -> dict:
    """The K3 launches that profiles record beside those the wrapper
    counted (profile_counts): of the warm table-DFA query and of its two
    page walks launched straight, in this process, and of two page walks
    over random pages in fresh processes (`--profile-probe`), one of them
    with the profiler started before K3's first launch."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import dfa_walk
    from duckdb_parquet_parser_tpu_torch.ops.regex import compile_pattern

    buckets = [b for b in col._buckets if b["has_plain"]]
    dfa = compile_pattern(pat)

    def direct():
        for b in buckets:
            dfa_walk.stream_walk(b["stream"], b["walk_plen"], b["walk_nn"],
                                 dfa, b["steps"])

    seen = {}
    for label, fn in (("the query", lambda: col.scan(pat)),
                      ("its two page walks", direct)):
        seen[label] = profile_counts(
            fn, ROOT / "build" / "profile" / f"k3_{len(seen)}.json")
    for late in ("", "late"):
        child = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--profile-probe"]
            + [late] * bool(late), capture_output=True, text=True,
            timeout=300)
        if child.returncode != 0:
            raise AssertionError(f"--profile-probe {late} failed: "
                                 f"{child.stderr[-2000:]}")
        where = ("a fresh process whose profiler started before K3's first "
                 "launch" if late else "a fresh process")
        for when, c in json.loads(
                child.stdout.strip().splitlines()[-1]).items():
            seen[f"two page walks in {where}, {when}"] = c
    for label, c in seen.items():
        log(f"profile of {label}: the wrapper launched K3 {c['counted']} "
            f"times; the trace records {c['launch_calls']} launch calls and "
            f"{c['recorded']} K3 kernels, each starting "
            f"{c['launch_lead_us']} µs after its launch call")
    return seen


def run_table_sharded(device, fixtures: Path):
    """(d) A one-rank NCCL `ScanEngine(mesh).scan` of the first table-DFA
    pattern against the native exact scan, K3's launches counted."""
    import numpy as np

    from duckdb_parquet_parser_tpu_torch.bench import launch_counts
    from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
    from duckdb_parquet_parser_tpu_torch.parallel.mesh import make_mesh

    path = fixtures / f"lineitem_{MAIN_ROWS}.parquet"
    pat = TABLE_PATTERNS[0]
    eng = ScanEngine(str(path), mesh=make_mesh(device, "nccl"))
    reset_launches()
    t0 = time.perf_counter()
    res = eng.scan("l_comment", pat)
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    ref = eng.cold_scan("l_comment", pat, exact_counts=True, stats_prune=False)
    keep = res.page_gid >= 0
    order = np.argsort(res.page_gid[keep], kind="stable")
    ro = np.argsort(ref.page_gid, kind="stable")
    if not (np.array_equal(res.page_gid[keep][order], ref.page_gid[ro])
            and np.array_equal(res.match_counts[keep][order],
                               ref.match_counts[ro])
            and res.totals.tolist() == [int(ref.match_counts.sum()),
                                        int(ref.value_counts.sum())]):
        raise AssertionError(f"the sharded scan of {pat!r} disagrees with the "
                             "native host scan")
    if launches["dfa_walk"] < 1 or launches["stream_matcher"]:
        raise AssertionError(f"the sharded scan of {pat!r} launched {launches}")
    log(f"one rank, nccl: scan l_comment ~ {pat!r} {ms:.1f} ms, totals "
        f"{res.totals.tolist()}, launches {launches}; equal to native scan")
    return launches


def pattern_tuples():
    """Every pattern tuple whose stream-matcher kernel is built up front,
    in one nvcc run; a child rank that asks for the same list loads that
    library and builds nothing."""
    return ([(p,) for p in STREAM_PATTERNS + BENCH_PATTERNS + DICT_PATTERNS
             + [EXAMPLE_PATTERN]] + [FUSED, tuple(BENCH_PATTERNS[:3])])


def run_cli(path: Path):
    """The port's command line on the 2M-row file: file info, a regex scan
    through the device pipeline on the card against the native scan's
    output, and the chunked index of l_comment."""
    import contextlib
    import io

    from duckdb_parquet_parser_tpu_torch import cli
    from duckdb_parquet_parser_tpu_torch.bench import launches_of

    def call(*argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(list(argv))
        if rc != 0:
            raise AssertionError(f"cli {argv} returned {rc}")
        return out.getvalue(), (time.perf_counter() - t0) * 1e3

    info, ms = call(str(path))
    if "Total data pages:" not in info or "l_comment" not in info:
        raise AssertionError("cli: the file info lacks its lines")
    log(f"cli <file>: {len(info.splitlines())} lines in {ms:.1f} ms")
    scan = ["--regex-column", "l_comment", "--regex", BENCH_PATTERNS[0]]
    _, launches = launches_of(lambda: call(str(path), *scan, "--engine",
                                           "torch"))
    card, card_ms = call(str(path), *scan, "--engine", "torch")
    native, native_ms = call(str(path), *scan, "--engine", "native")
    if card != native or not card.startswith("Scanned column 'l_comment'"):
        raise AssertionError("cli: --engine torch on the card prints other "
                             "bytes than --engine native")
    if launches["stream_matcher"] < 1:
        raise AssertionError("cli --engine torch did not launch K1")
    log(f"cli regex scan of l_comment ~ {BENCH_PATTERNS[0]!r}: --engine "
        f"torch (card) {card_ms:.1f} ms, --engine native {native_ms:.1f} ms, "
        f"the same {len(card.splitlines())} lines; launches {launches}")
    index, ms = call("index", str(path), "l_comment")
    want = f"Total tuples: {MAIN_ROWS}\nTotal chunks: {L_COMMENT_CHUNKS}\n"
    if index != want:
        raise AssertionError(f"cli index printed {index!r}, not {want!r}")
    log(f"cli index <file> l_comment: {index.split()[2]} tuples, "
        f"{index.split()[5]} chunks in {ms:.1f} ms")


def run_sharded_one_rank(eng, deng, fixtures: Path):
    """One rank over NCCL on the card at full width, held against the
    native exact scan, `read_column` and `build_index_for_column`; then the
    same calls on the 500,000-row file, whose answers the four child ranks
    are held against.  The launch counts of either pass are read from
    counters set to 0 just before it.  Returns a dict: those `answers`,
    their `files`, the `launches` of the full-width pass and of the
    500,000-row pass (`launches_small`), and the full-width emission
    decode's `emission_inputs`, the full-width `got` results."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.bench import launch_counts
    from duckdb_parquet_parser_tpu_torch.host.reader import ParquetReader
    from duckdb_parquet_parser_tpu_torch.ops.index import (
        build_index_for_column,
    )
    from duckdb_parquet_parser_tpu_torch.parallel.mesh import make_mesh
    from duckdb_parquet_parser_tpu_torch.utils import fixtures as fx
    from duckdb_parquet_parser_tpu_torch.utils.probe_sharded import (
        sharded_answers,
    )

    mesh = make_mesh("cuda:0", "nccl")
    log(f"mesh: rank {mesh.rank} of {mesh.size} on {mesh.device} over "
        f"{mesh.backend}")
    files = {"lineitem": fixtures / f"lineitem_{MAIN_ROWS}.parquet",
             "city": Path(deng.reader._path),
             "decode": (fixtures / f"dict_ints_{MAIN_ROWS}.parquet", "k")}
    t0 = time.perf_counter()
    reset_launches()
    got, lines, emission_inputs = sharded_answers(mesh, files, fail=None)
    launches = launch_counts()
    for line in lines:
        log("one rank, nccl, full width: " + line)
    log(f"one rank, nccl, full width: launches of the whole pass {launches}")
    for e, column, pat in ((eng, "l_comment", BENCH_PATTERNS[0]),
                           (deng, "city", DICT_PATTERNS[0])):
        ref = e.cold_scan(column, pat, exact_counts=True, stats_prune=False)
        order = np.argsort(ref.page_gid, kind="stable")
        if not (np.array_equal(got[f"scan/{column}/page_gid"],
                               ref.page_gid[order])
                and np.array_equal(got[f"scan/{column}/match_counts"],
                                   ref.match_counts[order])
                and np.array_equal(got[f"scan/{column}/value_counts"],
                                   ref.value_counts[order])
                and got[f"scan/{column}/totals"].tolist() == [
                    int(ref.match_counts.sum()), int(ref.value_counts.sum())]):
            raise AssertionError(f"sharded scan of {column} disagrees with "
                                 "the native host scan")
        idx = build_index_for_column(e.reader, column)
        entries = np.stack([idx.positions, idx.lens, idx.chunk_of_entry],
                           axis=1)
        for mode in ("ragged", "padded"):
            for k, want in (("tuple_to_chunk", idx.tuple_to_chunk),
                            ("chunk_starts", idx.chunk_starts),
                            ("chunk_of_entry", idx.chunk_of_entry),
                            ("entries", entries)):
                if not np.array_equal(got[f"index/{column}/{mode}/{k}"],
                                      want):
                    raise AssertionError(
                        f"sharded index build of {column} ({mode}): {k} "
                        "differs from build_index_for_column")
    if len(got["index/l_comment/ragged/chunk_starts"]) != L_COMMENT_CHUNKS:
        raise AssertionError("the sharded index of l_comment has "
                             f"{len(got['index/l_comment/ragged/chunk_starts'])}"
                             " chunks")
    path, column = files["decode"]
    reader = ParquetReader(str(path))
    batch = reader.prescan(column)
    values, valid = flatten_planes(
        batch, [torch.from_numpy(got[f"decode/{column}/plane{j}"])
                for j in range(2)],
        torch.from_numpy(got[f"decode/{column}/nonnull"]))
    same_column("sharded decode of k", values, valid,
                reader.read_column(column))
    log(f"one rank, nccl, full width: all equal to the native scan, "
        f"read_column and build_index_for_column "
        f"({time.perf_counter() - t0:.1f} s with the checks)")

    t0 = time.perf_counter()
    small = fx.lineitem(fixtures / f"lineitem_{SHARD_ROWS}.parquet",
                        SHARD_ROWS)
    shard_files = {"lineitem": small, "city": files["city"],
                   "decode": (small, "l_quantity")}
    log(f"fixture of {SHARD_ROWS} rows ready in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    answers, lines, _inputs = sharded_answers(mesh, shard_files, fail=None)
    launches_small = launch_counts()
    for line in lines:
        log(f"one rank, nccl, {SHARD_ROWS} rows: " + line)
    log(f"one rank, nccl, {SHARD_ROWS} rows: launches of the whole pass "
        f"{launches_small}")
    return {"answers": answers, "files": shard_files, "launches": launches,
            "launches_small": launches_small, "got": got,
            "emission_inputs": emission_inputs}


def run_child_ranks(answers: dict, shard_files: dict, work: Path):
    """Four ranks over gloo that share the card, started as a group by
    `utils/probe_sharded.run_group` after every kernel and the native
    library were built here (a rank that builds one fails).  Each holds its
    results against `answers`; a non-zero exit or a rank that outlives its
    timeout fails the run.  Returns the ranks' reports and the path of the
    emission decode's `dict_lookup` inputs that rank 0 saved."""
    import numpy as np

    from duckdb_parquet_parser_tpu_torch.utils.probe_sharded import run_group

    work.mkdir(parents=True, exist_ok=True)
    for old in work.glob("*"):
        old.unlink()
    np.savez(work / "answers.npz", **answers)
    reports, wall = run_group(
        SHARD_RANKS, "gloo", "cuda", shard_files, work, work / "answers.npz",
        save=False, fail=FAILED_RANK, kernel_patterns=pattern_tuples(),
        timeout=CHILD_TIMEOUT_S)
    for line in reports[0]["lines"]:
        log(f"{SHARD_RANKS} ranks, gloo, one card, {SHARD_ROWS} rows: "
            + line)
    for rank, rep in enumerate(reports):
        log(f"rank {rank} on {rep['device']}: {rep['compared']} arrays equal "
            f"to the one-rank answers, launches {rep['launches']}, "
            f"{rep['seconds']:.1f} s after the group formed")
        for name in ("stream_matcher", "dict_lookup"):
            if rep["launches"][name] <= 0:
                raise AssertionError(f"rank {rank}: {name} was not launched")
    log(f"{SHARD_RANKS} child ranks done in {wall:.1f} s of wall clock")
    return reports, work / f"report_{SHARD_RANKS}.emission.npz"


def run_launch_entry_points(path: Path, got: dict, card: str):
    """`python -m duckdb_parquet_parser_tpu_torch.launch` as a user starts
    it, one rank over NCCL on the card, three child processes at once: a
    `scan` of l_comment whose group forms from DPQ_COORDINATOR, an `index`
    of l_comment whose group forms from torchrun's variables (LOCAL_RANK
    picks the card), and a short `scaling-bench` with neither (`make_mesh`
    forms its group of one).  Each one's JSON line is held against the
    one-rank results `got` of the sharded phase on the same file."""
    from duckdb_parquet_parser_tpu_torch.parallel.mesh import (
        free_port,
        run_processes,
    )

    mod = "duckdb_parquet_parser_tpu_torch.launch"
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("DPQ_") or k == "DPQ_BUILD_CACHE"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        base.pop(k, None)
    jobs = {
        "scan": (["scan", str(path), "l_comment", BENCH_PATTERNS[0]],
                 {"DPQ_COORDINATOR": f"127.0.0.1:{free_port()}",
                  "DPQ_NUM_PROCESSES": "1", "DPQ_PROCESS_ID": "0"}),
        "index": (["index", str(path), "l_comment"],
                  {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                   "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(free_port())}),
        "scaling-bench": (["scaling-bench", "--reps", "3"], {}),
    }
    t0 = time.perf_counter()
    # three groups of one rank each: one failing ends none of the others
    ends = dict(zip(jobs, run_processes(
        [[sys.executable, "-m", mod, *argv] for argv, _env in jobs.values()],
        CHILD_TIMEOUT_S, cwd=str(ROOT),
        env=[{**base, **env} for _argv, env in jobs.values()], grace=None)))
    found = {}
    for name, end in ends.items():
        out, err = end.out, end.err
        if end.returncode != 0:
            raise AssertionError(f"launch {name} exited with "
                                 f"{end.returncode}:\n{err[-3000:]}")
        formed = "no" if name == "scaling-bench" else "yes"
        want = (f"[launch] processes=1 (group={formed}) device=cuda:0 "
                "backend=nccl")
        if want not in err:
            raise AssertionError(f"launch {name}: its first line is not "
                                 f"{want!r}:\n{err[-2000:]}")
        lines = out.strip().splitlines()
        if not lines:
            raise AssertionError(f"launch {name} printed nothing")
        # the result is the last line: a backend may print a banner first
        found[name] = json.loads(lines[-1])
        log(f"launch {name} (one rank, nccl, cuda:0, group={formed}): "
            f"{lines[-1]}")

    scan = found["scan"]
    counts = got["scan/l_comment/match_counts"]
    totals = got["scan/l_comment/totals"].tolist()
    want = {"cmd": "scan", "devices": 1, "processes": 1,
            "surviving_pages": int((counts > 0).sum()),
            "total_matches": totals[0], "total_values": totals[1]}
    pad = scan.pop("pages") - len(counts)
    if scan != want or not 0 <= pad < 8:
        raise AssertionError(f"launch scan printed {scan} (+{pad} pad "
                             f"pages), not {want}")
    index = found["index"]
    want = {"cmd": "index", "devices": 1, "processes": 1,
            "tuples": len(got["index/l_comment/ragged/entries"]),
            "chunks": L_COMMENT_CHUNKS, "exchange_mode": "ragged"}
    if ({k: index.get(k) for k in want} != want or index["skew"] != 1.0
            or not 1.0 <= index["capacity_ratio"] < 1.2):
        raise AssertionError(f"launch index printed {index}, not {want}")
    bench = found["scaling-bench"]
    rows = bench["table"]
    if (bench["metric"] != "scan_scaling" or bench["platform"] != "gpu"
            or card.split(",")[0] not in bench["note"]
            or [r["devices"] for r in rows] != [1]
            or rows[0]["efficiency_wall"] != 1.0
            or rows[0]["rows_per_s"] <= 0
            or set(rows[0]) != {"devices", "rows_per_s", "efficiency_wall",
                                "efficiency_compute", "shard_value_skew"}):
        raise AssertionError(f"launch scaling-bench printed {bench}")
    log(f"the three launch entry points agree with the sharded phase "
        f"({time.perf_counter() - t0:.1f} s of wall clock, started "
        "together)")


def run_dryrun() -> tuple[list, dict]:
    """`python -m duckdb_parquet_parser_tpu_torch.dryrun 2 --backend gloo
    --device cuda` as a user runs it: the module starts two gloo ranks that
    share the card.  Its line must be the reference's at two devices
    (`DRYRUN_LINE`, sections 7 and 8 noted as the reference notes them
    where pyarrow does not import), every rank's K1 and K2 launches over
    the dry run more than 0.  With `--record`, each rank saved the
    arguments of every call of the kernels' wrappers: here each call is
    made again on the card, the kernel beside its plain version on the
    same tensors, compared exactly (these launches are not the dry run's).
    Returns each rank's launches and {wrapper: {"calls": [a rank],
    "max_abs_err"}}."""
    import torch

    from duckdb_parquet_parser_tpu_torch.parallel.mesh import run_processes
    from duckdb_parquet_parser_tpu_torch.utils.record import hold_recorded

    record = ROOT / "build" / "dryrun_calls"
    for old in record.glob("rank*.pt"):
        old.unlink()
    t0 = time.perf_counter()
    end, = run_processes(
        [[sys.executable, "-m", "duckdb_parquet_parser_tpu_torch.dryrun",
          str(DRYRUN_RANKS), "--backend", "gloo", "--device", "cuda",
          "--record", str(record)]], CHILD_TIMEOUT_S, cwd=str(ROOT))
    seconds = time.perf_counter() - t0
    if end.returncode != 0:
        raise AssertionError(f"the dry run exited with {end.returncode}:\n"
                             f"{end.err[-4000:]}")
    pyarrow = importlib.util.find_spec("pyarrow") is not None
    want = DRYRUN_LINE.format(
        nested=("nested scan 113 hits" if pyarrow
                else "nested scan skipped (no pyarrow)"),
        delta=("sharded delta decode 6 pages" if pyarrow
               else "sharded delta decode skipped (no pyarrow)"))
    if end.out.strip().splitlines() != [want]:
        raise AssertionError(f"the dry run printed {end.out!r}, not {want!r}")
    reports = re.findall(rf"^\[dryrun\] rank (\d+) of {DRYRUN_RANKS} on "
                         r"cuda:0 over gloo: launches (\{.*?\}), ([0-9.]+) s$",
                         end.err, re.M)
    launches = [json.loads(found) for _rank, found, _s in sorted(reports)]
    if [int(r) for r, _l, _s in sorted(reports)] != list(range(DRYRUN_RANKS)):
        raise AssertionError(f"the dry run's ranks reported {reports}")
    for rank, got in enumerate(launches):
        for name in ("stream_matcher", "dict_lookup"):
            if got[name] <= 0:
                raise AssertionError(f"dry run rank {rank}: {name} was not "
                                     "launched")
    log(f"dry run, {DRYRUN_RANKS} gloo ranks sharing the card: {want}")
    for (rank, _l, secs), got in zip(sorted(reports), launches):
        log(f"dry run rank {rank}: launches {got}, {secs} s in the dry run")
    log(f"the dry run took {seconds:.1f} s of wall clock, the ranks' start "
        "and kernel build included")

    held = {}
    for rank, got in enumerate(launches):
        calls = torch.load(record / f"rank{rank}.pt", weights_only=False)
        result = hold_recorded(calls, "cuda:0")
        # a call launches its kernel unless its input is empty
        by_kernel = {"stream_matcher": ["stream_matcher.match_stream"],
                     "dict_lookup": ["dict_lookup.dict_lookup",
                                     "dict_lookup.dict_count"]}
        for kernel, names in by_kernel.items():
            noted = sum(result[n]["calls"] for n in names)
            if noted < got[kernel]:
                raise AssertionError(
                    f"dry run rank {rank}: {noted} calls of {kernel}'s "
                    f"wrappers recorded, {got[kernel]} launches")
        for name, r in result.items():
            entry = held.setdefault(name, {"calls": [], "max_abs_err": 0})
            entry["calls"].append(r["calls"])
            entry["max_abs_err"] = max(entry["max_abs_err"], r["max_abs_err"])
            log(f"dry run rank {rank}: {r['calls']} calls of {name} made "
                f"again on the card at the dry run's shapes, max abs err "
                f"{r['max_abs_err']} against the plain version")
    for name, entry in held.items():
        if entry["max_abs_err"] != 0:
            raise AssertionError(f"{name} differs from its plain version at "
                                 "the dry run's shapes")
    return launches, held


def run_bench_quick() -> dict:
    """`python -m duckdb_parquet_parser_tpu_torch.bench --quick` as a user
    runs it, in a child process with a time limit: it must exit 0 and end
    with the reference benchmark's JSON line.  Its stderr (progress, the
    detail line, the card) and its last line are logged; returns the
    detail."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "duckdb_parquet_parser_tpu_torch.bench",
         "--quick"], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"the benchmark exited with {proc.returncode}:"
                             f"\n{err[-4000:]}")
    for ln in err.splitlines():
        log(f"bench: {ln}")
    lines = out.strip().splitlines()
    line = json.loads(lines[-1]) if lines else None
    if (not isinstance(line, dict) or list(line) != BENCH_KEYS
            or line["metric"] != "decode_regex_scan_rows_per_s"
            or line["unit"] != "rows/s" or not line["value"] > 0):
        raise AssertionError(f"the benchmark's last line is {lines[-1:]}")
    details = [json.loads(ln)["detail"] for ln in err.splitlines()
               if ln.startswith('{"detail"')]
    if len(details) != 1:
        raise AssertionError("the benchmark printed no detail line")
    log(f"bench --quick: {lines[-1]} ({time.perf_counter() - t0:.1f} s, "
        f"launches a call: {details[0]['launches']})")
    return details[0]


def setup_environment() -> None:
    """What the parent and its child ranks share: JAX refused, the
    checkout importable, the native library's cache (its compiler is set
    by `bench.build_host_library` in the parent, and inherited)."""
    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("DPQ_BUILD_CACHE", str(ROOT / "build" / "native"))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "duckdb_parquet_parser_tpu_torch").is_dir():
        print("chip_smoke: the repository is not beside this script",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--profile-probe"]:
        return profile_probe(sys.argv[2:3] == ["late"])
    setup_environment()
    from duckdb_parquet_parser_tpu_torch.bench import (
        build_host_library,
        build_kernels,
        card_line,
        launch_counts,
        launches_of,
    )

    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    ops_per_s, ops_note = int32_ops_per_s()
    log(f"peaks used for the bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s of "
        f"device memory; {ops_per_s / 1e12:.3f} T int32 operations/s = "
        f"{ops_note}")

    t0 = time.perf_counter()
    lib = build_host_library()
    log(f"native host library: {time.perf_counter() - t0:.1f} s "
        f"({lib.name})")

    # one nvcc run a source, all started together
    t0 = time.perf_counter()
    build_kernels(pattern_tuples())
    log(f"kernel build: {time.perf_counter() - t0:.1f} s, three nvcc runs at "
        f"once ({len(pattern_tuples())} stream-matcher tuples, the dictionary "
        "kernels, the table-DFA walk)")

    check_stream_kernel(device)
    check_stream_kernel_edges(device)
    check_dict_kernel(device)
    report, launches, col, dcol, eng, deng = run_main_path(
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

    # the decode path and the block scans, counted apart from the resident
    # scan's launches above
    reset_launches()
    fixtures = ROOT / "build" / "fixtures"
    k_decode = run_decode_path(device, MAIN_ROWS, fixtures, ops_per_s)
    decode_launches = launch_counts()
    run_delta(device, ops_per_s)
    run_block_scans(device, eng, deng, fixtures)
    slice_launches = launch_counts()
    log(f"decode-path launches: {decode_launches}; with the block scans: "
        f"{slice_launches}")
    if decode_launches["dict_lookup"] <= 0:
        raise AssertionError("the dictionary kernel was not launched on the "
                             "decode path")
    for name in ("stream_matcher", "dict_lookup"):
        if slice_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the decode and "
                                 "block-scan paths")
    check_small_decodes(device, fixtures)

    queries = (("l_comment", col, lambda: col.scan(BENCH_PATTERNS[0])),
               ("city", dcol, lambda: dcol.scan(DICT_PATTERNS[0])))
    per_query = {}
    for label, rc, fn in queries:
        _, per_query[label] = launches_of(fn)
        want = {"stream_matcher": sum(b["has_plain"] for b in rc._buckets),
                "dict_lookup": sum(b["has_dict"] for b in rc._buckets),
                "dfa_walk": 0}
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
            log(f"profile {label} (one warm query under torch.profiler): "
                + NOT_PROFILED)
            continue
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
    k2.update(time_decode_lookup(k_decode["table"], k_decode["gidx"],
                                 ops_per_s))

    # the table-DFA path (K3), counted apart: (a) and (b) hold the kernel
    # against its plain version, (c)-(e) drive the path, (f) times it
    str_chars, str_lens = check_table_kernels(col, eng, deng, device)
    reset_launches()
    table_report, table_per_query = run_table_dfa_path(col, eng, device)
    table_launches = launch_counts()
    for column, pat, neg, ms, rows, hits, pruned in table_report:
        timing = ("" if ms is None else
                  f"{ms:.3f} ms/query, {rows / ms * 1e3:.4g} rows/s, ")
        log(f"{column} ~ {pat!r}{' negate' if neg else ''}: {timing}{hits} "
            f"hits, {pruned} pages pruned; equal to native scan")
    log(f"table-DFA path launches: {table_launches}; one resident query: "
        f"{table_per_query}")
    if table_launches["dfa_walk"] <= 0 or table_launches["stream_matcher"]:
        raise AssertionError(f"the table-DFA path launched {table_launches}")
    k3 = time_table_kernel(col, str_chars, str_lens, ops_per_s)
    del str_chars, str_lens
    # the front door and the sharded paths, counted apart again (after the
    # profiles: the profiler loses device events once the process group
    # and the child ranks have been on the card)
    reset_launches()
    t0 = time.perf_counter()
    run_cli(fixtures / f"lineitem_{MAIN_ROWS}.parquet")
    cli_launches = launch_counts()
    t1 = time.perf_counter()
    one = run_sharded_one_rank(eng, deng, fixtures)
    sharded_launches = one["launches"]
    table_sharded = run_table_sharded(device, fixtures)
    t2 = time.perf_counter()
    child_reports, emission_npz = run_child_ranks(
        one["answers"], one["files"], ROOT / "build" / "ranks")
    t3 = time.perf_counter()
    run_launch_entry_points(fixtures / f"lineitem_{MAIN_ROWS}.parquet",
                            one["got"], card)
    t4 = time.perf_counter()
    dryrun_launches, dryrun_held = run_dryrun()
    t5 = time.perf_counter()
    run_bench_quick()
    log(f"front door and sharded paths: cli {t1 - t0:.1f} s, one rank "
        f"{t2 - t1:.1f} s, {SHARD_RANKS} child ranks {t3 - t2:.1f} s, the "
        f"launch entry points {t4 - t3:.1f} s, the dry run {t5 - t4:.1f} s, "
        f"the benchmark at --quick {time.perf_counter() - t5:.1f} s; "
        "launches: "
        f"cli {cli_launches}, one rank at full width {sharded_launches}, at "
        f"{SHARD_ROWS} rows {one['launches_small']}")
    for name in ("stream_matcher", "dict_lookup"):
        if sharded_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the sharded "
                                 "paths")

    # K2's gather at the emission decode's shapes, the inputs being the
    # ones `_emissions_local` gave the wrapper in the runs above: the whole
    # padded page block at one rank, a quarter of it at four (rank 0's, the
    # shard with city's real pages), over the [1, DN] table of the
    # dictionary entries' lengths
    lens_table, gidx = one["emission_inputs"]
    block = 8192  # distributed_index_build's page block
    if gidx.ndim != 2 or gidx.shape[0] != block or lens_table.shape[0] != 1:
        raise AssertionError(f"the emission decode of city gave dict_lookup "
                             f"gidx {tuple(gidx.shape)} at one rank")
    k2.update(time_decode_lookup(
        lens_table, gidx, ops_per_s, prefix="emission",
        where="inside the emission decode of city at one rank"))
    with np.load(emission_npz) as z:
        table4 = torch.from_numpy(z["table"]).to(device)
        gidx4 = torch.from_numpy(z["gidx"]).to(device)
    share = block // SHARD_RANKS
    if (gidx4.shape != (share, gidx.shape[1])
            or not torch.equal(gidx4, gidx[:share])
            or not torch.equal(table4, lens_table)
            or any(r["emission_gidx"] != list(gidx4.shape)
                   for r in child_reports)):
        raise AssertionError(
            f"the emission decode of city at {SHARD_RANKS} ranks gave "
            f"dict_lookup gidx {tuple(gidx4.shape)}, not the first "
            f"{share} rows of the one-rank block")
    k2.update(time_decode_lookup(
        table4, gidx4, ops_per_s, prefix="emission_four_ranks",
        where=f"inside the emission decode of city at {SHARD_RANKS} ranks "
              "(rank 0's shard)"))
    for name, entry in (("K1", k1), ("K2", k2), ("K3", k3)):
        if (entry["max_abs_err"] != 0 or entry.get("decode_max_abs_err", 0)
                or entry.get("values_max_abs_err", 0)
                or entry.get("emission_max_abs_err", 0)
                or entry.get("emission_four_ranks_max_abs_err", 0)):
            raise AssertionError(f"{name} differs from its plain version")
    per_query["decode_k"] = k_decode["launches"]
    kernels = [
        {"name": "stream_matcher", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["stream_matcher"],
         "launches_decode_and_block_scans": slice_launches["stream_matcher"],
         "launches_cli": cli_launches["stream_matcher"],
         "launches_sharded_one_rank": sharded_launches["stream_matcher"],
         f"launches_sharded_one_rank_{SHARD_ROWS}_rows":
             one["launches_small"]["stream_matcher"],
         "launches_sharded_child_ranks": [
             r["launches"]["stream_matcher"] for r in child_reports],
         "launches_dryrun_ranks": [r["stream_matcher"]
                                   for r in dryrun_launches],
         "dryrun_calls_held": dryrun_held["stream_matcher.match_stream"],
         "launches_per_query": {q: v["stream_matcher"]
                                for q, v in per_query.items()}, **k1},
        {"name": "dict_lookup", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["dict_lookup"],
         "launches_decode_and_block_scans": slice_launches["dict_lookup"],
         "launches_cli": cli_launches["dict_lookup"],
         "launches_sharded_one_rank": sharded_launches["dict_lookup"],
         f"launches_sharded_one_rank_{SHARD_ROWS}_rows":
             one["launches_small"]["dict_lookup"],
         "launches_sharded_child_ranks": [
             r["launches"]["dict_lookup"] for r in child_reports],
         "launches_dryrun_ranks": [r["dict_lookup"] for r in dryrun_launches],
         "dryrun_calls_held": {
             n: dryrun_held[f"dict_lookup.{n}"]
             for n in ("dict_lookup", "dict_count")},
         "launches_per_query": {q: v["dict_lookup"]
                                for q, v in per_query.items()}, **k2},
        {"name": "dfa_walk", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": table_launches["dfa_walk"],
         "launches_per_query": {"l_comment": table_per_query["dfa_walk"]},
         "launches_sharded_one_rank": table_sharded["dfa_walk"],
         "launches_dryrun_ranks": [r["dfa_walk"] for r in dryrun_launches],
         **k3},
    ]
    torch.distributed.destroy_process_group()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
