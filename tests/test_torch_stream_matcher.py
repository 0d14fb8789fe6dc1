"""Stream matcher K1 (duckdb_parquet_parser_tpu_torch/ops/kernels/
stream_matcher.py) against the reference's Pallas kernel, run in interpret
mode on the CPU as tests/test_pallas_stream.py runs it.  CPU tensors take
the port's plain version; the kernel-vs-plain cases need a CUDA device.
The wrapper takes the kernel's chunked stream layout ([chunks, n, 16]);
the layout converters round-trip.  The byte half of a tuple's transition
is a table of its byte frontier at the 256 byte values: the rendered table
is held against the IR evaluated byte by byte, and the host build of the
walk that reads it (tests/k1_host.py) against the plain walk.  Tolerance 0:
every output is an integer count."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from duckdb_parquet_parser_tpu_torch.ops import bitprog as tb
from duckdb_parquet_parser_tpu_torch.ops import strings as ts
from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher
from duckdb_parquet_parser_tpu_torch.ops.regex import like_to_regex
from duckdb_parquet_parser_tpu_torch.utils import tracing
from tests import k1_host
from tests.page_edges import (K1_EDGE_WALKS, PAGE_EDGE_STEPS, PAGE_EDGES,
                               k1_edge_irs, page_edge)
from tests.test_bitprog import _pages

PATTERNS = [
    "a.*z", "ab|cde|fg", "^ab", "q[ax]+x", "a?", "a{40}",
    "gr[ae]y|colou?r", "bc$",
    "[abq]{9}", "[a-gq-z]{9,12}x", "[abx ]{10}$",
]
FUSED = [("a.*z", "q[ax]+x", "[abq]{9}"), ("ab|cde|fg", "bc$")]

# the benchmark's LIKE predicates: TPC-H Q13's 16 on o_comment and one of
# each of part's three templates on p_type
Q13 = [f"%{a}%{b}%" for a in ("special", "pending", "unusual", "express")
       for b in ("packages", "requests", "accounts", "deposits")]
PART = ["PROMO%", "%TIN", "STANDARD ANODIZED%"]
# pattern tuples whose byte half is a table: {name: ir tuple factory}
TABLE_CASES = {
    **{f"Q13 {p}": (lambda p=p: (ts.pattern_ir(like_to_regex(p)),))
       for p in Q13},
    **{f"part {p}": (lambda p=p: (ts.pattern_ir(like_to_regex(p)),))
       for p in PART},
    "bitap chain": lambda: (ts.bitap_ir((b"ly", b"re", b"qu")),),
    "fused K=3": lambda: tuple(ts.pattern_ir(p)
                               for p in ("e.*s", "x{40}y{40}", "ly$")),
}
# tuples of more frontier words than stream_matcher.TABLE_WORDS
OVER_CAP = {
    "9 Q13 patterns": lambda: tuple(ts.pattern_ir(like_to_regex(p))
                                    for p in Q13[:9]),
    "3 x{40}y{40}": lambda: tuple(ts.pattern_ir(p) for p in
                                  ("x{40}y{40}", "a{40}.*b{35}",
                                   "q[ab]{28,36}z")),
}
# the nodes of a Q13 pattern's byte half: its bit tests and range test
BYTE_HALF_C = ("(c & 1)", "(c & 2)", "(c & 4)", "(c & 8)", "(c & 16)",
               "(c & 224)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pallas(pm, plen, nn, pattern, lane_tile=128):
    import jax.numpy as jnp

    from duckdb_parquet_parser_tpu.ops.pallas.stream_matcher import (
        match_stream_pallas,
    )

    h, s = match_stream_pallas(jnp.asarray(pm.T), plen, nn, pattern,
                               max_steps=pm.shape[1], lane_tile=lane_tile,
                               inner=8, interpret=True)
    return np.asarray(h), np.asarray(s)


def _chunked(pm):
    """The kernel's layout of the page matrix `pm` [n, pitch]."""
    return stream_matcher.chunk_stream(
        torch.from_numpy(np.ascontiguousarray(pm.T)))


def _port(pm, plen, nn, patterns, device="cpu"):
    irs = tuple(ts.pattern_ir(p) for p in patterns)
    pt = _chunked(pm).to(device)
    return stream_matcher.match_stream(pt, torch.from_numpy(plen).to(device),
                                       torch.from_numpy(nn).to(device), irs)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_matches_interpret_pallas_multi_tile(pattern):
    # 300 pages at lane_tile=128: several grid tiles on the Pallas side
    pm, plen, nn = _pages(np.random.default_rng(12), n_pages=300,
                          vals_per_page=6, maxlen=18)
    h0, s0 = _pallas(pm, plen, nn, pattern)
    h1, s1 = _port(pm, plen, nn, (pattern,))
    np.testing.assert_array_equal(h1[0].numpy(), h0, err_msg=pattern)
    np.testing.assert_array_equal(s1.numpy(), s0, err_msg=pattern)


@pytest.mark.parametrize("patterns", FUSED)
def test_fused_patterns_match_interpret_pallas(patterns):
    pm, plen, nn = _pages(np.random.default_rng(4), n_pages=150,
                          vals_per_page=5, maxlen=16)
    h0, s0 = _pallas(pm, plen, nn, tuple(patterns))
    h1, s1 = _port(pm, plen, nn, patterns)
    assert h1.shape == (len(patterns), 150)
    np.testing.assert_array_equal(h1.numpy(), h0)
    np.testing.assert_array_equal(s1.numpy(), s0)


def test_inactive_pad_lanes():
    """37 pages: the Pallas side pads lanes to its tile quantum; padded
    lanes must not show, and a zero-length lane section walks nothing."""
    pm, plen, nn = _pages(np.random.default_rng(3), n_pages=37,
                          vals_per_page=3, maxlen=12)
    plen[5], nn[5] = 0, 0
    h0, s0 = _pallas(pm, plen, nn, "a.*z")
    h1, s1 = _port(pm, plen, nn, ("a.*z",))
    assert h1.shape == (1, 37) and s1.shape == (37,)
    np.testing.assert_array_equal(h1[0].numpy(), h0)
    np.testing.assert_array_equal(s1.numpy(), s0)
    assert int(s1[5]) == 0 and int(h1[0, 5]) == 0


@pytest.mark.parametrize("pattern", ["a.*z", "[abq]{9}"])
def test_matches_split_steps_pallas(monkeypatch, pattern):
    """The Pallas split-steps body (state carried across step blocks) and
    the port's one kernel give the same counts."""
    pm, plen, nn = _pages(np.random.default_rng(31), n_pages=500,
                          vals_per_page=5, maxlen=20)
    monkeypatch.setenv("DPQ_STEP_BLOCKS", "2")
    monkeypatch.setenv("DPQ_STREAMS", "16")
    h0, s0 = _pallas(pm, plen, nn, pattern)
    h1, s1 = _port(pm, plen, nn, (pattern,))
    np.testing.assert_array_equal(h1[0].numpy(), h0)
    np.testing.assert_array_equal(s1.numpy(), s0)


def test_steps_bound_stops_the_walk():
    pm, plen, nn = _pages(np.random.default_rng(8), n_pages=40)
    irs = (ts.pattern_ir("a.*z"),)
    pt = torch.from_numpy(np.ascontiguousarray(pm.T))
    steps = int(plen.max()) // 2
    h1, s1 = stream_matcher.match_stream(_chunked(pm), torch.from_numpy(plen),
                                         torch.from_numpy(nn), irs, steps)
    h0, s0 = stream_matcher.match_stream_plain(pt[:steps].contiguous(),
                                               torch.from_numpy(plen),
                                               torch.from_numpy(nn), irs)
    assert torch.equal(h1, h0) and torch.equal(s1, s0)
    assert int(s1.sum()) < int(nn.sum())


def test_render_shares_one_library_per_tuple_set():
    irs = [(ts.pattern_ir(p),) for p in PATTERNS[:3]]
    src = stream_matcher.render(irs + irs[:1])
    tags = {stream_matcher.tag_of(t) for t in irs}
    assert len(tags) == 3
    for t in tags:
        assert src.count(f"dpq_stream_launch_{t}(") == 1
    assert "#include <cuda_runtime.h>" in src


def _at_zero_state(ir, node: int, c: int) -> int:
    """Node `node` of `ir` at byte `c` with every register 0, in Python
    integers (bitprog's constant folding, not its PyTorch evaluator)."""
    vals: list = []
    for op, kind, args in ir.nodes[:node + 1]:
        if op == "const":
            v = args[0]
        elif op == "input":
            v = c if args[0] == "c" else 0
        elif op == "cast":
            v = int(vals[args[0]])
        elif op == "not":
            v = 1 - vals[args[0]] if kind == tb.BOOL else ~vals[args[0]]
        elif op in ("shl", "shr"):
            v = tb._fold(op, vals[args[0]], args[1])
        elif op == "where":
            v = vals[args[1]] if vals[args[0]] else vals[args[2]]
        else:
            v = tb._fold(op, vals[args[0]], vals[args[1]])
        vals.append(v)
    return int(vals[node])


def _rendered_table(irs) -> np.ndarray:
    """[words, 256] of the table in the tuple's rendered source."""
    tag = stream_matcher.tag_of(irs)
    m = re.search(rf"dpq_table_{tag}\[(\d+) \* 256\] = \{{(.*?)\}};",
                  stream_matcher.render([irs]), re.S)
    values = [int(x) for x in m[2].split(",")]
    return np.array(values, np.int64).reshape(int(m[1]), 256)


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_table_is_the_byte_frontier_at_every_byte(case):
    irs = TABLE_CASES[case]()
    fronts = [(ir, i) for ir in irs for i in tb.byte_frontier(ir)]
    assert 1 <= len(fronts) <= stream_matcher.TABLE_WORDS
    assert stream_matcher.table_words(irs) == len(fronts)
    want = np.array([[_at_zero_state(ir, i, c) for c in range(256)]
                     for ir, i in fronts])
    np.testing.assert_array_equal(_rendered_table(irs), want)


@pytest.fixture(scope="module")
def table_lib(tmp_path_factory):
    """The host walks of TABLE_CASES and OVER_CAP, built with g++."""
    tuples = [f() for f in (*TABLE_CASES.values(), *OVER_CAP.values())]
    return k1_host.build(tuples, tmp_path_factory.mktemp("table"))


def _all_bytes_pages():
    """Pages of values of every byte value (NUL and bytes >= 0x80 too),
    zero-length values among them."""
    return _pages(np.random.default_rng(22), n_pages=200, vals_per_page=9,
                  maxlen=40, alphabet=bytes(range(256)))


def _host_against_plain(lib, irs):
    """The host walk of `irs` and the plain walk on all-byte pages and on
    the chunk-edge lanes, under each cut of PAGE_EDGE_STEPS."""
    for pm, plen, nn in (_all_bytes_pages(), page_edge(list(PAGE_EDGES))):
        pt = torch.from_numpy(np.ascontiguousarray(pm.T))
        for steps in PAGE_EDGE_STEPS:
            hits, seen = k1_host.walk(lib, irs, pm, plen, nn, steps)
            h0, s0 = stream_matcher.match_stream_plain(
                pt, torch.from_numpy(plen), torch.from_numpy(nn), irs, steps)
            np.testing.assert_array_equal(hits, h0.numpy(), err_msg=f"{steps}")
            np.testing.assert_array_equal(seen, s0.numpy(), err_msg=f"{steps}")


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_host_walk_with_table_matches_plain(table_lib, case):
    _host_against_plain(table_lib, TABLE_CASES[case]())


@pytest.mark.parametrize("case", list(OVER_CAP))
def test_tuple_over_the_cap_computes_its_byte_half(table_lib, case):
    irs = OVER_CAP[case]()
    words = sum(len(tb.byte_frontier(ir)) for ir in irs)
    assert words > stream_matcher.TABLE_WORDS
    assert stream_matcher.table_words(irs) == 0
    src = stream_matcher.render([irs])
    assert "dpq_table_" not in src and "tab[" not in src
    _host_against_plain(table_lib, irs)


@pytest.mark.parametrize("like", Q13)
def test_chunk_loop_holds_no_byte_half(like):
    """The unrolled byte step of a Q13 pattern reads its mask from the
    table and computes none of the byte half's nodes."""
    irs = (ts.pattern_ir(like_to_regex(like)),)
    src = stream_matcher.render([irs])
    step = src[src.index("for (int j = 0; j < 16; ++j) {"):
               src.index("c0 += 16;")]
    assert "tw[j]" in step
    assert not [x for x in BYTE_HALF_C if x in step]
    whole = stream_matcher.render([OVER_CAP["9 Q13 patterns"]()])
    assert all(x in whole for x in BYTE_HALF_C)


@pytest.mark.parametrize("steps", [1, 15, 16, 17, 48, 75])
def test_stream_layout_round_trips(steps):
    """chunk_stream puts bytes [16 c, 16 c + 16) of lane j at [c, j, :],
    zero-padded; unchunk_stream gives the stream back, both ways."""
    rng = np.random.default_rng(steps)
    stream = torch.from_numpy(rng.integers(1, 256, (steps, 7), dtype=np.uint8))
    chunked = stream_matcher.chunk_stream(stream)
    chunks = -(-steps // 16)
    assert chunked.shape == (chunks, 7, 16) and chunked.is_contiguous()
    padded = np.zeros((chunks * 16, 7), np.uint8)
    padded[:steps] = stream.numpy()
    for c in range(chunks):
        for j in (0, 3, 6):
            np.testing.assert_array_equal(chunked[c, j].numpy(),
                                          padded[16 * c:16 * c + 16, j])
    assert torch.equal(stream_matcher.unchunk_stream(chunked, steps), stream)
    full = stream_matcher.unchunk_stream(chunked)
    assert full.shape == (chunks * 16, 7)
    assert torch.equal(stream_matcher.chunk_stream(full), chunked)


def test_wrapper_rejects_the_unchunked_stream():
    pm, plen, nn = _pages(np.random.default_rng(8), n_pages=4)
    with pytest.raises(ValueError):
        stream_matcher.match_stream(
            torch.from_numpy(np.ascontiguousarray(pm.T)),
            torch.from_numpy(plen), torch.from_numpy(nn),
            (ts.pattern_ir("a"),))


def test_unsupported_device_raises():
    t = torch.zeros((1, 2, 16), dtype=torch.uint8, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        stream_matcher.match_stream(t, lens, lens, (ts.pattern_ir("a"),))


@pytest.mark.cuda
@pytest.mark.parametrize("patterns", [(p,) for p in PATTERNS] + FUSED)
def test_kernel_matches_plain(cuda, patterns):
    pm, plen, nn = _pages(np.random.default_rng(12), n_pages=1000,
                          vals_per_page=6, maxlen=18)
    irs = tuple(ts.pattern_ir(p) for p in patterns)
    pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(cuda)
    pl, nv = torch.from_numpy(plen).to(cuda), torch.from_numpy(nn).to(cuda)
    before = stream_matcher.launches
    h1, s1 = stream_matcher.match_stream(stream_matcher.chunk_stream(pt), pl,
                                         nv, irs)
    h0, s0 = stream_matcher.match_stream_plain(pt, pl, nv, irs)
    torch.cuda.synchronize()
    assert stream_matcher.launches == before + 1
    assert torch.equal(h1, h0) and torch.equal(s1, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", list(K1_EDGE_WALKS))
def test_kernel_chunk_edges_match_plain(cuda, walk):
    """The kernel at the edges of its chunks (every lane of PAGE_EDGES in
    one launch), under cuts of `steps` that land in prefixes and values."""
    pm, plen, nn = page_edge(list(PAGE_EDGES))
    irs = k1_edge_irs(walk)
    pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(cuda)
    pl, nv = torch.from_numpy(plen).to(cuda), torch.from_numpy(nn).to(cuda)
    chunked = stream_matcher.chunk_stream(pt)
    for steps in PAGE_EDGE_STEPS:
        before = stream_matcher.launches
        h1, s1 = stream_matcher.match_stream(chunked, pl, nv, irs, steps)
        h0, s0 = stream_matcher.match_stream_plain(pt, pl, nv, irs, steps)
        torch.cuda.synchronize()
        assert stream_matcher.launches == before + 1
        assert torch.equal(h1, h0) and torch.equal(s1, s0), steps


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TABLE_CASES) + list(OVER_CAP))
def test_kernel_table_cases_match_plain(cuda, case):
    """The kernel with its byte half from the table (or, over the cap,
    computed) on all-byte pages and the chunk-edge lanes, under each cut
    of PAGE_EDGE_STEPS."""
    irs = {**TABLE_CASES, **OVER_CAP}[case]()
    for pm, plen, nn in (_all_bytes_pages(), page_edge(list(PAGE_EDGES))):
        pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(cuda)
        pl = torch.from_numpy(plen).to(cuda)
        nv = torch.from_numpy(nn).to(cuda)
        chunked = stream_matcher.chunk_stream(pt)
        for steps in PAGE_EDGE_STEPS:
            h1, s1 = stream_matcher.match_stream(chunked, pl, nv, irs, steps)
            h0, s0 = stream_matcher.match_stream_plain(pt, pl, nv, irs, steps)
            torch.cuda.synchronize()
            assert torch.equal(h1, h0) and torch.equal(s1, s0), steps


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["Q13 %special%packages%", "9 Q13 patterns"])
def test_kernel_counts_table_launches(cuda, case):
    """`table_launches`, and `k1_table_launches` while a profiler records,
    count the launches whose byte half came from the table."""
    irs = {**TABLE_CASES, **OVER_CAP}[case]()
    pm, plen, nn = _all_bytes_pages()
    pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(cuda)
    args = (stream_matcher.chunk_stream(pt), torch.from_numpy(plen).to(cuda),
            torch.from_numpy(nn).to(cuda), irs)
    stream_matcher.match_stream(*args)  # built before the count
    table = 1 if stream_matcher.table_words(irs) else 0
    launches, tables = stream_matcher.launches, stream_matcher.table_launches
    counted = tracing.counters().get("k1_table_launches", 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        stream_matcher.match_stream(*args)
    stream_matcher.match_stream(*args)  # not counted: no profiler records
    torch.cuda.synchronize()
    assert stream_matcher.launches == launches + 2
    assert stream_matcher.table_launches == tables + 2 * table
    assert tracing.counters().get("k1_table_launches", 0) == counted + table


@pytest.mark.cuda
def test_kernel_checks_its_inputs(cuda):
    pt = torch.zeros((1, 4, 16), dtype=torch.uint8, device=cuda)
    bad = torch.zeros(4, dtype=torch.int64, device=cuda)
    ok = torch.zeros(4, dtype=torch.int32, device=cuda)
    irs = (ts.pattern_ir("a"),)
    with pytest.raises(ValueError):
        stream_matcher.match_stream(pt, bad, ok, irs)
    with pytest.raises(ValueError):
        stream_matcher.match_stream(pt.expand(2, 4, 16), ok, ok, irs)


SASS = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x0 */
                                                                             /* 0x1 */
        /*0010*/               @P0 EXIT ;                                    /* 0x0 */
        /*0020*/                   LDG.E.128.CONSTANT R8, desc[UR4][R14.64] ;/* 0x0 */
        /*0030*/                   LOP3.LUT R5, R5, 0xff, RZ, 0xc0, !PT ;    /* 0x0 */
        /*0040*/                   IMAD.MOV.U32 R11, RZ, RZ, R16 ;           /* 0x0 */
        /*0050*/                   SEL R4, R4, RZ, !P3 ;                     /* 0x0 */
        /*0060*/              @!P1 BRA P2, 0x30 ;                            /* 0x0 */
        /*0070*/              @!P0 BRA 0x20 ;                                /* 0x0 */
        /*0080*/                   EXIT ;                                    /* 0x0 */
        /*0090*/                   BRA 0x90;                                 /* 0x0 */
"""


def test_loop_instructions_counts_the_innermost_loop():
    """The measuring aid behind K1's operation bound: the opcodes between
    the target of the shortest backward branch and the branch."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import build

    assert build.loop_instructions(SASS) == {"LOP3": 1, "IMAD": 1, "SEL": 1,
                                             "BRA": 1}
    assert build.loop_instructions("  /*0000*/  EXIT ;  /* 0x0 */") == {}
