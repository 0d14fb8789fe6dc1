"""K3, the table-DFA walk (duckdb_parquet_parser_tpu_torch/ops/kernels/
dfa_walk.py, csrc/dfa_walk.cu), against the JAX package's table walks.

* The port's plain page walk against `ops/strings.match_payload_stream` of
  the JAX package, through its matrix-unit transition (`use_mxu=True`, run
  by jnp on the CPU; only for automata under 256 states, which bf16 holds
  exactly) and its numpy gather (`xp=np`); the port's per-value walk
  (`dfa_walk.value_walk` on the CPU) against `ops/scan.dfa_match` in
  both forms.
* The kernel's own walks, `csrc/dfa_walk.cu` built for the host with g++,
  against the same references: the three table-DFA patterns, random tables
  up to 4,096 states and 256 byte classes, zero-length values, lanes with
  no value, lanes longer than `steps`, a length prefix that reaches bit 31,
  rows that are and are not 16-byte aligned; the page walk with the folded
  and the packed table, and the bytewise walk it replaced, at the edges of
  its 16-byte chunks (`PAGE_EDGES`).
* The routes that reach K3 (`ResidentColumn.scan`, `scan_streaming`,
  `scan_batched`, `matching_rows`, `single_chip_forward`, a one-rank
  `distributed_scan`, `scaling_bench`) on a file with nulls and dictionary
  pages, against the JAX package's answers and the native scan.
* `cuda`-marked: the kernel against its plain version on the card, a CUDA
  route that never calls the plain loop, and the wrapper's checks.

Tolerance 0: every output is an integer count or a boolean.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from duckdb_parquet_parser_tpu_torch.host.schema import ParquetType
from duckdb_parquet_parser_tpu_torch.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from duckdb_parquet_parser_tpu_torch.ops import scan as port_scan
from duckdb_parquet_parser_tpu_torch.ops import strings
from duckdb_parquet_parser_tpu_torch.ops.kernels import build, dfa_walk
from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher
from duckdb_parquet_parser_tpu_torch.ops.regex import DFA, compile_pattern

# patterns outside the register-machine family: the table DFA walks them
TABLE_PATTERNS = ["(furiously|carefully) (express|regular)+ (deposits|requests)",
                  "(ly )+requests", "[a-z]+ly (final|bold)+ "]
VOCAB = [b"furiously", b"carefully", b"express", b"regular", b"deposits",
         b"requests", b"ly", b"slyly", b"final", b"bold", b"quickly",
         b"ideas"]
# (states, byte classes) of the random tables; under 256 states the JAX
# package's matrix-unit walk is exact, above it only its numpy gather is
RANDOM_TABLES = [(1, 1), (7, 3), (60, 256), (255, 40), (300, 256),
                 (4096, 256)]


def _value(rng) -> bytes:
    """A value of 0-6 vocabulary words (sometimes with a trailing space)."""
    n = int(rng.integers(0, 7))
    s = b" ".join(VOCAB[int(k)] for k in rng.integers(0, len(VOCAB), n))
    return s + (b" " if rng.random() < 0.3 else b"")


def _word_pages(rng, n_pages=80, vals_per_page=9):
    """PLAIN BYTE_ARRAY pages of vocabulary values, zero-length ones among
    them: ([n, pitch] u8, plen, nn)."""
    payloads = []
    for _ in range(n_pages):
        vals = [_value(rng) for _ in range(int(rng.integers(1, vals_per_page)))]
        payloads.append((b"".join(len(v).to_bytes(4, "little") + v
                                  for v in vals), len(vals)))
    return _matrix(payloads)


def _byte_pages(rng, n_pages=40, vals_per_page=7, maxlen=30):
    """PLAIN BYTE_ARRAY pages of random bytes: ([n, pitch] u8, plen, nn)."""
    payloads = []
    for _ in range(n_pages):
        vals = [rng.integers(0, 256, int(rng.integers(0, maxlen)),
                             dtype=np.uint8).tobytes()
                for _ in range(int(rng.integers(1, vals_per_page + 1)))]
        payloads.append((b"".join(len(v).to_bytes(4, "little") + v
                                  for v in vals), len(vals)))
    return _matrix(payloads)


def _matrix(payloads):
    """([n, pitch] u8, plen, nn) of (payload, value count) pairs."""
    pitch = max(len(p) for p, _ in payloads) + 8
    pm = np.zeros((len(payloads), pitch), np.uint8)
    for i, (p, _n) in enumerate(payloads):
        pm[i, :len(p)] = np.frombuffer(p, np.uint8)
    return (pm, np.array([len(p) for p, _ in payloads], np.int32),
            np.array([n for _, n in payloads], np.int32))


def _random_dfa(rng, n_states: int, n_classes: int) -> DFA:
    """A random automaton over `n_classes` byte classes (each used)."""
    class_of = np.concatenate([np.arange(n_classes),
                               rng.integers(0, n_classes, 256 - n_classes)])
    class_of = rng.permutation(class_of)
    by_class = rng.integers(0, n_states, (n_states, n_classes))
    table = by_class[:, class_of].astype(np.int32)
    return DFA(table, rng.random(n_states) < 0.4, f"random {n_states}x"
               f"{n_classes}")


def _case(name: str):
    """(dfa, pm, plen, nn) of a named case: a pattern over vocabulary
    pages, or a random table over random bytes."""
    if name.startswith("random"):
        s, c = (int(x) for x in name.split()[1].split("x"))
        rng = np.random.default_rng(s * 1000 + c)
        return (_random_dfa(rng, s, c),) + _byte_pages(rng)
    rng = np.random.default_rng(TABLE_PATTERNS.index(name) + 7)
    return (compile_pattern(name),) + _word_pages(rng)


CASES = TABLE_PATTERNS + [f"random {s}x{c}" for s, c in RANDOM_TABLES]
MXU_CASES = [c for c in CASES if not c.startswith("random")
             or int(c.split()[1].split("x")[0]) < 256]


def _jax_stream(dfa, pm, plen, nn, steps=None, use_mxu=False):
    from duckdb_parquet_parser_tpu.ops.strings import match_payload_stream

    if use_mxu:
        import jax.numpy as jnp

        h, s = match_payload_stream(jnp, jnp.asarray(pm), plen, nn,
                                    dfa.table, dfa.accept, max_steps=steps,
                                    use_mxu=True)
    else:
        h, s = match_payload_stream(np, pm, plen, nn, dfa.table, dfa.accept,
                                    max_steps=steps)
    return np.asarray(h), np.asarray(s)


def _port_stream(dfa, pm, plen, nn, steps=None):
    chunked = stream_matcher.chunk_stream(
        torch.from_numpy(np.ascontiguousarray(pm.T)))
    h, s = dfa_walk.stream_walk(chunked, torch.from_numpy(plen),
                                torch.from_numpy(nn), dfa, steps)
    return h.numpy(), s.numpy()


# ── the plain walks against the JAX package ────────────────────────────────


def test_table_patterns_need_the_table_dfa():
    for p in TABLE_PATTERNS:
        assert strings.pattern_ir(p) is None, p
        assert port_scan.resolve_matchers([p])[0] == (), p


@pytest.mark.parametrize("case", MXU_CASES)
def test_plain_page_walk_matches_jax_mxu(case):
    dfa, pm, plen, nn = _case(case)
    h1, s1 = _port_stream(dfa, pm, plen, nn)
    h0, s0 = _jax_stream(dfa, pm, plen, nn, use_mxu=True)
    np.testing.assert_array_equal(h1, h0, err_msg=case)
    np.testing.assert_array_equal(s1, s0, err_msg=case)
    assert h0.sum() > 0 or case.startswith("random"), "no value matched"


@pytest.mark.parametrize("case", CASES)
def test_plain_page_walk_matches_jax_numpy(case):
    dfa, pm, plen, nn = _case(case)
    steps = pm.shape[1] - 13  # lanes longer than the walk are cut
    for st in (None, steps):
        h1, s1 = _port_stream(dfa, pm, plen, nn, st)
        h0, s0 = _jax_stream(dfa, pm, plen, nn, st)
        np.testing.assert_array_equal(h1, h0, err_msg=f"{case} steps={st}")
        np.testing.assert_array_equal(s1, s0, err_msg=f"{case} steps={st}")


def _values(rng, n=300, pitch=24, alphabet=None):
    """chars [n, pitch] u8 zero-padded past each length, lens [n] int32
    (0 and longer than the pitch among them)."""
    if alphabet is None:
        vals = [_value(rng) for _ in range(n)]
    else:
        letters = np.frombuffer(alphabet, np.uint8)
        vals = [bytes(rng.choice(letters, int(rng.integers(0, pitch + 1))))
                for _ in range(n)]
    chars = np.zeros((n, pitch), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, v in enumerate(vals):
        chars[i, :min(len(v), pitch)] = np.frombuffer(v[:pitch], np.uint8)
        lens[i] = len(v)
    lens[:2] = [0, pitch + 9]
    return chars, lens


def _value_case(case: str, pitch: int):
    dfa, *_ = _case(case)
    rng = np.random.default_rng(pitch)
    alphabet = bytes(range(256)) if case.startswith("random") else None
    return (dfa,) + _values(rng, pitch=pitch, alphabet=alphabet)


@pytest.mark.parametrize("pitch", [32, 13])
@pytest.mark.parametrize("case", CASES)
def test_plain_value_walk_matches_jax_dfa_match(case, pitch):
    import jax.numpy as jnp

    from duckdb_parquet_parser_tpu.ops.scan import dfa_match

    dfa, chars, lens = _value_case(case, pitch)
    got = dfa_walk.value_walk(torch.from_numpy(chars), torch.from_numpy(lens),
                              dfa).numpy()
    np.testing.assert_array_equal(got, dfa_match(np, chars, lens, dfa.table,
                                                 dfa.accept))
    np.testing.assert_array_equal(
        got, np.asarray(dfa_match(jnp, jnp.asarray(chars), lens, dfa.table,
                                  dfa.accept)))


# ── the kernel's own walks, built for the host ─────────────────────────────


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/dfa_walk.cu built for the host with g++ (its CUDA half is
    preprocessed out)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("dfa_walk")
    so = d / "dfa_walk.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-x", "c++", "-o", str(so),
                    str(build.CSRC / "dfa_walk.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dpq_dfa_stream_host.argtypes = [vp, ctypes.c_longlong, i, vp, vp, vp,
                                        i, i, i, i, vp, vp]
    lib.dpq_dfa_stream_host.restype = None
    lib.dpq_dfa_stream_bytewise_host.argtypes = [vp, ctypes.c_longlong, i, vp,
                                                 vp, vp, i, i, vp, vp]
    lib.dpq_dfa_stream_bytewise_host.restype = None
    lib.dpq_dfa_values_host.argtypes = [vp, ctypes.c_longlong, i, vp, vp, i,
                                        i, i, i, vp]
    lib.dpq_dfa_values_host.restype = None
    return lib


def _host_stream(lib, dfa, pm, plen, nn, steps=None, walk="folded"):
    """The g++ build of the kernel's page walk over the kernel's layouts:
    `walk` "folded" (the folded table, for automata up to FOLD_MAX_STATES
    states; the packed one above), "packed", or "bytewise" (the byte loop
    the kernel replaced)."""
    n = pm.shape[0]
    steps = pm.shape[1] if steps is None else steps
    chunked = stream_matcher.chunk_stream(
        torch.from_numpy(np.ascontiguousarray(pm.T))).numpy()
    packed = dfa_walk.pack_table(dfa)
    plen = np.ascontiguousarray(plen, np.int32)
    nn = np.ascontiguousarray(nn, np.int32)
    hits = np.full(n, -7, np.int32)
    seen = np.full(n, -7, np.int32)
    args = (chunked.ctypes.data, n, steps, plen.ctypes.data, nn.ctypes.data,
            packed.data.ctypes.data)
    if walk == "bytewise":
        lib.dpq_dfa_stream_bytewise_host(*args, packed.n_classes,
                                         packed.accept0, hits.ctypes.data,
                                         seen.ctypes.data)
    else:
        mode = dfa_walk.FOLDED if walk == "folded" else dfa_walk.PACKED_SHARED
        lib.dpq_dfa_stream_host(*args, packed.n_states, packed.n_classes,
                                packed.accept0, mode, hits.ctypes.data,
                                seen.ctypes.data)
    return hits, seen


def _host_walks(dfa) -> list[str]:
    """The host page walks that apply to `dfa`."""
    folds = dfa.byte_classes().table.shape[0] <= dfa_walk.FOLD_MAX_STATES
    return ["folded"] * folds + ["packed", "bytewise"]


def _host_values(lib, dfa, chars, lens, mode=dfa_walk.FOLDED):
    """The g++ build of the kernel's per-value walk: the same windows,
    loads and byte steps, with the folded table (automata up to
    FOLD_MAX_STATES states) or the packed one."""
    packed = dfa_walk.pack_table(dfa)
    lens = np.ascontiguousarray(lens, np.int32)
    out = np.full(chars.shape[0], 7, np.uint8)
    lib.dpq_dfa_values_host(chars.ctypes.data, chars.shape[0], chars.shape[1],
                            lens.ctypes.data, packed.data.ctypes.data,
                            packed.n_states, packed.n_classes, packed.accept0,
                            mode, out.ctypes.data)
    return out.astype(bool)


def _host_modes(dfa):
    """The per-value walk's table modes that apply to `dfa`."""
    folds = dfa.byte_classes().table.shape[0] <= dfa_walk.FOLD_MAX_STATES
    return [dfa_walk.FOLDED] * folds + [dfa_walk.PACKED_SHARED]


@pytest.mark.parametrize("case", CASES)
def test_host_page_walk_matches_jax(host_lib, case):
    dfa, pm, plen, nn = _case(case)
    refs = [_jax_stream(dfa, pm, plen, nn)]
    if case in MXU_CASES:
        refs.append(_jax_stream(dfa, pm, plen, nn, use_mxu=True))
    for walk in _host_walks(dfa):
        hits, seen = _host_stream(host_lib, dfa, pm, plen, nn, walk=walk)
        for h0, s0 in refs:
            np.testing.assert_array_equal(hits, h0, err_msg=f"{case} {walk}")
            np.testing.assert_array_equal(seen, s0, err_msg=f"{case} {walk}")
    h1, s1 = _port_stream(dfa, pm, plen, nn)
    np.testing.assert_array_equal(hits, h1)
    np.testing.assert_array_equal(seen, s1)


def _edge_pages():
    """Lanes the boundary control must get right: only zero-length values,
    no value at all (nn = 0: a lane of a dictionary page), more values
    stored than `nn` counts, a page cut short by `plen`, and a length
    prefix whose last byte reaches bit 31 (the value never ends)."""
    vals = [[b"", b"", b""], [b"slyly final "], [], [b"ly requests", b"x"],
            [b"carefully express deposits", b"ly ly requests"],
            [b"bold ly final ", b"quickly"]]
    pages = [b"".join(len(v).to_bytes(4, "little") + v for v in vs)
             for vs in vals]
    huge = (0x80000005).to_bytes(4, "little") + b"ly requests" * 3
    pages.append(b"\x02\x00\x00\x00ly" + huge)
    nn = np.array([3, 1, 0, 1, 2, 2, 2], np.int32)
    pitch = max(len(p) for p in pages) + 20
    pm = np.zeros((len(pages), pitch), np.uint8)
    for i, p in enumerate(pages):
        pm[i, :len(p)] = np.frombuffer(p, np.uint8)
    plen = np.array([len(p) for p in pages], np.int32)
    plen[5] = 4 + len(vals[5][0]) + 6  # cut inside the second value
    return pm, plen, nn


@pytest.mark.parametrize("pattern", TABLE_PATTERNS + ["^$", "(x|)"])
def test_host_page_walk_edges(host_lib, pattern):
    dfa = compile_pattern(pattern)
    pm, plen, nn = _edge_pages()
    for steps in (None, 9, pm.shape[1] - 17):
        h0, s0 = _jax_stream(dfa, pm, plen, nn, steps)
        for h, s in ([_host_stream(host_lib, dfa, pm, plen, nn, steps, walk)
                      for walk in _host_walks(dfa)]
                     + [_port_stream(dfa, pm, plen, nn, steps)]):
            np.testing.assert_array_equal(h, h0, err_msg=f"steps={steps}")
            np.testing.assert_array_equal(s, s0, err_msg=f"steps={steps}")
    assert s0[2] == 0 and s0[6] == 1


# The page walk's edges (csrc/dfa_walk.cu: a lane's 16-byte chunks walked
# unrolled under a mask of the bytes inside the value; a boundary handled
# once a value, its 4-byte prefix read from two chunks): {name: lanes}, a
# lane (items, nn, plen) with None for the page's value count and length.
# An item is a value (bytes, after its length prefix), a bare length prefix
# (int) or raw bytes (bytearray).
_TEXT = b"carefully express deposits ly requests slyly final bold " * 3


def _w(n: int, at: int = 0) -> bytes:
    return _TEXT[at:at + n]


def _prefix_edge(k: int):
    """Lanes whose length prefixes start at byte k of their chunks (one
    straddles into the next chunk where k > 12)."""
    return [([_w(k - 4)] + [_w(12, 27)] * 6, None, None),
            ([_w(k - 4, 5)] + [_w(28)] * 3 + [_w(44, 10)], None, None),
            ([_w(k - 4)] + [b""] * 3 + [_w(12, 27)], None, None)]


PAGE_EDGES = {
    **{f"prefix at byte {k}": _prefix_edge(k) for k in (12, 13, 14, 15)},
    "value ends on byte 15": [
        ([_w(12)] + [_w(12, 3)] * 5, None, None),
        ([_w(28)] + [_w(28, 9)] * 2, None, None),
        ([_w(12), b"", _w(8), b"", b""], None, None)],
    "zero-length values across chunks": [
        ([_w(6)] + [b""] * 8 + [_w(12, 27)], None, None),
        ([b""] * 10 + [_w(20)], None, None),
        ([_w(2)] + [b""] * 5, None, None)],
    "plen in a prefix": [([_w(12), _w(28, 3), _w(20, 7)], None, pl)
                         for pl in (16, 17, 18, 19, 49)],
    "plen in a value": [([_w(12), _w(28, 3), _w(20, 7)], None, pl)
                        for pl in (20, 30, 47, 48)],
    "nn mid-chunk": [([_w(5), _w(3), _w(7), _w(12, 27)], nv, None)
                     for nv in (1, 2, 3)],
    "bit-31 length": [
        ([_w(2), 0x80000005, bytearray(_w(33))], None, None),
        ([_w(11), 0xFFFFFFFF, bytearray(_w(20))], None, None),
        ([_w(11), 500, bytearray(_w(20))], None, None),
        ([0x80000000, bytearray(_w(40))], None, None)],
    "lanes with nn = 0 or plen = 0": [
        ([_w(12, 27), _w(5)], 0, None), ([_w(12, 27)], 1, 0),
        ([], 0, 0), ([_w(3)], 1, 3)],
}
# cuts of the walk at bytes inside prefixes and values of the edges
PAGE_EDGE_STEPS = (None, 13, 16, 20, 31, 47)
# automata of the page edges: the folded table (the pattern's 44 states,
# and ^$ and a random one whose empty string is accepted) and the packed
# table of a random 300-state one
PAGE_EDGE_DFAS = [TABLE_PATTERNS[0], "^$", "random 60x256 accept0",
                  "random 300x256 accept0"]


def _page_edge_dfa(name: str) -> DFA:
    if not name.startswith("random"):
        return compile_pattern(name)
    dfa = _edge_dfa(name.split()[0] + " " + name.split()[1])
    accept = dfa.accept.copy()
    accept[0] = True
    return DFA(dfa.table, accept, name)


def _page_edge(names) -> tuple:
    """([n, pitch] u8, plen, nn) of the lanes of the edges `names`."""
    pages, plens, nns = [], [], []
    for name in names:
        for items, nv, pl in PAGE_EDGES[name]:
            page = b"".join(bytes(x) if isinstance(x, bytearray)
                            else x.to_bytes(4, "little") if isinstance(x, int)
                            else len(x).to_bytes(4, "little") + x
                            for x in items)
            pages.append(page)
            plens.append(len(page) if pl is None else pl)
            nns.append(sum(not isinstance(x, bytearray) for x in items)
                       if nv is None else nv)
    pm = np.zeros((len(pages), max(max(map(len, pages)) + 20, 64)),
                  np.uint8)
    for i, page in enumerate(pages):
        pm[i, :len(page)] = np.frombuffer(page, np.uint8)
    return pm, np.array(plens, np.int32), np.array(nns, np.int32)


@pytest.mark.parametrize("dfa_name", PAGE_EDGE_DFAS)
@pytest.mark.parametrize("edge", list(PAGE_EDGES))
def test_host_page_walk_chunk_edges(host_lib, edge, dfa_name):
    """The page walk with the folded and with the packed table, and the
    bytewise walk, against the JAX package's `match_payload_stream` at the
    edges of its chunks, under cuts of `steps` that land in prefixes and
    in values."""
    dfa = _page_edge_dfa(dfa_name)
    pm, plen, nn = _page_edge([edge])
    walks = ["packed", "bytewise"] + ["folded"] * (
        dfa.byte_classes().table.shape[0] <= dfa_walk.FOLD_MAX_STATES)
    assert dfa_name.startswith("random 300") == ("folded" not in walks)
    for steps in PAGE_EDGE_STEPS:
        h0, s0 = _jax_stream(dfa, pm, plen, nn, steps)
        for walk in walks:
            h, s = _host_stream(host_lib, dfa, pm, plen, nn, steps, walk)
            np.testing.assert_array_equal(h, h0, err_msg=f"{walk} {steps}")
            np.testing.assert_array_equal(s, s0, err_msg=f"{walk} {steps}")
        h, s = _port_stream(dfa, pm, plen, nn, steps)
        np.testing.assert_array_equal(h, h0)
        np.testing.assert_array_equal(s, s0)


@pytest.mark.parametrize("pitch", [32, 13])
@pytest.mark.parametrize("case", CASES)
def test_host_value_walk_matches_jax(host_lib, case, pitch):
    from duckdb_parquet_parser_tpu.ops.scan import dfa_match

    dfa, chars, lens = _value_case(case, pitch)
    want = dfa_match(np, chars, lens, dfa.table, dfa.accept)
    # the same rows at an address that is not 16-byte aligned
    buf = np.zeros(chars.size + 1, np.uint8)
    shifted = buf[1:].reshape(chars.shape)
    shifted[:] = chars
    for mode in _host_modes(dfa):
        for c in (chars, shifted):
            np.testing.assert_array_equal(
                _host_values(host_lib, dfa, c, lens, mode), want,
                err_msg=f"mode {mode}, aligned {c is chars}")


# The per-value walk's edges (csrc/dfa_walk.cu: a persistent grid of
# 512-thread blocks whose threads walk every stride-th row in windows of 64
# bytes, loaded 16, 8, 4 or 1 bytes at a time by the pitch and the
# address): {name: (L, P, lengths, byte offset of the first row)}.  Lengths
# "random" hold a 0 and one past the pitch; "same": every value fills its
# row; "skew": most values 0-3 bytes, a tenth past the pitch.  300,000 rows
# give an H100's grid (132 SMs x 1,024 threads) two or three rows a thread.
VALUE_EDGES = {
    "L=1": (1, 64, "random", 0),
    "L=31": (31, 64, "random", 0),
    "L=32": (32, 64, "random", 0),
    "L=33": (33, 64, "random", 0),
    "L=511": (511, 64, "random", 0),
    "L=512": (512, 64, "random", 0),
    "L=513": (513, 64, "random", 0),
    "L=2049": (2049, 64, "random", 0),
    "L=300000": (300_000, 64, "skew", 0),
    "P=13": (300, 13, "random", 0),
    "P=13 rows sliced": (300, 13, "random", 13),
    "P=64 offset 1": (300, 64, "random", 1),
    "P=64 offset 8": (300, 64, "random", 8),
    "P=20": (300, 20, "random", 0),
    "P=24": (300, 24, "random", 0),
    "P=200": (300, 200, "random", 0),
    "P=256": (300, 256, "random", 0),
    "same length": (1000, 64, "same", 0),
    "skew": (1000, 64, "skew", 0),
    "skew P=256": (1000, 256, "skew", 0),
}
# automata of the edge cases: the folded table, a packed one that can be
# staged (300 x 256, 153,856 bytes) and one that cannot (4,096 x 256)
EDGE_DFAS = [TABLE_PATTERNS[0], "random 300x256", "random 4096x256"]


def _edge_dfa(name: str) -> DFA:
    if name.startswith("random"):
        s, c = (int(x) for x in name.split()[1].split("x"))
        return _random_dfa(np.random.default_rng(s + c), s, c)
    return compile_pattern(name)


def _edge_values(name: str):
    """(chars [L, P] u8 inside a flat buffer at the edge's byte offset,
    lens [L] int32): rows cut from vocabulary text (the bytes past each
    length are text too, which the walk must not read)."""
    n, pitch, kind, offset = VALUE_EDGES[name]
    rng = np.random.default_rng(sorted(VALUE_EDGES).index(name))
    text = np.frombuffer(b" ".join(
        VOCAB[int(k)] for k in rng.integers(0, len(VOCAB), 60 + pitch)),
        np.uint8)
    starts = rng.integers(0, len(text) - pitch, n)
    buf = np.zeros(offset + n * pitch, np.uint8)
    chars = buf[offset:].reshape(n, pitch)
    chars[:] = text[starts[:, None] + np.arange(pitch)]
    if kind == "same":
        lens = np.full(n, pitch, np.int32)
    elif kind == "skew":
        lens = np.where(rng.random(n) < 0.9, rng.integers(0, 4, n),
                        pitch + 5).astype(np.int32)
    else:
        lens = rng.integers(0, pitch + 10, n).astype(np.int32)
        lens[:2] = [0, pitch + 9][:n]
    return chars, lens


@pytest.mark.parametrize("dfa_name", EDGE_DFAS[:2])
@pytest.mark.parametrize("edge", list(VALUE_EDGES))
def test_host_value_walk_edges(host_lib, edge, dfa_name):
    from duckdb_parquet_parser_tpu.ops.scan import dfa_match

    dfa = _edge_dfa(dfa_name)
    chars, lens = _edge_values(edge)
    want = dfa_match(np, np.ascontiguousarray(chars), lens, dfa.table,
                     dfa.accept)
    for mode in _host_modes(dfa):
        np.testing.assert_array_equal(
            _host_values(host_lib, dfa, chars, lens, mode), want,
            err_msg=f"mode {mode}")
    np.testing.assert_array_equal(
        dfa_walk.value_walk(torch.from_numpy(np.ascontiguousarray(chars)),
                            torch.from_numpy(lens), dfa).numpy(), want)


def test_value_mode_folds_small_automata():
    """Staged, an automaton of up to FOLD_MAX_STATES states walks the
    folded table (257 words a state), a larger one the packed table;
    unstaged, the packed table in device memory."""
    small = dfa_walk.pack_table(compile_pattern(TABLE_PATTERNS[0]))
    big = dfa_walk.pack_table(_edge_dfa("random 300x256"))
    assert small.n_states <= dfa_walk.FOLD_MAX_STATES < big.n_states
    assert dfa_walk.value_mode(small, 0, staged=True) == (
        dfa_walk.FOLDED, -(-1028 * small.n_states // 16) * 16)
    assert dfa_walk.value_mode(big, 0, staged=True) == (
        dfa_walk.PACKED_SHARED, len(big.data))
    for p in (small, big):
        assert dfa_walk.value_mode(p, 0, staged=False) == (
            dfa_walk.PACKED_GLOBAL, 0)


@pytest.mark.parametrize("values", [False, True])
def test_table_mode_of_each_walk(values):
    """Both walks take the same tables: staged, the folded one up to
    FOLD_MAX_STATES states and the packed one above; unstaged, the packed
    table in device memory.  Each walk and table has its own number in
    csrc/dfa_walk.cu's occupancy query."""
    small = dfa_walk.pack_table(compile_pattern(TABLE_PATTERNS[0]))
    big = dfa_walk.pack_table(_edge_dfa("random 300x256"))
    assert dfa_walk.table_mode(small, 0, values, staged=True) == (
        dfa_walk.FOLDED, -(-1028 * small.n_states // 16) * 16)
    assert dfa_walk.table_mode(big, 0, values, staged=True) == (
        dfa_walk.PACKED_SHARED, len(big.data))
    for p in (small, big):
        assert dfa_walk.table_mode(p, 0, values, staged=False) == (
            dfa_walk.PACKED_GLOBAL, 0)
    codes = {dfa_walk.walk_code(values, f) for f in (False, True)}
    assert codes == ({1, 2} if values else {0, 3})


def test_pack_table_layout():
    dfa = compile_pattern(TABLE_PATTERNS[0])
    packed = dfa_walk.pack_table(dfa)
    bc = dfa.byte_classes()
    assert (packed.n_states, packed.n_classes) == bc.table.shape
    assert packed.accept0 == int(dfa.accept[0])
    assert len(packed.data) % 16 == 0
    np.testing.assert_array_equal(packed.data[:256], bc.class_of)
    s, c = bc.table.shape
    entry = packed.data[256:256 + 2 * s * c].view("<u2").reshape(s, c)
    np.testing.assert_array_equal(entry & 0x7FFF, bc.table)
    np.testing.assert_array_equal((entry >> 15).astype(bool),
                                  dfa.accept[bc.table])
    big = DFA(np.zeros((dfa_walk.MAX_STATES + 1, 256), np.int32),
              np.zeros(dfa_walk.MAX_STATES + 1, bool), "")
    with pytest.raises(ValueError, match="states"):
        dfa_walk.pack_table(big)


def test_wrappers_check_their_inputs():
    dfa = compile_pattern(TABLE_PATTERNS[1])
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        dfa_walk.stream_walk(torch.zeros((1, 2, 8), dtype=torch.uint8), lens,
                             lens, dfa)
    with pytest.raises(ValueError):
        dfa_walk.value_walk(torch.zeros((2, 4), dtype=torch.int32), lens, dfa)
    meta = torch.zeros((1, 2, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dfa_walk.stream_walk(meta, lens.to("meta"), lens.to("meta"), dfa)
    with pytest.raises(ValueError, match="unsupported device"):
        dfa_walk.value_walk(torch.zeros((2, 4), dtype=torch.uint8,
                                        device="meta"), lens.to("meta"), dfa)
    # the yardstick runs on the card only, and checks as the wrapper does
    with pytest.raises(ValueError, match="unsupported device cpu"):
        dfa_walk.stream_walk_bytewise(torch.zeros((1, 2, 16),
                                                  dtype=torch.uint8),
                                      lens, lens, dfa)
    with pytest.raises(ValueError):
        dfa_walk.stream_walk_bytewise(torch.zeros((1, 2, 8),
                                                  dtype=torch.uint8),
                                      lens, lens, dfa)


# ── the routes that reach K3 ────────────────────────────────────────────────


def _file(path, rng) -> str:
    """Two PLAIN row groups of vocabulary values with nulls and one row
    group of few distinct values (dictionary pages)."""
    w = ParquetWriter(str(path), [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                             optional=True)],
                      key_value={"pad": "x" * 512})

    def col(n, pool=None):
        vals = ([_value(rng) for _ in range(n)] if pool is None
                else [pool[int(k)] for k in rng.integers(0, len(pool), n)])
        return [None if rng.random() < 0.1 else v for v in vals]

    w.write_row_group({"s": col(1500)})
    w.write_row_group({"s": col(1500, [_value(rng) for _ in range(9)])})
    w.write_row_group({"s": col(700)})
    w.close()
    return str(path)


@pytest.fixture(scope="module")
def words_file(tmp_path_factory):
    return _file(tmp_path_factory.mktemp("dfa_walk") / "w.parquet",
                 np.random.default_rng(41))


@pytest.fixture
def walks(monkeypatch):
    """Counts the calls of K3's page-walk wrapper (the calls go on)."""
    calls = []
    real = dfa_walk.stream_walk
    monkeypatch.setattr(dfa_walk, "stream_walk",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _same(a, b, msg=""):
    np.testing.assert_array_equal(a.page_gid, b.page_gid, err_msg=msg)
    np.testing.assert_array_equal(a.match_counts, b.match_counts, err_msg=msg)
    np.testing.assert_array_equal(a.value_counts, b.value_counts, err_msg=msg)


def _golden(path, pattern, negate):
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR
    from duckdb_parquet_parser_tpu.ops.scan import scan_batch

    return scan_batch(JR(path).prescan("s", pad_strings=8), pattern,
                      negate=negate, xp=np)


@pytest.mark.parametrize("negate", [False, True])
def test_resident_scan_matches_jax(words_file, walks, negate):
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR
    from duckdb_parquet_parser_tpu.models.scan import ResidentColumn as JRC

    col = ScanEngine(words_file).resident("s", device="cpu")
    for i, p in enumerate(TABLE_PATTERNS):
        n = len(walks)
        got = col.scan(p, negate=negate)
        assert len(walks) == n + sum(b["has_plain"] for b in col._buckets)
        _same(got, _golden(words_file, p, negate), p)
        if i == 0:  # the JAX column compiles per pattern: one is enough
            _same(got, JRC(JR(words_file), "s").scan(p, negate=negate), p)
    assert int(got.match_counts.sum()) > 0


@pytest.mark.parametrize("negate", [False, True])
def test_block_scans_match_jax(words_file, walks, negate):
    from duckdb_parquet_parser_tpu.models.scan import ScanEngine as JEngine

    eng, ref = ScanEngine(words_file), JEngine(words_file)
    p = TABLE_PATTERNS[0]
    _same(eng.scan_streaming("s", p, negate=negate, block_pages=4,
                             device="cpu"),
          ref.scan_streaming("s", p, negate=negate, block_pages=4))
    assert walks
    n = len(walks)
    _same(eng.scan_batched("s", p, negate=negate, batch_pages=8,
                           device="cpu"), _golden(words_file, p, negate))
    assert len(walks) > n


@pytest.mark.parametrize("pattern", TABLE_PATTERNS)
def test_matching_rows_matches_jax(words_file, pattern):
    from duckdb_parquet_parser_tpu.models.scan import ScanEngine as JEngine

    got = ScanEngine(words_file).matching_rows("s", pattern, device="cpu")
    np.testing.assert_array_equal(
        got, JEngine(words_file).matching_rows("s", pattern))
    assert len(got) == int(_golden(words_file, pattern,
                                   False).match_counts.sum()) > 0


def test_single_chip_forward_reaches_k3(tmp_path, walks):
    from duckdb_parquet_parser_tpu_torch.models.scan import (
        ResidentColumn,
        build_example_batch,
        single_chip_forward,
    )

    reader, batch = build_example_batch(str(tmp_path))
    pattern = "(wo|rd)+_[0-3]"
    assert strings.pattern_ir(pattern) is None
    fn, args = single_chip_forward(batch, pattern, device="cpu")
    counts = fn(*args).numpy()
    assert walks
    want = ResidentColumn(reader, "s", device="cpu").scan(pattern)
    np.testing.assert_array_equal(counts, want.match_counts)
    assert int(counts.sum()) > 0


def test_one_rank_distributed_scan_reaches_k3(words_file, walks):
    from duckdb_parquet_parser_tpu_torch.parallel.mesh import make_mesh

    eng = ScanEngine(words_file, mesh=make_mesh("cpu", "gloo"))
    p = TABLE_PATTERNS[2]
    res = eng.scan("s", p)
    assert walks
    want = ScanEngine(words_file).cold_scan("s", p, exact_counts=True,
                                            stats_prune=False)
    keep = res.page_gid >= 0
    order = np.argsort(res.page_gid[keep])
    np.testing.assert_array_equal(res.page_gid[keep][order], want.page_gid)
    np.testing.assert_array_equal(res.match_counts[keep][order],
                                  want.match_counts)
    assert res.totals.tolist() == [int(want.match_counts.sum()),
                                   int(want.value_counts.sum())]


def test_scaling_bench_walks_a_table_dfa(capsys, walks):
    import json

    from duckdb_parquet_parser_tpu_torch import scaling_bench

    assert scaling_bench.main(["--rows", "2000", "--reps", "1", "--device",
                               "cpu", "--backend", "gloo", "--pattern",
                               "(al|br)*avo"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["table"][0]["rows_per_s"] > 0 and walks


# ── on the card ─────────────────────────────────────────────────────────────


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda, case):
    """Both variants (the table in device memory, and staged in shared
    memory where it fits a block) and the one the wrapper picks."""
    dfa, pm, plen, nn = _case(case)
    pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(cuda)
    pl, nv = torch.from_numpy(plen).to(cuda), torch.from_numpy(nn).to(cuda)
    fits = (len(dfa_walk.pack_table(dfa).data)
            <= torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin)
    variants = [None, False] + [True] * fits
    before = dfa_walk.launches
    for staged in variants:
        for steps in (None, pm.shape[1] - 13):
            h1, s1 = dfa_walk.stream_walk(stream_matcher.chunk_stream(pt), pl,
                                          nv, dfa, steps, staged=staged)
            h0, s0 = dfa_walk.stream_walk_plain(pt, pl, nv, dfa, steps)
            assert torch.equal(h1, h0) and torch.equal(s1, s0)
        for pitch in (32, 13):
            _d, chars, lens = _value_case(case, pitch)
            c = torch.from_numpy(chars).to(cuda)
            ln = torch.from_numpy(lens).to(cuda)
            assert torch.equal(dfa_walk.value_walk(c, ln, dfa, staged=staged),
                               dfa_walk.value_walk_plain(c, ln, dfa))
    torch.cuda.synchronize()
    assert dfa_walk.launches == before + 4 * len(variants)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", list(VALUE_EDGES))
def test_value_kernel_edges_match_plain(cuda, edge):
    """The per-value walk at the edges of its blocks, grid, windows and
    loads, in every variant each automaton takes (the folded and the
    packed table staged, the packed table in device memory) and the one
    the wrapper picks, one launch a call."""
    chars, lens = _edge_values(edge)
    n, pitch, _kind, offset = VALUE_EDGES[edge]
    buf = torch.zeros(offset + n * pitch, dtype=torch.uint8, device=cuda)
    c = buf[offset:].view(n, pitch)
    c.copy_(torch.from_numpy(np.ascontiguousarray(chars)))
    assert c.is_contiguous() and (c.data_ptr() % 16 != 0) == (offset % 16 != 0)
    ln = torch.from_numpy(lens).to(cuda)
    index = cuda.index or 0
    for name in EDGE_DFAS:
        dfa = _edge_dfa(name)
        want = dfa_walk.value_walk_plain(c, ln, dfa)
        mode, staged_bytes = dfa_walk.value_mode(dfa_walk.pack_table(dfa),
                                                 index, True)
        fits = dfa_walk.blocks_per_sm(index, 1 + mode, staged_bytes) > 0
        variants = [None, False] + [True] * fits
        for staged in variants:
            before = dfa_walk.launches
            got = dfa_walk.value_walk(c, ln, dfa, staged=staged)
            assert dfa_walk.launches == before + 1
            assert torch.equal(got, want), (name, staged)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dfa_name", PAGE_EDGE_DFAS)
def test_page_kernel_edges_match_plain(cuda, dfa_name):
    """The page walk at the edges of its chunks (every lane of PAGE_EDGES
    in one launch), in every variant the automaton takes and the one the
    wrapper picks, one launch a call; the bytewise yardstick beside it,
    counting none."""
    dfa = _page_edge_dfa(dfa_name)
    pm, plen, nn = _page_edge(list(PAGE_EDGES))
    pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(cuda)
    chunked = stream_matcher.chunk_stream(pt)
    pl, nv = torch.from_numpy(plen).to(cuda), torch.from_numpy(nn).to(cuda)
    for steps in PAGE_EDGE_STEPS:
        want = dfa_walk.stream_walk_plain(pt, pl, nv, dfa, steps)
        for staged in (None, False, True):
            before = dfa_walk.launches
            got = dfa_walk.stream_walk(chunked, pl, nv, dfa, steps,
                                       staged=staged)
            assert dfa_walk.launches == before + 1
            assert all(map(torch.equal, got, want)), (staged, steps)
        before = dfa_walk.launches
        got = dfa_walk.stream_walk_bytewise(chunked, pl, nv, dfa, steps)
        assert dfa_walk.launches == before
        assert all(map(torch.equal, got, want)), ("bytewise", steps)
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def comment_buckets(tmp_path_factory):
    """The resident l_comment column of a 200,000-row lineitem fixture on
    the card: two length buckets of ~1 KB pages, as the 2M-row column has,
    and its pages cut into 256-byte segments (the split layout)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from duckdb_parquet_parser_tpu_torch.host.batch import to_tensor
    from duckdb_parquet_parser_tpu_torch.utils import fixtures

    path = fixtures.lineitem(tmp_path_factory.mktemp("lineitem")
                             / "l.parquet", 200_000)
    col = ScanEngine(str(path)).resident("l_comment", device="cuda")
    lanes = [(b["stream"], b["walk_plen"], b["walk_nn"], b["steps"])
             for b in col._buckets if b["has_plain"]]
    seg_payload, seg_len, seg_nn, _seg = port_scan.split_payload_pages(
        col._batch.arrays, trigger=256, target=256)
    steps = min(port_scan.scan_steps(seg_len), seg_payload.shape[1])
    lanes.append((port_scan.resident_stream(seg_payload, steps, "cuda"),
                  to_tensor(seg_len, "cuda", dtype=np.int32),
                  to_tensor(seg_nn, "cuda", dtype=np.int32), steps))
    return lanes


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_page_kernel_on_comment_buckets(comment_buckets, case):
    """The page walk on l_comment's two buckets and its split layout, in
    every variant and the one the wrapper picks, and the bytewise
    yardstick, bit for bit the plain loop's."""
    dfa = _case(case)[0]
    assert len(comment_buckets) == 3
    fits = (len(dfa_walk.pack_table(dfa).data) <= torch.cuda.
            get_device_properties(0).shared_memory_per_block_optin)
    for stream, pl, nv, steps in comment_buckets:
        want = dfa_walk.stream_walk_plain(
            stream_matcher.unchunk_stream(stream, steps), pl, nv, dfa, steps)
        walks = [lambda st=st: dfa_walk.stream_walk(stream, pl, nv, dfa,
                                                    steps, staged=st)
                 for st in [None, False] + [True] * fits]
        walks.append(lambda: dfa_walk.stream_walk_bytewise(
            stream, pl, nv, dfa, steps, staged=fits))
        for walk in walks:
            assert all(map(torch.equal, walk(), want)), tuple(stream.shape)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_rowwise_yardstick_matches_plain(cuda):
    dfa = compile_pattern(TABLE_PATTERNS[0])
    chars, lens = _edge_values("P=64 offset 8")
    c = torch.from_numpy(np.ascontiguousarray(chars)).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    before = dfa_walk.launches
    for staged in (True, False):
        assert torch.equal(dfa_walk.value_walk_rowwise(c, ln, dfa,
                                                       staged=staged),
                           dfa_walk.value_walk_plain(c, ln, dfa))
    assert dfa_walk.launches == before


@pytest.mark.cuda
def test_cuda_routes_never_call_the_plain_loop(cuda, words_file,
                                               monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain loop ran on the card")

    for mod, name in ((strings, "match_stream_multi"),
                      (dfa_walk, "stream_walk_plain"),
                      (dfa_walk, "value_walk_plain")):
        monkeypatch.setattr(mod, name, refuse)
    eng = ScanEngine(words_file)
    p = TABLE_PATTERNS[0]
    before = dfa_walk.launches
    got = eng.resident("s", device=cuda).scan(p, negate=True)
    want = eng.cold_scan("s", p, negate=True, exact_counts=True,
                         stats_prune=False)
    _same(got, want)
    rows = eng.matching_rows("s", p, device=cuda)
    assert len(rows) == int(eng.cold_scan(
        "s", p, exact_counts=True, stats_prune=False).match_counts.sum())
    assert dfa_walk.launches > before


@pytest.mark.cuda
def test_kernel_refuses_wrong_dtypes(cuda):
    dfa = compile_pattern(TABLE_PATTERNS[1])
    stream = torch.zeros((1, 4, 16), dtype=torch.uint8, device=cuda)
    ok = torch.zeros(4, dtype=torch.int32, device=cuda)
    bad = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        dfa_walk.stream_walk(stream, bad, ok, dfa)
    with pytest.raises(ValueError):
        dfa_walk.stream_walk(stream.expand(2, 4, 16), ok, ok, dfa)
    with pytest.raises(ValueError):
        dfa_walk.value_walk(torch.zeros((4, 8), dtype=torch.uint8,
                                        device=cuda), bad, dfa)
    with pytest.raises(ValueError):
        dfa_walk.value_walk(torch.zeros((4, 8), dtype=torch.int32,
                                        device=cuda), ok, dfa)


@pytest.mark.cuda
def test_refused_staging_leaves_no_error_behind(cuda):
    """A table too large to stage raises where staging is forced, and the
    next launches (and the variant's choice, which asks the occupancy of
    a staged launch that cannot be) still run."""
    rng = np.random.default_rng(3)
    dfa = DFA(rng.integers(0, 4096, (4096, 256)).astype(np.int32),
              rng.random(4096) < 0.5, "random 4096x256")
    chars = torch.from_numpy(rng.integers(0, 256, (64, 32),
                                          dtype=np.uint8)).to(cuda)
    lens = torch.full((64,), 20, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        dfa_walk.value_walk(chars, lens, dfa, staged=True)
    assert not dfa_walk.stages(cuda.index or 0, True,
                               len(dfa_walk.pack_table(dfa).data))
    for staged in (None, False):
        assert torch.equal(dfa_walk.value_walk(chars, lens, dfa,
                                               staged=staged),
                           dfa_walk.value_walk_plain(chars, lens, dfa))


@pytest.mark.cuda
def test_refused_page_staging_leaves_no_error_behind(cuda):
    """The page walk's refused staging raises and leaves no CUDA error
    for the next launches, as the per-value walk's does."""
    rng = np.random.default_rng(5)
    dfa = DFA(rng.integers(0, 4096, (4096, 256)).astype(np.int32),
              rng.random(4096) < 0.5, "random 4096x256")
    pm, plen, nn = _byte_pages(rng)
    pt = torch.from_numpy(np.ascontiguousarray(pm.T)).to(cuda)
    chunked = stream_matcher.chunk_stream(pt)
    pl, nv = torch.from_numpy(plen).to(cuda), torch.from_numpy(nn).to(cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        dfa_walk.stream_walk(chunked, pl, nv, dfa, staged=True)
    assert not dfa_walk.stages(cuda.index or 0, False,
                               len(dfa_walk.pack_table(dfa).data))
    want = dfa_walk.stream_walk_plain(pt, pl, nv, dfa)
    for staged in (None, False):
        got = dfa_walk.stream_walk(chunked, pl, nv, dfa, staged=staged)
        assert all(map(torch.equal, got, want))


# ── the build ───────────────────────────────────────────────────────────────


LOOPS_SASS = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x0 */
        /*0010*/                   LDG.E.128.CONSTANT R8, desc[UR4][R14.64] ;/* 0x0 */
        /*0020*/                   STS.128 [R3], R8 ;                        /* 0x0 */
        /*0030*/              @!P0 BRA 0x10 ;                                /* 0x0 */
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;             /* 0x0 */
        /*0050*/                   LDS.U16 R5, [R4] ;                        /* 0x0 */
        /*0060*/                   LOP3.LUT R6, R5, 0x7fff, RZ, 0xc0, !PT ;  /* 0x0 */
        /*0070*/                   IMAD R4, R6, R7, RZ ;                     /* 0x0 */
        /*0080*/                   SEL R8, R8, RZ, !P3 ;                     /* 0x0 */
        /*0090*/              @!P1 BRA 0x50 ;                                /* 0x0 */
        /*00a0*/                   EXIT ;                                    /* 0x0 */
"""


def test_loop_instructions_picks_the_loop_holding_an_opcode():
    """K3's staged variant copies its table in a loop of its own before
    the byte loop; the measuring aid picks the byte loop by its shared
    load."""
    assert build.loop_instructions(LOOPS_SASS) == {"LDG": 1, "STS": 1,
                                                   "BRA": 1}
    assert build.loop_instructions(LOOPS_SASS, "LDS") == {
        "LDS": 1, "LOP3": 1, "IMAD": 1, "SEL": 1, "BRA": 1}
    assert build.loop_instructions(LOOPS_SASS, "HMMA") == {}


def test_distinct_sources_build_at_once(monkeypatch, tmp_path):
    """`build_sources` starts one compiler run a source not built yet, all
    together (each fake run below waits until all three have started),
    builds a repeated source once, and returns the paths in order."""
    import sys

    log = tmp_path / "started"
    fake = tmp_path / "nvcc"
    fake.write_text(f"""#!{sys.executable}
import os, sys, time
with open({str(log)!r}, "a") as f:
    f.write("x")
deadline = time.time() + 60
while len(open({str(log)!r}).read()) < 3 and time.time() < deadline:
    time.sleep(0.01)
open(sys.argv[sys.argv.index("-o") + 1], "w").write(open(sys.argv[-1]).read())
""")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    texts = ["// one\n", "// two\n", "// one\n", "// three\n"]
    paths = build.build_sources(texts)
    assert log.read_text() == "xxx"
    assert paths[0] == paths[2] and len(set(paths)) == 3
    assert [p.read_text() for p in paths] == texts
    assert build.build_sources(texts) == paths and log.read_text() == "xxx"
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        p.name for p in set(paths))
