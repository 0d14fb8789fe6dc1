"""How often each query route compiles its pattern (`ops/regex.
compile_pattern`, the host's regex -> DFA) in the port and in the JAX
package, on the same file.  Every route a user runs compiles a pattern at
most as often as the reference's does and at most once a call; a repeated
`scan_streaming` compiles nothing, as the reference's `_streaming_step`
cache gives.  A register-machine pattern (K1) and a table-DFA pattern (K3);
the answers stay equal to the reference's (tolerance 0: per-page integer
counts, row ids).  CPU only: the reference runs under JAX on the CPU, the
port on its plain walks."""

from __future__ import annotations

import json
import sys
import warnings

import numpy as np
import pytest

from duckdb_parquet_parser_tpu.host import bindings as ref_bindings
from duckdb_parquet_parser_tpu.host.reader import ParquetReader as RefReader
from duckdb_parquet_parser_tpu.models import scan as ref_models
from duckdb_parquet_parser_tpu.ops import regex as ref_regex
from duckdb_parquet_parser_tpu import scaling_bench as ref_scaling
from duckdb_parquet_parser_tpu_torch import scaling_bench
from duckdb_parquet_parser_tpu_torch.host import bindings
from duckdb_parquet_parser_tpu_torch.host.reader import ParquetReader
from duckdb_parquet_parser_tpu_torch.host.schema import ParquetType
from duckdb_parquet_parser_tpu_torch.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser_tpu_torch.models import scan as port_models
from duckdb_parquet_parser_tpu_torch.ops import regex as port_regex
from duckdb_parquet_parser_tpu_torch.parallel import mesh as port_mesh
from duckdb_parquet_parser_tpu_torch.parallel.pipeline import distributed_scan

# a register-machine pattern (the bench's) and a table-DFA one
# (`chip_smoke.TABLE_PATTERNS[0]`, 44 states)
PATTERNS = ["special.*requests",
            "(furiously|carefully) (express|regular)+ (deposits|requests)"]
UNSUPPORTED = "([a-m])\\1*o"  # a backreference: outside the DFA subset
WORDS = [b"special", b"requests", b"furiously", b"carefully", b"express",
         b"regular", b"deposits", b"slyly"]


def _strings(rng, n, n_unique=None):
    """`n` values of two to five words, 10% NULL (few distinct ones with
    `n_unique`: the writer then dictionary-encodes them)."""
    def value():
        k = int(rng.integers(2, 6))
        return b" ".join(WORDS[int(i)] for i in rng.integers(0, len(WORDS), k))

    pool = [value() for _ in range(n_unique)] if n_unique else None
    vals = [pool[int(rng.integers(n_unique))] if pool else value()
            for _ in range(n)]
    return [None if rng.random() < 0.1 else v for v in vals]


@pytest.fixture(scope="module")
def path(tmp_path_factory) -> str:
    """A dictionary row group, two PLAIN ones."""
    rng = np.random.default_rng(12)
    out = str(tmp_path_factory.mktemp("compile_counts") / "c.parquet")
    w = ParquetWriter(out, [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                       optional=True)],
                      key_value={"pad": "x" * 512})
    for vals in (_strings(rng, 600, n_unique=9), _strings(rng, 700),
                 _strings(rng, 500)):
        w.write_row_group({"s": vals})
    w.close()
    return out


@pytest.fixture(scope="module")
def columns(path):
    """(port, reference) resident columns, made once: residency compiles
    no pattern."""
    return (port_models.ScanEngine(path).resident("s", "cpu"),
            ref_models.ScanEngine(path).resident("s"))


class Compiles:
    """Counts `compile_pattern` calls, per package: the name is rebound in
    every module that bound it (`from .regex import compile_pattern` makes
    a copy; imports inside a function read `regex` itself)."""

    def __init__(self, monkeypatch):
        self.calls = {"port": [], "ref": []}
        for side, regex, prefix in (
                ("port", port_regex, "duckdb_parquet_parser_tpu_torch."),
                ("ref", ref_regex, "duckdb_parquet_parser_tpu.")):
            original = regex.compile_pattern

            def counting(*args, _original=original, _log=self.calls[side],
                         **kwargs):
                _log.append(args[0])
                return _original(*args, **kwargs)

            for name, mod in list(sys.modules.items()):
                if (name.startswith(prefix) and getattr(
                        mod, "compile_pattern", None) is original):
                    monkeypatch.setattr(mod, "compile_pattern", counting)
        port_models._streaming_matchers.cache_clear()
        ref_models._streaming_step.cache_clear()

    def count(self, side: str, fn):
        """(fn(), compile_pattern calls of `side` inside it)."""
        before = len(self.calls[side])
        out = fn()
        return out, len(self.calls[side]) - before


@pytest.fixture
def compiles(monkeypatch) -> Compiles:
    return Compiles(monkeypatch)


def _pages(res):
    return (np.asarray(res.page_gid), np.asarray(res.match_counts),
            np.asarray(res.value_counts))


def _array(res):
    return (np.asarray(res),)


def _prescan(reader_cls, bind, path):
    return reader_cls(path).prescan(
        "s", pad_strings=8, flags=bind.PS_HOST_STRINGS | bind.PS_PAYLOAD)


def _forward_port(path, pattern):
    fn, args = port_models.single_chip_forward(
        _prescan(ParquetReader, bindings, path), pattern, device="cpu")
    return fn(*args).numpy()


def _forward_ref(path, pattern):
    # the reference's step takes a compiled DFA: its caller compiles
    fn, args = ref_models.single_chip_forward(
        _prescan(RefReader, ref_bindings, path),
        ref_models.compile_pattern(pattern))
    return np.asarray(fn(*args))


# route -> (port call, reference call, how an answer is compared); each
# call takes (path, resident columns, pattern)
ROUTES = {
    "ResidentColumn.scan": (
        lambda p, cols, pat: cols[0].scan(pat),
        lambda p, cols, pat: cols[1].scan(pat), _pages),
    "ResidentColumn.scan_many": (
        lambda p, cols, pat: cols[0].scan_many([pat])[0],
        lambda p, cols, pat: cols[1].scan_many([pat])[0], _pages),
    "ScanEngine.scan": (
        lambda p, cols, pat: port_models.ScanEngine(p).scan(
            "s", pat, engine="torch", device="cpu"),
        lambda p, cols, pat: ref_models.ScanEngine(p).scan(
            "s", pat, engine="jax"), _pages),
    "scan_streaming": (
        lambda p, cols, pat: port_models.ScanEngine(p).scan_streaming(
            "s", pat, device="cpu"),
        lambda p, cols, pat: ref_models.ScanEngine(p).scan_streaming(
            "s", pat), _pages),
    "scan_batched": (
        lambda p, cols, pat: port_models.ScanEngine(p).scan_batched(
            "s", pat, device="cpu"),
        lambda p, cols, pat: ref_models.ScanEngine(p).scan_batched(
            "s", pat), _pages),
    "single_chip_forward": (
        lambda p, cols, pat: _forward_port(p, pat),
        lambda p, cols, pat: _forward_ref(p, pat), _array),
    "matching_rows": (
        lambda p, cols, pat: port_models.ScanEngine(p).matching_rows(
            "s", pat, device="cpu"),
        lambda p, cols, pat: ref_models.ScanEngine(p).matching_rows(
            "s", pat), _array),
    "cold_scan": (
        lambda p, cols, pat: port_models.ScanEngine(p).cold_scan(
            "s", pat, exact_counts=True, stats_prune=False),
        lambda p, cols, pat: ref_models.ScanEngine(p).cold_scan(
            "s", pat, exact_counts=True), _pages),
}


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_route_compiles_no_more_than_the_reference(path, columns, compiles,
                                                   route, pattern):
    port_call, ref_call, answer = ROUTES[route]
    want, n_ref = compiles.count("ref", lambda: ref_call(path, columns,
                                                         pattern))
    got, n_port = compiles.count("port", lambda: port_call(path, columns,
                                                           pattern))
    assert n_port <= n_ref, (route, n_port, n_ref)
    assert n_port <= 1, (route, n_port)
    for g, w in zip(answer(got), answer(want)):
        np.testing.assert_array_equal(g, w, err_msg=route)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_both_patterns_match_some_values(path, pattern):
    """The fixture gives both patterns matches and misses."""
    res = port_models.ScanEngine(path).cold_scan(
        "s", pattern, exact_counts=True, stats_prune=False)
    assert 0 < res.match_counts.sum() < res.value_counts.sum()


@pytest.mark.parametrize("pattern", PATTERNS)
def test_repeated_scan_streaming_compiles_nothing(path, compiles, pattern):
    """The port's second call compiles nothing, also negated: its cache is
    keyed on the pattern alone.  The reference's jit step is cached per
    (pattern, negate), and each of its calls compiles once more for a row
    group with dictionary pages (`scan_batch_device`; this file has one),
    so its repeat counts 1 here and 0 on a file without a dictionary."""
    port, ref = port_models.ScanEngine(path), ref_models.ScanEngine(path)
    first, n_first = compiles.count("port", lambda: port.scan_streaming(
        "s", pattern, device="cpu"))
    assert n_first == 1
    for negate in (False, True):
        want, _n = compiles.count("ref", lambda: ref.scan_streaming(
            "s", pattern, negate=negate))
        _again, n_ref_again = compiles.count(
            "ref", lambda: ref.scan_streaming("s", pattern, negate=negate))
        got, n_port = compiles.count("port", lambda: port.scan_streaming(
            "s", pattern, negate=negate, device="cpu"))
        assert n_port == 0 and n_ref_again == 1, negate
        for g, w in zip(_pages(got), _pages(want)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(_pages(first), _pages(port.scan_streaming(
            "s", pattern, device="cpu"))):
        np.testing.assert_array_equal(g, w)
    assert port_models._streaming_matchers.cache_info().currsize == 1


@pytest.mark.parametrize("pattern", PATTERNS)
def test_distributed_scan_compiles_nothing(path, columns, compiles, pattern):
    """One gloo rank in this process: the sharded scan walks with the DFA
    it was handed and compiles none; pages and counts equal the
    reference's resident scan."""
    dfa = port_regex.compile_pattern(pattern)
    batch = _prescan(ParquetReader, bindings, path)
    with port_mesh.closing_group():
        mesh = port_mesh.make_mesh("cpu", "gloo")
        got, n_port = compiles.count("port", lambda: distributed_scan(
            mesh, batch, dfa))
    assert n_port == 0
    for g, w in zip(_pages(got), _pages(columns[1].scan(pattern))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_scaling_bench_compiles_once(compiles, capsys, monkeypatch, pattern):
    """The scaling harness at one rank, in both packages: one compile a
    run."""
    monkeypatch.setattr(sys, "argv", [
        "scaling_bench", "--rows", "800", "--reps", "1", "--sizes", "1",
        "--pattern", pattern])
    _rc, n_ref = compiles.count("ref", ref_scaling.main)
    with port_mesh.closing_group():
        mesh = port_mesh.make_mesh("cpu", "gloo")
        rc, n_port = compiles.count("port", lambda: scaling_bench.run(
            mesh, rows=800, pattern=pattern, reps=1))
    assert rc == 0
    assert n_ref == 1 and n_port == 1
    lines = capsys.readouterr().out.strip().splitlines()
    tables = [json.loads(ln)["table"] for ln in lines if ln.startswith("{")]
    assert [t[0]["devices"] for t in tables] == [1, 1]


def test_cached_dfa_is_read_only(path, compiles):
    """The DFA a repeated `scan_streaming` shares cannot be written, and
    its walks read it without a copy warning."""
    pattern = PATTERNS[1]
    eng = port_models.ScanEngine(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        first = eng.scan_streaming("s", pattern, device="cpu")
        again = eng.scan_streaming("s", pattern, negate=True, device="cpu")
    pats, dfas, irs, dfa = port_models._streaming_matchers(pattern)
    assert irs == () and dfa is dfas[0] and pats == [pattern]
    for arr in (dfa.table, dfa.accept):
        assert not arr.flags.writeable
        with pytest.raises(ValueError):
            arr[0] = arr[0]
    np.testing.assert_array_equal(first.match_counts + again.match_counts,
                                  first.value_counts)
    # the same answers as a fresh compile on the resident column
    fresh = port_models.ScanEngine(path).resident("s", "cpu").scan(pattern)
    for g, w in zip(_pages(first), _pages(fresh)):
        np.testing.assert_array_equal(g, w)


def test_unsupported_pattern_is_refused_every_call(path, compiles):
    """A pattern outside the DFA subset raises on every `scan_streaming`
    (a raise is not cached) and compiles again each time."""
    eng = port_models.ScanEngine(path)
    for _ in range(2):
        with pytest.raises(NotImplementedError):
            compiles.count("port", lambda: eng.scan_streaming(
                "s", UNSUPPORTED, device="cpu"))
    assert compiles.calls["port"] == [UNSUPPORTED, UNSUPPORTED]
    assert port_models._streaming_matchers.cache_info().currsize == 0
    # the one-shot scan still answers it with the host `re` fallback
    got = eng.scan("s", UNSUPPORTED, engine="torch", device="cpu")
    want = ref_models.ScanEngine(path).scan("s", UNSUPPORTED, engine="jax")
    for g, w in zip(_pages(got), _pages(want)):
        np.testing.assert_array_equal(g, w)
