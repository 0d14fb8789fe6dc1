"""Row-level matches of the port (ops/scan.match_rows, scan_batch,
ScanEngine.matching_rows and the host `re` fallbacks) against the JAX
package's on the same files, and against Python `re` driven by the streaming
string iterator.  Tolerance 0: sorted int64 row ids and per-page integer
counts."""

from __future__ import annotations

import re

import numpy as np
import pytest

from duckdb_parquet_parser_tpu.host.reader import ParquetReader as RefReader
from duckdb_parquet_parser_tpu.models.scan import ScanEngine as RefEngine
from duckdb_parquet_parser_tpu.ops import scan as ref_scan
from duckdb_parquet_parser_tpu_torch.host.reader import ParquetReader
from duckdb_parquet_parser_tpu_torch.host.schema import ParquetType
from duckdb_parquet_parser_tpu_torch.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from duckdb_parquet_parser_tpu_torch.ops import scan as port_scan

from .fixtures import strings_file

PATTERNS = ["alpha", "a.*o", "^br", "o$", "gamma|delta", "[ab]l", "x{2}"]
# a backreference: outside the DFA subset, so both packages take host `re`
FALLBACK = r"(al)\1?pha|alpha"


@pytest.fixture(scope="module", params=[None, 12], ids=["plain", "dict"])
def rows_file(request, tmp_path_factory):
    rng = np.random.default_rng(23)
    d = tmp_path_factory.mktemp("torch_match_rows")
    return strings_file(d / "f.parquet", rng, n=900, n_unique=request.param,
                        null_p=0.15, rgs=2)


def _oracle_rows(path, pattern, negate):
    rx = re.compile(pattern.encode())
    it = ParquetReader(path).column_iterator("s")
    keep = []
    while it.has_next():
        pos, _ln, s = it.next()
        if bool(rx.search(s)) ^ negate:
            keep.append(pos)
    return np.asarray(keep, np.int64)


def _same_result(a, b):
    np.testing.assert_array_equal(a.page_gid, b.page_gid)
    np.testing.assert_array_equal(a.match_counts, b.match_counts)
    np.testing.assert_array_equal(a.value_counts, b.value_counts)


@pytest.mark.parametrize("negate", [False, True], ids=["like", "not-like"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_matching_rows_matches_reference_and_oracle(rows_file, pattern,
                                                    negate):
    got = ScanEngine(rows_file).matching_rows("s", pattern, negate=negate,
                                              device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, RefEngine(rows_file).matching_rows("s", pattern, negate=negate))
    np.testing.assert_array_equal(got, _oracle_rows(rows_file, pattern,
                                                    negate))


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_scan_batch_matches_reference(rows_file, pattern, negate):
    """`scan_batch` (the per-value scan over a pad_strings batch) against
    the reference's numpy golden model, and `match_rows`' length against its
    total (shared participation and negate semantics)."""
    batch = ParquetReader(rows_file).prescan("s", pad_strings=8)
    got = port_scan.scan_batch(batch, pattern, negate=negate, device="cpu")
    ref_batch = RefReader(rows_file).prescan("s", pad_strings=8)
    _same_result(got, ref_scan.scan_batch(ref_batch, pattern, negate=negate,
                                          xp=np))
    rows = port_scan.match_rows(batch, pattern, negate=negate, device="cpu")
    assert len(rows) == int(got.match_counts.sum())
    np.testing.assert_array_equal(
        rows, ref_scan.match_rows(ref_batch, pattern, negate=negate))


@pytest.mark.parametrize("flags", ["materialized", "runs_only"])
def test_value_accepts_matches_reference(rows_file, flags):
    """The shared accept / participation matrices, with the value-space
    planes materialized by the prescan and expanded from runs."""
    from duckdb_parquet_parser_tpu.host import bindings as ref_bindings
    from duckdb_parquet_parser_tpu.ops.regex import compile_pattern
    from duckdb_parquet_parser_tpu_torch.host import bindings

    f = bindings.PS_HOST_STRINGS | (bindings.PS_RUNS_ONLY
                                    if flags == "runs_only" else 0)
    assert bindings.PS_RUNS_ONLY == ref_bindings.PS_RUNS_ONLY
    batch = ParquetReader(rows_file).prescan("s", pad_strings=8, flags=f)
    ref_batch = RefReader(rows_file).prescan("s", pad_strings=8, flags=f)
    dfa = compile_pattern("a.*o")
    for negate in (False, True):
        emit, part = port_scan._value_accepts(batch, dfa, negate=negate,
                                              device="cpu")
        want_emit, want_part = ref_scan._value_accepts(
            ref_batch, dfa, negate=negate, xp=np)
        np.testing.assert_array_equal(emit.numpy(), np.asarray(want_emit))
        np.testing.assert_array_equal(part.numpy(), np.asarray(want_part))


@pytest.mark.parametrize("negate", [False, True])
def test_fallback_pattern_routes_through_host_re(rows_file, negate):
    """A pattern outside the DFA subset: `matching_rows`, `match_rows`,
    `scan_batch`, `ScanEngine.scan` and `cold_scan` all answer it with the
    host `re` fallback, as the reference's do, with equal results."""
    eng, ref = ScanEngine(rows_file), RefEngine(rows_file)
    got = eng.matching_rows("s", FALLBACK, negate=negate, device="cpu")
    np.testing.assert_array_equal(
        got, ref.matching_rows("s", FALLBACK, negate=negate))
    np.testing.assert_array_equal(got, _oracle_rows(rows_file, FALLBACK,
                                                    negate))
    batch = eng.reader.prescan("s", pad_strings=8)
    ref_batch = ref.reader.prescan("s", pad_strings=8)
    np.testing.assert_array_equal(
        port_scan.match_rows_fallback(batch, FALLBACK, negate=negate),
        ref_scan.match_rows_fallback(ref_batch, FALLBACK, negate=negate))
    want = ref_scan.scan_batch_fallback(ref_batch, FALLBACK, negate=negate)
    _same_result(port_scan.scan_batch_fallback(batch, FALLBACK,
                                               negate=negate), want)
    _same_result(port_scan.scan_batch(batch, FALLBACK, negate=negate,
                                      device="cpu"), want)
    _same_result(eng.scan("s", FALLBACK, negate=negate, device="cpu"),
                 ref.scan("s", FALLBACK, negate=negate))
    _same_result(eng.cold_scan("s", FALLBACK, negate=negate), want)
    assert len(got) == int(want.match_counts.sum())


def test_resident_column_refuses_a_fallback_pattern(rows_file):
    """The resident column and the block scans refuse a pattern outside the
    DFA subset, as the reference's do."""
    eng = ScanEngine(rows_file)
    with pytest.raises(NotImplementedError):
        eng.resident("s", device="cpu").scan(FALLBACK)
    with pytest.raises(NotImplementedError):
        eng.scan_batched("s", FALLBACK, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.scan_streaming("s", FALLBACK, device="cpu")


def test_matching_rows_like_mode(rows_file):
    got = ScanEngine(rows_file).matching_rows("s", "%alpha%", like=True,
                                              device="cpu")
    np.testing.assert_array_equal(got, _oracle_rows(rows_file, "alpha",
                                                    False))
    np.testing.assert_array_equal(
        got, RefEngine(rows_file).matching_rows("s", "%alpha%", like=True))


def test_matching_rows_rejects_non_strings(tmp_path):
    p = tmp_path / "ints.parquet"
    w = ParquetWriter(str(p), [ColumnSpec("i", ParquetType.INT64)],
                      key_value={"pad": "x" * 512})
    w.write_row_group({"i": list(range(600))})
    w.close()
    with pytest.raises(TypeError):
        ScanEngine(str(p)).matching_rows("i", "x", device="cpu")


def test_match_rows_needs_pad_strings(tmp_path):
    path = strings_file(tmp_path / "p.parquet", np.random.default_rng(5),
                        n=300, null_p=0.1, rgs=1)
    batch = ParquetReader(path).prescan("s")  # host strings, unpadded
    with pytest.raises(ValueError):
        port_scan.match_rows(batch, "alpha", device="cpu")


def test_string_offsets_and_match_values_by_offset(tmp_path):
    """The per-value pair of ops/strings.py against the reference's numpy
    run of the same functions, on the PLAIN payloads of the file."""
    import torch

    from duckdb_parquet_parser_tpu.ops import strings as ref_strings
    from duckdb_parquet_parser_tpu.ops.regex import compile_pattern
    from duckdb_parquet_parser_tpu_torch.host import bindings
    from duckdb_parquet_parser_tpu_torch.ops import strings

    path = strings_file(tmp_path / "p.parquet", np.random.default_rng(6),
                        n=700, null_p=0.1, rgs=2)
    batch = ParquetReader(path).prescan("s", pad_strings=8,
                                        flags=bindings.PS_PAYLOAD)
    a = batch.arrays
    plain = np.asarray(a["page_kind"]) != 1
    payload = np.ascontiguousarray(a["payload"][plain])
    nn = np.asarray(a["page_nn"])[plain].astype(np.int32)
    cap = int(nn.max())
    offs, lens = strings.string_offsets(torch.from_numpy(payload),
                                        torch.from_numpy(nn), cap)
    want_offs, want_lens = ref_strings.string_offsets(np, payload, nn, cap)
    np.testing.assert_array_equal(offs.numpy(), np.asarray(want_offs))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    dfa = compile_pattern("a.*o")
    pitch = int(lens.max())
    got = strings.match_values_by_offset(torch.from_numpy(payload), offs,
                                         lens, dfa.table, dfa.accept, pitch)
    want = ref_strings.match_values_by_offset(np, payload, want_offs,
                                              want_lens, dfa.table,
                                              dfa.accept, pitch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
