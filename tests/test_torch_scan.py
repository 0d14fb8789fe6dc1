"""The port's resident scan (duckdb_parquet_parser_tpu_torch/models/scan.py)
against the reference: the JAX `ResidentColumn` on the CPU and the numpy
golden `scan_batch(xp=np)`.  PLAIN, negate, LIKE, nulls, mixed PLAIN/dict
row groups, a multi-row-group dictionary whose concatenated table holds
513-8192 entries (the reference then runs its Pallas lookup body in
interpret mode), and the big-page split layout.  Tolerance 0: per-page
integer counts."""

from __future__ import annotations

import re

import numpy as np
import pytest

from duckdb_parquet_parser_tpu.host.schema import ParquetType
from duckdb_parquet_parser_tpu.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from tests import fixtures

PATTERNS = ["alpha", "a.*z", "q[aeiou]", "^br"]


def _mixed(path, rng):
    w = ParquetWriter(str(path), [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                             optional=True)],
                      key_value={"pad": "x" * 512})
    w.write_row_group({"s": fixtures.random_strings(rng, 800, n_unique=8,
                                                    null_p=0.1)})
    w.write_row_group({"s": fixtures.random_strings(rng, 800, null_p=0.1)})
    w.close()
    return str(path)


def _big_dict(path, rng, rgs=2, distinct=300, rows=2000):
    """Distinct dictionaries per row group: the concatenated table holds
    rgs * distinct entries."""
    w = ParquetWriter(str(path), [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                             optional=True)])
    for rg in range(rgs):
        keys = [f"city_{rg}_{k:03d}".encode() for k in range(distinct)]
        vals = [keys[i] for i in rng.integers(0, distinct, rows)]
        mask = (rng.random(rows) > 0.05).astype(np.uint8)
        w.write_row_group({"s": (vals, mask)})
    w.close()
    return str(path)


@pytest.fixture(scope="module", params=["plain", "dict", "mixed", "big_dict"])
def column(request, tmp_path_factory):
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR
    from duckdb_parquet_parser_tpu.models.scan import ResidentColumn as JRC

    seeds = {"plain": 11, "dict": 12, "mixed": 13, "big_dict": 14}
    rng = np.random.default_rng(seeds[request.param])
    d = tmp_path_factory.mktemp("tscan")
    kind = request.param
    if kind == "plain":
        path = fixtures.strings_file(str(d / "p.parquet"), rng, n=1500,
                                     null_p=0.15)
    elif kind == "dict":
        path = fixtures.strings_file(str(d / "d.parquet"), rng, n=1500,
                                     n_unique=11, null_p=0.15)
    elif kind == "mixed":
        path = _mixed(d / "m.parquet", rng)
    else:
        path = _big_dict(d / "b.parquet", rng)
    eng = ScanEngine(path)
    port = eng.resident("s", device="cpu")
    if kind == "big_dict":
        dn = int(port._batch.dims["dict_n"])
        assert 513 <= dn <= 8192, dn
    return kind, path, eng, port, JRC(JR(path), "s")


def _same(a, b, msg):
    np.testing.assert_array_equal(a.page_gid, b.page_gid, err_msg=msg)
    np.testing.assert_array_equal(a.match_counts, b.match_counts, err_msg=msg)
    np.testing.assert_array_equal(a.value_counts, b.value_counts, err_msg=msg)


def _numpy_golden(path, pattern, negate):
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR
    from duckdb_parquet_parser_tpu.ops.scan import scan_batch

    batch = JR(path).prescan("s", pad_strings=8)
    return scan_batch(batch, pattern, negate=negate, xp=np)


@pytest.mark.parametrize("negate", [False, True])
def test_resident_scan_matches_reference(column, negate):
    kind, path, _eng, port, jax_col = column
    pats = (["city_1_.*", "city_.*_0[0-5]"] if kind == "big_dict"
            else PATTERNS[:3])
    for i, p in enumerate(pats):
        got = port.scan(p, negate=negate)
        _same(got, _numpy_golden(path, p, negate), f"{kind} {p} numpy")
        if i == 0:  # the JAX column compiles per pattern: one is enough
            _same(got, jax_col.scan(p, negate=negate), f"{kind} {p} jax")


def test_scan_many_matches_reference(column):
    kind, _path, _eng, port, jax_col = column
    pats = (["city_1_.*", "city_0_00[0-9]", "(city_1)*_"] if kind == "big_dict"
            else ["alpha", "a.*z", "(al|br)*avo"])
    many = port.scan_many(pats)
    for p, got, want in zip(pats, many, jax_col.scan_many(pats)):
        _same(got, want, f"{kind} {p}")


def test_like_and_one_shot(column):
    kind, path, eng, port, jax_col = column
    like = "city_1%" if kind == "big_dict" else "%al_ha%"
    _same(port.scan(like, like=True), jax_col.scan(like, like=True), like)
    p = "city_1_.*" if kind == "big_dict" else "a.*z"
    _same(eng.scan("s", p, device="cpu"), _numpy_golden(path, p, False), p)



@pytest.mark.parametrize("exact", [False, True])
def test_cold_scan_matches_reference(column, exact):
    """The port's native host scan against the reference's `cold_scan`
    (substring chain, table DFA, and an anchored pattern that prunes by
    page statistics), and its exact unpruned form against the resident
    scan."""
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR
    from duckdb_parquet_parser_tpu.models.scan import cold_scan

    kind, path, eng, port, _jax_col = column
    pats = (["city_1_.*", "^city_0_00", "city_.*_0[0-5]"]
            if kind == "big_dict" else ["alpha", "^br", "q[aeiou]"])
    reader = JR(path)
    for p in pats:
        for negate in (False, True):
            msg = f"{kind} {p} negate={negate}"
            got = eng.cold_scan("s", p, negate=negate, exact_counts=exact)
            want = cold_scan(reader, "s", p, negate=negate,
                             exact_counts=exact)
            _same(got, want, msg)
            assert got.stats_pruned_pages == want.stats_pruned_pages, msg
            if exact:
                ref = eng.cold_scan("s", p, negate=negate, exact_counts=True,
                                    stats_prune=False)
                _same(ref, port.scan(p, negate=negate), msg)


@pytest.fixture(scope="module")
def null_page_file(tmp_path_factory):
    """The `mixed_rgs` layout of tests/test_scan.py (a dictionary row group,
    then a PLAIN one) under the seed that ends the PLAIN row group in a page
    whose one value is null."""
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR

    rng = np.random.default_rng(169)
    path = tmp_path_factory.mktemp("nullpage") / "m.parquet"
    w = ParquetWriter(str(path), [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                             optional=True)],
                      key_value={"pad": "x" * 512})
    w.write_row_group({"s": fixtures.random_strings(rng, 1000, n_unique=8,
                                                    null_p=0.1)})
    w.write_row_group({"s": fixtures.random_strings(rng, 1000, null_p=0.1)})
    w.close()
    a = JR(str(path)).prescan("s", pad_strings=8).arrays
    last = int(np.flatnonzero(a["page_kind"] != 1)[-1])
    assert (a["page_num_values"][last], a["page_nn"][last]) == (1, 0)
    return str(path)


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("pattern", ["", "^\x00$"])
def test_all_null_page_matches_reference(null_page_file, pattern, negate):
    """A page without a non-null value participates in no count: the
    port's `scan_batch`, `ResidentColumn.scan` and `matching_rows` against
    the reference's `scan_batch`, `ResidentColumn.scan` and
    `matching_rows`, both polarities, on the CPU."""
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR
    from duckdb_parquet_parser_tpu.models.scan import ResidentColumn as JRC
    from duckdb_parquet_parser_tpu.models.scan import ScanEngine as JEngine
    from duckdb_parquet_parser_tpu_torch.ops.scan import scan_batch

    path = null_page_file
    want = _numpy_golden(path, pattern, negate)
    eng = ScanEngine(path)
    batch = eng.reader.prescan("s", pad_strings=8)
    msg = f"{pattern!r} negate={negate}"
    got = scan_batch(batch, pattern, negate=negate, device="cpu")
    _same(got, want, msg)
    _same(eng.resident("s", device="cpu").scan(pattern, negate=negate),
          want, msg)
    _same(JRC(JR(path), "s").scan(pattern, negate=negate), want, msg)
    rows = eng.matching_rows("s", pattern, negate=negate, device="cpu")
    np.testing.assert_array_equal(
        rows, JEngine(path).matching_rows("s", pattern, negate=negate))
    assert len(rows) == int(want.match_counts.sum())
    empty = batch.arrays["page_nn"] == 0
    assert empty.any() and not got.value_counts[empty].any()
    assert not got.match_counts[empty].any()


def test_unsupported_patterns_and_columns(tmp_path):
    rng = np.random.default_rng(2)
    path = fixtures.mixed_file(str(tmp_path / "k.parquet"), rng)
    eng = ScanEngine(path)
    with pytest.raises(TypeError):
        eng.resident("i64", device="cpu")
    col = eng.resident("comment", device="cpu")
    with pytest.raises(NotImplementedError):
        col.scan("([a-m])\\1*o")  # backreference: outside the DFA subset


def test_split_layout_big_pages(tmp_path):
    """pyarrow-default big pages: the resident layout is the value-boundary
    segment matrix; counts match the JAX split path and `re`."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR
    from duckdb_parquet_parser_tpu.models.scan import ResidentColumn as JRC

    rng = np.random.default_rng(9)
    words = [b"carefully", b"quickly", b"special", b"requests", b"deposits"]
    vals = [b" ".join(rng.choice(words, 5)) if rng.random() > 0.05 else None
            for _ in range(2000)]
    f = str(tmp_path / "big.parquet")
    pq.write_table(pa.table({"s": vals}), f, compression="none",
                   use_dictionary=False)
    port = ScanEngine(f).resident("s", device="cpu")
    assert port.split
    jax_col = JRC(JR(f), "s")
    for negate in (False, True):
        got = port.scan("special.*requests", negate=negate)
        if not negate:
            _same(got, jax_col.scan("special.*requests"), "jax")
        want = sum(1 for v in vals if v is not None
                   and bool(re.search(b"special.*requests", v)) ^ negate)
        assert int(got.match_counts.sum()) == want
    many = port.scan_many(["special.*requests", "carefully|quickly"])
    for m, p in zip(many, ["special.*requests", "carefully|quickly"]):
        _same(m, port.scan(p), p)
