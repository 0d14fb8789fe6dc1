"""The port's reader (duckdb_parquet_parser_tpu_torch/host/reader.py with
host/assembly.py) against the reference reader on the same files: the
fixtures of tests/fixtures.py (the repository's writer), a FIXED_LEN_BYTE_
ARRAY file, and pyarrow-written files with nesting, statistics, a page index
and compression.  Every public read is compared: schema, metadata,
statistics, `read_column` (whole and per row group), `read_rows`,
`read_pages`, the raw page API and iterators, `read_table` and the nested
readers, and `prescan` with its default arguments.  Tolerance 0: values are
compared as bytes or Python objects."""

from __future__ import annotations

import inspect

import numpy as np
import pytest

from duckdb_parquet_parser_tpu.host import reader as ref_reader
from duckdb_parquet_parser_tpu.host.schema import ParquetType as RefType
from duckdb_parquet_parser_tpu.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser_tpu_torch.host import bindings, reader
from tests import fixtures


def _own_mixed(d):
    return fixtures.mixed_file(str(d / "m.parquet"),
                               np.random.default_rng(7))


def _own_strings_plain(d):
    return fixtures.strings_file(str(d / "p.parquet"),
                                 np.random.default_rng(8), n=900,
                                 null_p=0.15, rgs=3)


def _own_strings_dict(d):
    return fixtures.strings_file(str(d / "d.parquet"),
                                 np.random.default_rng(9), n=900,
                                 n_unique=12, null_p=0.15, rgs=2)


def _own_flba(d):
    rng = np.random.default_rng(3)
    path = str(d / "flba.parquet")
    w = ParquetWriter(path, [
        ColumnSpec("f", RefType.FIXED_LEN_BYTE_ARRAY, optional=True,
                   type_length=5),
        ColumnSpec("g", RefType.FIXED_LEN_BYTE_ARRAY, optional=True,
                   type_length=5)], key_value={"pad": "x" * 512})
    valid = (rng.random(700) > 0.2).astype(np.uint8)
    pool = rng.integers(0, 256, (7, 5)).astype(np.uint8)
    w.write_row_group({
        "f": (rng.integers(0, 256, (700, 5)).astype(np.uint8), valid),
        "g": (pool[rng.integers(0, 7, 700)], valid)})
    w.close()
    return path


def _arrow_nested(d):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(17)
    n = 400

    def maybe(v):
        return None if rng.random() < 0.15 else v

    t = pa.table({
        "i": pa.array([maybe(int(rng.integers(1000))) for _ in range(n)],
                      type=pa.int64()),
        "f": pa.array([maybe(float(rng.standard_normal())) for _ in range(n)],
                      type=pa.float64()),
        "s": pa.array([maybe(f"v{i}".encode()) for i in range(n)],
                      type=pa.binary()),
        "l": pa.array([maybe([int(x) for x in
                              rng.integers(0, 9, rng.integers(0, 4))])
                       for _ in range(n)], type=pa.list_(pa.int64())),
        "ll": pa.array([maybe([maybe([int(x) for x in
                                      rng.integers(0, 9, rng.integers(0, 3))])
                               for _ in range(int(rng.integers(0, 3)))])
                        for _ in range(n)],
                       type=pa.list_(pa.list_(pa.int64()))),
        "st": pa.array([maybe({"a": maybe(int(rng.integers(9))),
                               "b": maybe(b"x")}) for _ in range(n)],
                       type=pa.struct([("a", pa.int64()),
                                       ("b", pa.binary())])),
        "m": pa.array([maybe([(f"k{j}".encode(), maybe(int(rng.integers(9))))
                              for j in range(int(rng.integers(0, 3)))])
                       for _ in range(n)],
                      type=pa.map_(pa.binary(), pa.int64())),
    })
    path = d / "t.parquet"
    pq.write_table(t, path, compression="snappy", data_page_size=512,
                   row_group_size=150)
    return str(path)


def _arrow_stats(d):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(5)
    n = 6000
    x = rng.integers(-(1 << 50), 1 << 50, n)
    svals = [None if rng.random() < 0.08 else f"tok-{int(v):012d}"
             for v in rng.integers(0, 10**12, n)]
    t = pa.table({
        "x": pa.array(x, type=pa.int64()),
        "xs": pa.array(np.sort(x), type=pa.int64()),
        "s": pa.array(svals, type=pa.binary()),
        "f": pa.array(rng.random(n) * 1e6 - 5e5, type=pa.float64()),
        "g": pa.array(rng.random(n).astype(np.float32), type=pa.float32()),
        "k": pa.array(rng.integers(-99999, 99999, n).astype(np.int32),
                      type=pa.int32()),
        "b": pa.array(rng.integers(0, 2, n).astype(bool), type=pa.bool_()),
    })
    path = d / "pidx.parquet"
    pq.write_table(t, path, write_page_index=True, use_dictionary=False,
                   write_statistics=True, data_page_size=2048,
                   row_group_size=2000, data_page_version="2.0",
                   compression="snappy")
    return str(path)


FILES = {"mixed": _own_mixed, "strings_plain": _own_strings_plain,
         "strings_dict": _own_strings_dict, "flba": _own_flba,
         "arrow_nested": _arrow_nested, "arrow_stats": _arrow_stats}


@pytest.fixture(scope="module")
def readers(tmp_path_factory):
    """{kind: (port reader, reference reader)}, each file written once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            path = FILES[kind](tmp_path_factory.mktemp(f"rd_{kind}"))
            cache[kind] = (reader.ParquetReader(path),
                           ref_reader.ParquetReader(path))
        return cache[kind]

    return get


def _values_equal(a, b, msg=""):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, msg
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), msg
    else:
        assert list(a) == list(b), msg


def _same_column(got, want, msg=""):
    assert type(got).__name__ == type(want).__name__, msg
    assert got.type.name == want.type.name, msg
    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(want.valid), err_msg=msg)
    _values_equal(got.values, want.values, msg)
    assert got.to_strings() == want.to_strings(), msg


@pytest.mark.parametrize("kind", list(FILES))
def test_schema_and_metadata(readers, kind):
    r, j = readers(kind)
    assert r.schema_string() == j.schema_string()
    assert r.metadata() == j.metadata()
    assert (r.num_columns(), r.num_rows(), r.num_row_groups(),
            r.file_size()) == (j.num_columns(), j.num_rows(),
                               j.num_row_groups(), j.file_size())
    assert r.column_names() == j.column_names()
    for a, b in zip(r.columns(), j.columns()):
        assert (a.name, a.type.name, a.column_index, a.max_def_level,
                a.max_rep_level, a.type_length) == (
            b.name, b.type.name, b.column_index, b.max_def_level,
            b.max_rep_level, b.type_length)
    for name in ("nope", "i.nope"):
        assert r.find_column(name) == j.find_column(name) == -1
    with pytest.raises(KeyError):
        r.column("nope")
    with pytest.raises(IndexError):
        r.column(10_000)


@pytest.mark.parametrize("kind", list(FILES))
def test_read_column_whole_and_by_row_group(readers, kind):
    r, j = readers(kind)
    for idx in range(r.num_columns()):
        _same_column(r.read_column_by_idx(-1, idx),
                     j.read_column_by_idx(-1, idx), f"{kind} col {idx}")
        last = r.num_row_groups() - 1
        _same_column(r.read_column_by_idx(last, idx),
                     j.read_column_by_idx(last, idx), f"{kind} col {idx} rg")
    name = r.column_names()[0]
    if r.column_names().count(name) == 1:
        _same_column(r.read_column(name, 0), j.read_column(name, 0))
        assert (r.read_column(name).to_pylist()
                == j.read_column(name).to_pylist())
    with pytest.raises(KeyError):
        r.read_column("nope")
    with pytest.raises(IndexError):
        r.read_column_by_idx(99, 0)


@pytest.mark.parametrize("kind", ["mixed", "strings_dict", "flba",
                                  "arrow_nested"])
def test_read_column_when_the_native_sweep_declines(readers, kind,
                                                    monkeypatch):
    """The `_materialize_*` helpers (the port's tensor decode on the CPU)
    behind the native PS_COLUMN route give the same column."""
    r, j = readers(kind)
    monkeypatch.setattr(reader, "_wrap_native_column", lambda *a: None)
    for idx in range(r.num_columns()):
        got, want = r.read_column_by_idx(-1, idx), j.read_column_by_idx(-1,
                                                                        idx)
        np.testing.assert_array_equal(np.asarray(got.valid),
                                      np.asarray(want.valid))
        assert got.to_pylist() == want.to_pylist(), f"{kind} col {idx}"
    n = r.num_rows()
    assert (r.read_rows(0, n // 3, n // 2).to_pylist()
            == j.read_rows(0, n // 3, n // 2).to_pylist())


@pytest.mark.parametrize("kind", ["mixed", "strings_plain", "strings_dict",
                                  "flba", "arrow_stats"])
def test_read_rows(readers, kind):
    r, j = readers(kind)
    n = r.num_rows()
    rng = np.random.default_rng(2)
    spans = [(0, n), (0, 1), (n - 1, n), (n // 2, n // 2), (5, 3),
             (-4, 9), (n - 3, n + 50)]
    spans += [tuple(sorted(rng.integers(0, n, 2).tolist())) for _ in range(8)]
    for idx in range(r.num_columns()):
        whole = j.read_column_by_idx(-1, idx)
        for lo, hi in spans:
            got, want = r.read_rows(idx, lo, hi), j.read_rows(idx, lo, hi)
            msg = f"{kind} col {idx} rows [{lo}, {hi})"
            np.testing.assert_array_equal(np.asarray(got.valid),
                                          np.asarray(want.valid), err_msg=msg)
            assert got.to_pylist() == want.to_pylist(), msg
            a, b = max(lo, 0), min(hi, n)
            if b > a:
                assert got.to_pylist() == whole.to_pylist()[a:b], msg
    with pytest.raises(KeyError):
        r.read_rows("nope", 0, 1)


@pytest.mark.parametrize("kind", ["mixed", "strings_plain", "strings_dict"])
def test_read_pages(readers, kind):
    r, j = readers(kind)
    for name in r.column_names():
        if r.column(name).type.name == "FIXED_LEN_BYTE_ARRAY":
            continue
        for rg in range(r.num_row_groups()):
            got, want = r.read_pages(name, rg), j.read_pages(name, rg)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert (a.page_num, a.type.name, a.num_values) == (
                    b.page_num, b.type.name, b.num_values)
                assert (a.values is None) == (b.values is None)
                if b.values is not None:
                    assert a.values.to_pylist() == b.values.to_pylist()


@pytest.mark.parametrize("kind", ["mixed", "strings_plain", "arrow_stats"])
def test_raw_page_api_and_iterators(readers, kind):
    r, j = readers(kind)
    n = r.num_pages()
    assert n == j.num_pages() and n > 2
    for gid in (0, 1, n // 2, n - 1):
        assert vars(r.page_index_entry(gid)) == vars(j.page_index_entry(gid))
        assert r.read_page_data(gid) == j.read_page_data(gid)
    assert r.read_pages_chunk(1, n - 1, 5000) == j.read_pages_chunk(
        1, n - 1, 5000)
    assert r.read_range(4, 64) == j.read_range(4, 64)
    for bad in ((n, n), (0, n), (2, 1)):
        with pytest.raises(IndexError):
            r.read_pages_chunk(*bad, 100)
    with pytest.raises(IndexError):
        r.page_index_entry(n)
    it, jt = r.page_iterator(1, min(n, 6)), j.page_iterator(1, min(n, 6))
    got = [(p.page_id, p.row_group_idx, p.column_idx, p.data) for p in it]
    assert got == [(p.page_id, p.row_group_idx, p.column_idx, p.data)
                   for p in jt]
    assert not it.has_next()
    with pytest.raises(StopIteration):
        it.next()
    it.reset()
    assert it.next().page_id == 1
    with pytest.raises(IndexError):
        r.page_iterator(3, 2)
    strings = [c.name for c in r.columns() if c.type.name == "BYTE_ARRAY"]
    for name in strings:
        assert list(r.column_iterator(name)) == list(j.column_iterator(name))
    fixed = [c.name for c in r.columns() if c.type.name == "INT64"]
    if fixed:
        with pytest.raises(TypeError):
            r.column_iterator(fixed[0])


@pytest.mark.parametrize("kind", ["mixed", "arrow_stats", "arrow_nested"])
def test_statistics_api(readers, kind):
    r, j = readers(kind)
    for idx in range(r.num_columns()):
        assert r.column_stats(idx) == j.column_stats(idx)
        a, b = r.page_stats(idx), j.page_stats(idx)
        assert len(a) == len(b)
        for field in ("gid", "row_start", "has_stats", "null_page",
                      "null_count", "oi_offset", "oi_csize", "oi_first_row"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field), err_msg=field)
        assert a.mins == b.mins and a.maxs == b.maxs
    with pytest.raises(KeyError):
        r.column_stats("nope")
    with pytest.raises(KeyError):
        r.page_stats("nope")


def test_page_stats_prune(readers):
    r, j = readers("arrow_stats")
    a, b = r.page_stats("xs"), j.page_stats("xs")
    mid = int(np.asarray(j.read_column("xs").values)[3000])
    for op, args in (("==", (mid,)), ("<", (mid,)), ("<=", (mid,)),
                     (">", (mid,)), (">=", (mid,)),
                     ("between", (mid, mid + 10**9))):
        got, want = a.prune(op, *args), b.prune(op, *args)
        np.testing.assert_array_equal(got, want, err_msg=op)
    assert len(a.prune("==", mid)) > 0
    s, js = r.page_stats("s"), j.page_stats("s")
    np.testing.assert_array_equal(s.prune("prefix", b"tok-5"),
                                  js.prune("prefix", b"tok-5"))
    with pytest.raises(ValueError):
        a.prune("~", 1)
    with pytest.raises(TypeError):
        s.prune("prefix", "tok")


def test_read_table_and_nested_readers(readers):
    r, j = readers("arrow_nested")
    got, want = r.read_table(), j.read_table()
    assert list(got) == list(want)
    for field in want:
        assert type(got[field]).__name__ == type(want[field]).__name__, field
        assert len(got[field]) == len(want[field])
        assert got[field].to_pylist() == want[field].to_pylist(), field
    sub = r.read_table(columns=["i", "m"])
    assert set(sub) == {"i", "m"}
    with pytest.raises(KeyError):
        r.read_table(columns=["nope"])
    lst, jlst = r.read_list_column("l"), j.read_list_column("l")
    for f in ("offsets", "list_valid", "elem_valid", "elem_slots"):
        np.testing.assert_array_equal(getattr(lst, f), getattr(jlst, f))
    assert lst.to_pylist() == jlst.to_pylist()
    assert (r.read_list_column("ll").to_pylist()
            == j.read_list_column("ll").to_pylist())
    st, jst = r.read_struct_column("st"), j.read_struct_column("st")
    assert st.fields == jst.fields and st.to_pylist() == jst.to_pylist()
    assert (r.read_map_column("m").to_pylist()
            == j.read_map_column("m").to_pylist())
    for prefix in ("st", "m", "ll", "l"):
        assert r.assemble_field(prefix) == j.assemble_field(prefix)
    with pytest.raises(TypeError):
        r.read_list_column("i")
    with pytest.raises(KeyError):
        r.read_struct_column("i")
    with pytest.raises(KeyError):
        r.assemble_field("nope")


def test_open_close_and_errors(tmp_path, readers):
    with pytest.raises(IOError):
        reader.ParquetReader(str(tmp_path / "missing.parquet"))
    r = reader.ParquetReader()
    assert not r.open(str(tmp_path / "missing.parquet"))
    path = readers("mixed")[0]._path
    with reader.ParquetReader(path) as r2:
        assert r2.num_rows() == 1200
    assert r2._h is None
    r2.close()  # closing twice is harmless


def test_to_arrow_bridge(readers):
    pytest.importorskip("pyarrow")
    r, j = readers("mixed")
    for name in ("i64_opt", "f64", "city"):
        assert r.read_column(name).to_arrow().equals(
            j.read_column(name).to_arrow())


# ── prescan: one signature, one set of defaults ─────────────────────────────


def test_prescan_signature_and_defaults_match_reference(readers):
    """The same call gives the same arrays in both packages."""
    sig = inspect.signature(reader.ParquetReader.prescan)
    ref = inspect.signature(ref_reader.ParquetReader.prescan)
    assert list(sig.parameters) == list(ref.parameters)
    for name, p in ref.parameters.items():
        assert sig.parameters[name].default == p.default, name
    assert sig.parameters["flags"].default == bindings.PS_HOST_STRINGS
    r, j = readers("mixed")
    for col in ("comment", "city", "i64_opt"):
        for kw in ({}, {"pad_strings": 8}, {"align": 256},
                   {"row_lo": 100, "row_hi": 300},
                   {"rg0": 1, "rg1": 2, "flags": bindings.PS_PAYLOAD}):
            a, b = r.prescan(col, **kw), j.prescan(col, **kw)
            assert a.dims == b.dims, (col, kw)
            assert sorted(a.arrays) == sorted(b.arrays), (col, kw)
            for k in a.arrays:
                assert a.arrays[k].dtype == b.arrays[k].dtype, k
                np.testing.assert_array_equal(a.arrays[k], b.arrays[k],
                                              err_msg=f"{col} {kw} {k}")
    with pytest.raises(KeyError):
        r.prescan("nope")
