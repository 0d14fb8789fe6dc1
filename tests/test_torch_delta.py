"""DELTA_BINARY_PACKED decode of the port (duckdb_parquet_parser_tpu_torch/
ops/delta.py) and the other V2 value encodings through its reader, against
the reference on the pyarrow-written files of tests/test_v2_encodings.py
(`read_column`, `read_delta_column(engine="numpy" / "jax")`, the string
iterator, `cold_scan`'s prescan route for delta-coded strings), and the
seeded structure planes of `utils/fixtures.delta_planes` against the values
they were packed from.  Tolerance 0: values are integers (doubles are
compared as bytes).  The `cuda`-marked cases hold the decode on the card
against the seed's values and need only the port."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from duckdb_parquet_parser_tpu_torch.host.bindings import NativeError
from duckdb_parquet_parser_tpu_torch.host.reader import ParquetReader
from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from duckdb_parquet_parser_tpu_torch.ops import delta as td
from duckdb_parquet_parser_tpu_torch.utils import fixtures as fx


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def pa():
    return pytest.importorskip("pyarrow")


def _write(tmp_path, name, table, encodings, **kw):
    import pyarrow.parquet as pq

    path = tmp_path / name
    pq.write_table(table, path, use_dictionary=False,
                   column_encoding=encodings, data_page_version="2.0",
                   write_statistics=False, **kw)
    return str(path)


def _pylist(col):
    return [v.item() if isinstance(v, np.generic) else v
            for v in col.to_pylist()]


def _same_column(got, want):
    assert got.type.name == want.type.name
    np.testing.assert_array_equal(got.valid, want.valid)
    g, w = got.values, want.values
    if isinstance(w, np.ndarray):
        assert g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()
    else:
        assert list(g) == list(w)


def _ref_reader(path):
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR

    return JR(path)


@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_rle_booleans(pa, tmp_path, compression):
    rng = np.random.default_rng(3)
    vals = [None if rng.random() < 0.1 else bool(v)
            for v in rng.integers(0, 2, 5000)]
    path = _write(tmp_path, f"rle_bool_{compression}.parquet",
                  pa.table({"b": pa.array(vals, type=pa.bool_())}),
                  {"b": "RLE"}, compression=compression)
    col = ParquetReader(path).read_column("b")
    assert _pylist(col) == vals
    _same_column(col, _ref_reader(path).read_column("b"))


@pytest.mark.parametrize("dtype,patype", [(np.int32, "int32"),
                                          (np.int64, "int64")])
@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_delta_binary_packed_host_route(pa, tmp_path, dtype, patype,
                                        compression):
    rng = np.random.default_rng(4)
    lo, hi = ((-(1 << 30), 1 << 30) if dtype == np.int32
              else (-(1 << 55), 1 << 55))
    base = rng.integers(lo, hi, 7000).astype(dtype)
    base[:100] = np.arange(100, dtype=dtype)  # a low-bit-width run
    vals = [None if rng.random() < 0.08 else int(v) for v in base]
    path = _write(tmp_path, f"dbp_{patype}_{compression}.parquet",
                  pa.table({"x": pa.array(vals, type=getattr(pa, patype)())}),
                  {"x": "DELTA_BINARY_PACKED"}, compression=compression)
    col = ParquetReader(path).read_column("x")
    assert _pylist(col) == vals
    _same_column(col, _ref_reader(path).read_column("x"))


@pytest.mark.parametrize("encoding", ["DELTA_LENGTH_BYTE_ARRAY",
                                      "DELTA_BYTE_ARRAY"])
@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_delta_strings(pa, tmp_path, encoding, compression):
    rng = np.random.default_rng(5)
    vals = [None if rng.random() < 0.1 else
            f"prefix-{int(rng.integers(0, 9))}/key-"
            f"{int(rng.integers(0, 999)):06d}" for _ in range(4000)]
    path = _write(tmp_path, f"{encoding}_{compression}.parquet",
                  pa.table({"s": pa.array(vals, type=pa.binary())}),
                  {"s": encoding}, compression=compression)
    r = ParquetReader(path)
    col = r.read_column("s")
    assert [bytes(v).decode() if ok else None
            for v, ok in zip(col.values, np.asarray(col.valid))] == vals
    got = [(p, ln, bytes(b)) for p, ln, b in r.column_iterator("s")]
    assert got == [(i, len(v), v.encode()) for i, v in enumerate(vals)
                   if v is not None]
    assert got == list(_ref_reader(path).column_iterator("s"))


def test_byte_stream_split(pa, tmp_path):
    fv = np.random.default_rng(6).random(3000)
    path = _write(tmp_path, "bss.parquet", pa.table({
        "f": pa.array(fv, type=pa.float64()),
        "g": pa.array(fv.astype(np.float32), type=pa.float32())}),
        {"f": "BYTE_STREAM_SPLIT", "g": "BYTE_STREAM_SPLIT"})
    r = ParquetReader(path)
    assert np.asarray(r.read_column("f").values).tobytes() == fv.tobytes()
    assert np.asarray(r.read_column("g").values).tobytes() == fv.astype(
        np.float32).tobytes()


def test_delta_strings_scan_and_cold_route(pa, tmp_path):
    """The native scan does not read delta-coded string pages: `cold_scan`
    re-runs through the prescan path, as the reference's does."""
    from duckdb_parquet_parser_tpu.models.scan import ScanEngine as JE

    rng = np.random.default_rng(8)
    vals = [f"city-{int(rng.integers(0, 60))}" for _ in range(3000)]
    path = _write(tmp_path, "delta_scan.parquet",
                  pa.table({"s": pa.array(vals, type=pa.binary())}),
                  {"s": "DELTA_BYTE_ARRAY"}, compression="snappy")
    rx = re.compile(rb"city-[12]$")
    expect = sum(1 for v in vals if rx.search(v.encode()))
    eng = ScanEngine(path)
    res = eng.scan("s", "city-[12]$", device="cpu")
    assert int(res.match_counts.sum()) == expect
    for negate in (False, True):
        cold = eng.cold_scan("s", "city-[12]$", exact_counts=True,
                             negate=negate)
        want = JE(path).cold_scan("s", "city-[12]$", exact_counts=True,
                                  negate=negate)
        np.testing.assert_array_equal(cold.page_gid, want.page_gid)
        np.testing.assert_array_equal(cold.match_counts, want.match_counts)
        np.testing.assert_array_equal(cold.value_counts, want.value_counts)
    assert int(eng.cold_scan("s", "city-[12]$").match_counts.sum()) == expect


@pytest.mark.parametrize("dtype,patype", [(np.int32, "int32"),
                                          (np.int64, "int64")])
@pytest.mark.parametrize("compression", ["none", "snappy"])
def test_read_delta_column_matches_reference(pa, tmp_path, dtype, patype,
                                             compression):
    """Mixed miniblock widths, nulls, full-range magnitudes, constant runs
    (width 0), extreme negatives; the reference's numpy and jit routes."""
    from duckdb_parquet_parser_tpu.ops.delta import (
        decode_delta_planes,
        delta_bws,
        read_delta_column,
    )

    rng = np.random.default_rng(11)
    lo, hi = ((-(1 << 31), 1 << 31) if dtype == np.int32
              else (-(1 << 62), 1 << 62))
    base = rng.integers(lo, hi, 9000).astype(dtype)
    base[:200] = np.arange(200, dtype=dtype)      # low-width run
    base[300:500] = dtype(7)                      # constant run (bw 0)
    base[600:640] = dtype(lo + 1)                 # extreme negatives
    vals = [None if rng.random() < 0.08 else int(v) for v in base]
    path = _write(tmp_path, f"dev_{patype}_{compression}.parquet",
                  pa.table({"x": pa.array(vals, type=getattr(pa, patype)())}),
                  {"x": "DELTA_BINARY_PACKED"}, compression=compression,
                  data_page_size=1300)
    r = ParquetReader(path)
    col = td.read_delta_column(r, "x", device="cpu")
    assert _pylist(col) == vals
    jr = _ref_reader(path)
    for engine in ("numpy", "jax"):
        _same_column(col, read_delta_column(jr, "x", engine=engine))
    _same_column(col, r.read_column("x"))
    # the planes themselves
    from duckdb_parquet_parser_tpu.host import bindings as jb

    rb = jr.prescan("x", flags=jb.PS_DELTA_RAW)
    n_planes = 2 if dtype == np.int64 else 1
    want = decode_delta_planes(np, rb.arrays, rb.dims, delta_bws(rb.arrays),
                               rb.nn_cap, n_planes)
    b = r.prescan("x", flags=jb.PS_DELTA_RAW)
    assert td.delta_bws(b.arrays) == delta_bws(rb.arrays)
    got = td.decode_delta_planes(
        b.to_device("cpu", [k for k in b.arrays if k.startswith("delta_")]),
        b.dims, b.nn_cap, n_planes)
    assert len(got) == n_planes
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


def test_read_delta_column_required(pa, tmp_path):
    vals = list(range(0, 40000, 3))
    path = _write(tmp_path, "dev_req.parquet",
                  pa.table({"x": pa.array(vals, type=pa.int64())}),
                  {"x": "DELTA_BINARY_PACKED"})
    col = td.read_delta_column(ParquetReader(path), "x", device="cpu")
    assert np.asarray(col.valid).all()
    assert np.asarray(col.values).tolist() == vals


def test_delta_raw_rejects_plain(pa, tmp_path):
    path = _write(tmp_path, "plain.parquet",
                  pa.table({"x": pa.array(list(range(100)),
                                          type=pa.int64())}), {"x": "PLAIN"})
    with pytest.raises(NativeError):
        td.read_delta_column(ParquetReader(path), "x", device="cpu")


# ── the seeded structure planes ─────────────────────────────────────────────


def _decode(dims, arrays, device, n_planes=2):
    planes = td.decode_delta_planes(
        {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}, dims,
        dims["nn_cap"], n_planes)
    lo = planes[0].cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    if n_planes == 1:
        return lo
    return (planes[1].cpu().numpy().astype(np.int64) << 32) | lo


def _python_decode(dims, arrays, page, count):
    """One page of the structure planes decoded value by value with Python
    integers (no fixed-width arithmetic anywhere)."""
    mbv, pitch = dims["delta_mb_values"], dims["delta_pitch"]

    def u64(lo, hi):
        return (int(hi) & 0xFFFFFFFF) << 32 | (int(lo) & 0xFFFFFFFF)

    out = [u64(arrays["delta_first_lo"][page], arrays["delta_first_hi"][page])]
    for m in range(dims["delta_mb_cap"]):
        bw = int(arrays["delta_bw"][page, m])
        md = u64(arrays["delta_md_lo"][page, m], arrays["delta_md_hi"][page, m])
        bits = int.from_bytes(
            arrays["delta_bytes"][page, m * pitch:(m + 1) * pitch].tobytes(),
            "little")
        for j in range(int(arrays["delta_cnt"][page, m])):
            packed = (bits >> (j * bw)) & ((1 << bw) - 1)
            out.append((out[-1] + md + packed) % 2**64)
    assert len(out) == count
    return [v - 2**64 if v >= 2**63 else v for v in out]


@pytest.mark.parametrize("values_per_page,ragged", [
    (1, False), (2, False), (33, True), (129, False), (500, True),
    (513, True)])
def test_delta_planes_decode_to_their_values(values_per_page, ragged):
    from duckdb_parquet_parser_tpu.ops import delta as jd

    dims, arrays, values, nn = fx.delta_planes(3, 40, values_per_page,
                                               ragged=ragged)
    keep = np.arange(dims["nn_cap"])[None, :] < nn[:, None]
    got = _decode(dims, arrays, "cpu")
    np.testing.assert_array_equal(got[keep], values[keep])
    for page in (0, 7, 39):
        assert _python_decode(dims, arrays, page, int(nn[page])) == \
            values[page, :nn[page]].tolist()
    want = jd.decode_delta_planes(np, arrays, dims, jd.delta_bws(arrays),
                                  dims["nn_cap"], 2)
    planes = td.decode_delta_planes(
        {k: torch.from_numpy(v) for k, v in arrays.items()}, dims,
        dims["nn_cap"], 2)
    for g, w in zip(planes, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # int32 columns take the low lane alone
    np.testing.assert_array_equal(_decode(dims, arrays, "cpu", 1),
                                  got & 0xFFFFFFFF)
    if values_per_page >= 129:
        assert td.delta_bws(arrays)[0] == 0 and td.delta_bws(arrays)[-1] == 64
        assert len(td.delta_bws(arrays)) >= 12


def test_delta_column_that_wraps():
    """Steps that carry the running sum over the top of int64 and back:
    two's-complement wrap survives the unpack, the min-delta add, the
    prefix sum and the first-value add."""
    dims, arrays, values, nn = fx.delta_planes(9, 6, 257)
    assert (nn == 257).all()
    steps = np.diff(values.astype(object), axis=1)
    assert (np.abs(steps) >= 2**63).any()  # consecutive values wrap around
    np.testing.assert_array_equal(_decode(dims, arrays, "cpu"), values)
    # a hand-made page: max, max + 1 (wraps to min), min + 2**63 - 1, ...
    vals = np.array([[2**63 - 1, -2**63, -1, 0, -2**63, 2**63 - 1]], np.int64)
    one = {
        "delta_bw": np.array([[64]], np.int32),
        "delta_cnt": np.array([[5]], np.int32),
        "delta_md_lo": np.array([[-1]], np.int32),      # min-delta -1
        "delta_md_hi": np.array([[-1]], np.int32),
        "delta_first_lo": np.array([-1], np.int32),      # 2**63 - 1
        "delta_first_hi": np.array([2**31 - 1], np.int32),
    }
    packed = (np.diff(vals.view(np.uint64), axis=1) + np.uint64(1))
    raw = np.zeros((1, 32), np.uint64)
    raw[0, :5] = packed
    one["delta_bytes"] = raw.view(np.uint8)
    d = {"delta_mb_values": 32, "delta_mb_cap": 1, "delta_pitch": 256,
         "nn_cap": 6}
    np.testing.assert_array_equal(_decode(d, one, "cpu"), vals)
    assert _python_decode(d, one, 0, 6) == vals[0].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("values_per_page,ragged", [(2, False), (129, True),
                                                    (500, False)])
def test_delta_planes_on_the_card(cuda, values_per_page, ragged):
    dims, arrays, values, nn = fx.delta_planes(5, 300, values_per_page,
                                               ragged=ragged)
    keep = np.arange(dims["nn_cap"])[None, :] < nn[:, None]
    got = _decode(dims, arrays, cuda)
    np.testing.assert_array_equal(got[keep], values[keep])
    np.testing.assert_array_equal(got, _decode(dims, arrays, "cpu"))
