"""Fixed-width decode of the port (duckdb_parquet_parser_tpu_torch/ops/
decode.py: `decode_fixed`, `decode_fixed_device`, the plane helpers; host/
reader.py: `_materialize_fixed`; host/batch.py's typed views) against the
reference: its numpy golden model (`decode_fixed(np, ...)`,
`_materialize_fixed(engine="numpy")`) and its jit entry `decode_fixed_jax` on
the CPU.  The cases are those of tests/test_decode.py and tests/
test_materialized.py, run through both packages, plus mixed PLAIN /
dictionary pages, out-of-range dictionary indices, a narrow index plane and
a boolean dictionary.  Tolerance 0: int32 planes, masks, and values compared
as integer views.  The `cuda`-marked cases hold the decode on the card
against the decode on the CPU and need only the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from duckdb_parquet_parser_tpu_torch.host import bindings
from duckdb_parquet_parser_tpu_torch.host.reader import (
    ParquetReader,
    _materialize_fixed,
    _materialize_strings,
)
from duckdb_parquet_parser_tpu_torch.host.schema import ParquetType
from duckdb_parquet_parser_tpu_torch.host.writer import (
    ColumnSpec,
    ParquetWriter,
)
from duckdb_parquet_parser_tpu_torch.ops import decode as td
from duckdb_parquet_parser_tpu_torch.ops import expand as te
from duckdb_parquet_parser_tpu_torch.ops.kernels import dict_lookup

FIXED = ["i64", "i64_opt", "i32", "f32", "f64", "flag", "code"]
FLAGS = {"planes": 0, "runs_only": bindings.PS_RUNS_ONLY}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _strings(rng, n, n_unique=None, null_p=0.0):
    if n_unique:
        pool = [f"city_{i}_{'x' * (i % 4)}".encode() for i in range(n_unique)]
        vals = [pool[int(rng.integers(n_unique))] for _ in range(n)]
    else:
        letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
        vals = [bytes(rng.choice(letters, int(rng.integers(3, 31))))
                for _ in range(n)]
    return [None if rng.random() < null_p else v for v in vals]


def mixed_file(path, rng, rows_per_rg=(700, 500), null_p=0.12) -> str:
    """Every writer-supported type, optional and required, dictionary and
    PLAIN, two row groups (the layout of tests/fixtures.mixed_file, written
    with the port's writer)."""
    specs = [
        ColumnSpec("i64", ParquetType.INT64),
        ColumnSpec("i64_opt", ParquetType.INT64, optional=True),
        ColumnSpec("i32", ParquetType.INT32, optional=True),
        ColumnSpec("f32", ParquetType.FLOAT, optional=True),
        ColumnSpec("f64", ParquetType.DOUBLE),
        ColumnSpec("flag", ParquetType.BOOLEAN, optional=True),
        ColumnSpec("city", ParquetType.BYTE_ARRAY, optional=True),
        ColumnSpec("comment", ParquetType.BYTE_ARRAY, optional=True),
        ColumnSpec("code", ParquetType.INT32),
    ]
    w = ParquetWriter(str(path), specs)
    for n in rows_per_rg:
        valid = (rng.random(n) > null_p).astype(np.uint8)
        f64 = rng.standard_normal(n)
        f64[:4] = [-0.0, np.inf, -np.inf, 0.0]
        f64[4:6] = np.array([0x7FF8DEADBEEF0001, 0xFFF0000000000123],
                            np.uint64).view(np.float64)  # NaN payloads
        w.write_row_group({
            "i64": rng.integers(-(2**62), 2**62, n),
            "i64_opt": (rng.integers(-(2**62), 2**62, n), valid),
            "i32": (rng.integers(-(2**31), 2**31, n).astype(np.int32), valid),
            "f32": (rng.random(n).astype(np.float32), valid),
            "f64": f64,
            "flag": (rng.random(n) > 0.5, valid),
            "city": _strings(rng, n, n_unique=9, null_p=null_p),
            "comment": _strings(rng, n, null_p=null_p),
            "code": np.asarray(rng.choice([7, 11, 13, 17], n), np.int32),
        })
    w.close()
    return str(path)


@pytest.fixture(scope="module")
def mixed_path(tmp_path_factory):
    return mixed_file(tmp_path_factory.mktemp("tdf") / "m.parquet",
                      np.random.default_rng(99))


def _kw(b):
    return dict(max_def=b.max_def, out_len=b.vmax, nn_len=b.nn_cap,
                mode=b.mode)


def _port_decode(b, device="cpu", arrays=None, **over):
    planes, nn = td.decode_fixed_device(
        b.arrays if arrays is None else arrays, b.plain_planes,
        b.dict_planes, b.bool_bits, device=device, **{**_kw(b), **over})
    return [p.cpu().numpy() for p in planes], nn.cpu().numpy()


def _ref_batch(path, col, flags=0):
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR

    return JR(path).prescan(col, flags=flags)


def _same_planes(got, want, msg=""):
    (gp, gn), (wp, wn) = got, want
    np.testing.assert_array_equal(gn, np.asarray(wn), err_msg=msg)
    assert len(gp) == len(wp), msg
    for a, b in zip(gp, wp):
        assert a.dtype == np.int32, msg
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=msg)


# ── run expansion (tests/test_decode.py's scalar decoder as truth) ──────────


def _expand_case(rng, bw, n, want):
    from tests.test_decode import encode_hybrid, prescan_py, scalar_rle_decode

    values = rng.integers(0, 1 << bw, n).astype(np.int64)
    data = encode_hybrid(rng, list(values), bw)
    expect = scalar_rle_decode(data, bw, want)
    runs = prescan_py(data, bw, want)
    pad = ((len(data) + 4 + 127) // 128) * 128
    section = np.zeros((1, pad), np.uint8)
    section[0, :len(data)] = np.frombuffer(data, np.uint8)
    cols = np.zeros((5, 1, len(runs)), np.int32)
    for r, run in enumerate(runs):
        cols[:, 0, r] = run
    args = [*cols, section, np.array([bw], np.int32)]
    return args, expect


@pytest.mark.parametrize("bw", [1, 2, 3, 5, 7, 8, 11, 16, 20, 24])
def test_expand_hybrid_matches_scalar_decoder(bw):
    from duckdb_parquet_parser_tpu.ops.expand import expand_hybrid

    rng = np.random.default_rng(1234 + bw)
    args, expect = _expand_case(rng, bw, 371, 371)
    got = te.expand_hybrid(*[torch.from_numpy(a) for a in args], 371)
    assert got.dtype == torch.int32
    assert got.numpy()[0].tolist() == expect
    np.testing.assert_array_equal(got.numpy(), expand_hybrid(np, *args, 371))


def test_expand_zero_fill_on_truncation():
    rng = np.random.default_rng(77)
    args, expect = _expand_case(rng, 4, 40, 80)
    assert expect[40:] == [0] * 40
    got = te.expand_hybrid(*[torch.from_numpy(a) for a in args], 80)
    assert got.numpy()[0].tolist() == expect


# ── batch decode on real fixtures ───────────────────────────────────────────


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("col", FIXED)
def test_decode_fixed_matches_reference(mixed_path, col, flags):
    from duckdb_parquet_parser_tpu.ops import decode as jd

    b = ParquetReader(mixed_path).prescan(col, flags=FLAGS[flags])
    rb = _ref_batch(mixed_path, col, FLAGS[flags])
    assert (b.mode, b.type.name, b.total_rows) == (rb.mode, rb.type.name,
                                                   rb.total_rows)
    assert b.value_dtype == rb.value_dtype
    for a, r in zip(b.plain_planes + b.dict_planes,
                    rb.plain_planes + rb.dict_planes):
        np.testing.assert_array_equal(a, r)
    got = _port_decode(b)
    want = jd.decode_fixed(np, rb.arrays, rb.plain_planes, rb.dict_planes,
                           rb.bool_bits, **_kw(rb))
    _same_planes(got, want, f"{col} numpy")
    if flags == "planes":  # the jit entry compiles per column: once is enough
        want = jd.decode_fixed_jax(rb.arrays, rb.plain_planes, rb.dict_planes,
                                   rb.bool_bits, **_kw(rb))
        _same_planes(got, want, f"{col} jax")


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("col", FIXED)
def test_materialize_fixed_matches_reference(mixed_path, col, flags):
    from duckdb_parquet_parser_tpu.host.reader import _materialize_fixed as jm

    got = _materialize_fixed(
        ParquetReader(mixed_path).prescan(col, flags=FLAGS[flags]),
        device="cpu")
    want = jm(_ref_batch(mixed_path, col, FLAGS[flags]), engine="numpy")
    assert got.type.name == want.type.name
    np.testing.assert_array_equal(got.valid, want.valid)
    g, w = np.asarray(got.values), np.asarray(want.values)
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    # and the native PS_COLUMN sweep, which is independent C++ code
    native = ParquetReader(mixed_path).read_column(col)
    np.testing.assert_array_equal(native.valid, got.valid)
    keep = np.asarray(got.valid)
    np.testing.assert_array_equal(
        np.asarray(native.values)[keep].view(np.uint8), g[keep].view(np.uint8))


def test_batch_slice_pages(mixed_path):
    r = ParquetReader(mixed_path)
    b = r.prescan("i64")
    whole = r.read_column("i64")
    half = b.slice_pages(0, b.n_pages // 2)
    assert half.n_pages == b.n_pages // 2
    assert (half.total_rows
            + b.slice_pages(b.n_pages // 2, b.n_pages).total_rows) == len(whole)


def test_heavy_nulls(tmp_path):
    from duckdb_parquet_parser_tpu.ops import decode as jd

    rng = np.random.default_rng(5)
    path = str(tmp_path / "heavy.parquet")
    n = 2000
    valid = (rng.random(n) > 0.9).astype(np.uint8)  # 90% null
    w = ParquetWriter(path, [ColumnSpec("x", ParquetType.DOUBLE,
                                        optional=True)])
    w.write_row_group({"x": (rng.random(n), valid)})
    w.close()
    b = ParquetReader(path).prescan("x")
    rb = _ref_batch(path, "x")
    assert jd.max_nulls_per_page(rb.arrays) > 64
    want = jd.decode_fixed(np, rb.arrays, rb.plain_planes, [], None,
                           **{**_kw(rb), "mode": "plain"})
    _same_planes(_port_decode(b, mode="plain"), want)
    want = jd.decode_fixed_jax(rb.arrays, rb.plain_planes, [], None,
                               **{**_kw(rb), "mode": "plain"})
    _same_planes(_port_decode(b, mode="plain"), want)


def _null_patterns(rng, n):
    alt = np.zeros(n, np.uint8)
    alt[::2] = 1
    blk = np.ones(n, np.uint8)
    blk[n // 4:3 * n // 4] = 0
    return [np.zeros(n, np.uint8), np.ones(n, np.uint8), alt, blk,
            (rng.random(n) > 0.9).astype(np.uint8),
            (rng.random(n) > 0.05).astype(np.uint8)]


@pytest.mark.parametrize("pat_i", range(6))
def test_masked_cells_decode_to_zero(tmp_path, pat_i):
    from duckdb_parquet_parser_tpu.ops import decode as jd

    rng = np.random.default_rng(40 + pat_i)
    n = 1500
    valid = _null_patterns(rng, n)[pat_i]
    path = str(tmp_path / f"masked{pat_i}.parquet")
    w = ParquetWriter(path, [
        ColumnSpec("d", ParquetType.DOUBLE, optional=True),
        ColumnSpec("c", ParquetType.INT32, optional=True),  # dict-encoded
    ])
    w.write_row_group({
        "d": (rng.standard_normal(n), valid),
        "c": (rng.integers(0, 5, n).astype(np.int32), valid),
    })
    w.close()
    r = ParquetReader(path)
    for col in ("d", "c"):
        for flags in FLAGS.values():
            b = r.prescan(col, flags=flags)
            rb = _ref_batch(path, col, flags)
            planes, nn = _port_decode(b)
            _same_planes((planes, nn), jd.decode_fixed(
                np, rb.arrays, rb.plain_planes, rb.dict_planes, rb.bool_bits,
                **_kw(rb)), col)
            masked = ~nn
            assert masked.any() or valid.all()
            for p in planes:
                assert not p[masked].any(), (
                    f"{col}: non-zero decoded value at a masked cell")


def test_multi_row_group_dictionary(tmp_path):
    """Chunk dictionaries that differ in entry order: the page's base offset
    into the one concatenated table, on the level-free route and on the
    run-expansion route (no `idx_vals`)."""
    from duckdb_parquet_parser_tpu.ops import decode as jd

    rng = np.random.default_rng(41)
    path = str(tmp_path / "multi_rg_dict.parquet")
    w = ParquetWriter(path, [ColumnSpec("k", ParquetType.INT64,
                                        optional=True)])
    expect = []
    for rg in range(3):
        n = 3000
        vals = (rng.permutation(40)[rng.integers(0, 40, n)] + rg * 1000) * 7
        mask = (rng.random(n) > 0.1).astype(np.uint8)
        w.write_row_group({"k": (vals, mask)})
        expect.extend(int(v) if m else None for v, m in zip(vals, mask))
    w.close()
    r = ParquetReader(path)
    b = r.prescan("k")
    rb = _ref_batch(path, "k")
    assert b.mode == "dict"
    assert len(set(np.asarray(b.arrays["page_dict_base"]).tolist())) > 1
    want = jd.decode_fixed(np, rb.arrays, [], rb.dict_planes, None,
                           **_kw(rb))
    _same_planes(_port_decode(b), want)
    _same_planes(_port_decode(b), jd.decode_fixed_jax(
        rb.arrays, [], rb.dict_planes, None,
        dict_planes_pp=rb.dict_planes_pp, **_kw(rb)))
    legacy = {k: v for k, v in b.arrays.items() if k != "idx_vals"}
    _same_planes(_port_decode(b, arrays=legacy), want)
    assert r.read_column("k").to_pylist() == expect
    assert _materialize_fixed(b, device="cpu").to_pylist() == expect


def _mixed_pages_file(path):
    """An INT64 column whose first row group is dictionary-encoded and whose
    second is PLAIN."""
    rng = np.random.default_rng(8)
    w = ParquetWriter(str(path), [ColumnSpec("v", ParquetType.INT64,
                                             optional=True)])
    n = 2500
    mask = (rng.random(n) > 0.1).astype(np.uint8)
    w.write_row_group({"v": (rng.integers(0, 6, n) * 1_000_003, mask)})
    w.write_row_group({"v": (rng.integers(-(2**62), 2**62, n), mask)})
    w.close()
    return str(path)


@pytest.mark.parametrize("flags", list(FLAGS))
def test_mixed_plain_and_dictionary_pages(tmp_path, flags):
    from duckdb_parquet_parser_tpu.host.reader import _materialize_fixed as jm
    from duckdb_parquet_parser_tpu.ops import decode as jd

    path = _mixed_pages_file(tmp_path / "mixed_pages.parquet")
    b = ParquetReader(path).prescan("v", flags=FLAGS[flags])
    rb = _ref_batch(path, "v", FLAGS[flags])
    assert b.mode == "mixed"
    _same_planes(_port_decode(b), jd.decode_fixed(
        np, rb.arrays, rb.plain_planes, rb.dict_planes, None, **_kw(rb)))
    got, want = _materialize_fixed(b, device="cpu"), jm(rb, engine="numpy")
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.valid, want.valid)


@pytest.mark.parametrize("narrow", [None, np.int16])
def test_out_of_range_dictionary_indices_decode_to_null(mixed_path, narrow):
    """An index outside the page's dictionary is a NULL, not an error; the
    index plane may be stored narrower than int32."""
    from duckdb_parquet_parser_tpu.ops import decode as jd

    b = ParquetReader(mixed_path).prescan("code")
    rb = _ref_batch(mixed_path, "code")
    arrays = dict(b.arrays)
    idx = np.array(arrays["idx_vals"])
    rng = np.random.default_rng(3)
    hit = rng.random(idx.shape) < 0.05
    idx[hit] = rng.choice([4, 5, 100, 30000], int(hit.sum()))
    arrays["idx_vals"] = idx if narrow is None else idx.astype(narrow)
    want = jd.decode_fixed(np, {**rb.arrays, "idx_vals": arrays["idx_vals"]},
                           rb.plain_planes, rb.dict_planes, None, **_kw(rb))
    got = _port_decode(b, arrays=arrays)
    _same_planes(got, want)
    assert hit.any() and not got[1][hit].any()  # the tampered cells are NULL


def test_plane_helpers_match_reference():
    from duckdb_parquet_parser_tpu.ops import decode as jd

    rng = np.random.default_rng(12)
    for width in (4, 8, 12):
        raw = rng.integers(0, 256, (5, 6 * width), dtype=np.uint8)
        for a, b in zip(td.fixed_planes_from_bytes(raw, width),
                        jd.fixed_planes_from_bytes(raw, width)):
            np.testing.assert_array_equal(a, b)
        table = rng.integers(0, 256, (7, width), dtype=np.uint8)
        for a, b in zip(td.dict_planes_from_bytes(table, width),
                        jd.dict_planes_from_bytes(table, width)):
            np.testing.assert_array_equal(a, b)
    assert td.fixed_planes_from_bytes(np.zeros((3, 0), np.uint8), 0) == []
    # a boolean dictionary stores one byte an entry
    flags = np.array([[1], [0], [1]], np.uint8)
    (plane,) = td.dict_planes_from_bytes(flags, 1)
    assert plane.dtype == np.int32 and plane.tolist() == [1, 0, 1]
    np.testing.assert_array_equal(plane,
                                  jd.dict_planes_from_bytes(flags, 1)[0])
    planes = [rng.integers(-2**31, 2**31, (4, 9), dtype=np.int64).astype(
        np.int32) for _ in range(3)]
    for dtype, k in (("<i4", 1), ("<f4", 1), ("<i8", 2), ("<f8", 2),
                     ("V12", 3)):
        got = td.planes_to_array(planes[:k], np.dtype(dtype))
        want = jd.planes_to_array(planes[:k], np.dtype(dtype))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_dictionary_decode_goes_through_the_gather_entry(mixed_path,
                                                        monkeypatch):
    """`_lookup_values` hands one contiguous [P, DN] int32 table and a
    contiguous int32 index to the dictionary kernel's gather entry, once
    per decode."""
    calls = []
    real = dict_lookup.dict_lookup

    def spy(planes, gidx):
        calls.append((planes, gidx))
        return real(planes, gidx)

    monkeypatch.setattr(dict_lookup, "dict_lookup", spy)
    b = ParquetReader(mixed_path).prescan("code")
    _port_decode(b)
    ((planes, gidx),) = calls
    assert isinstance(planes, torch.Tensor) and planes.dtype == torch.int32
    assert planes.shape == (1, int(b.arrays["dict_fixed"].shape[0]))
    assert planes.is_contiguous() and gidx.is_contiguous()
    assert gidx.dtype == torch.int32 and gidx.shape == (b.n_pages, b.vmax)


# ── tests/test_materialized.py through both packages ────────────────────────


@pytest.mark.parametrize("col", ["i64_opt", "city", "code", "flag", "f32"])
def test_planes_match_run_expansion(mixed_path, col):
    from duckdb_parquet_parser_tpu.ops import decode as jd

    r = ParquetReader(mixed_path)
    for flags in FLAGS.values():
        b = r.prescan(col, flags=flags)
        rb = _ref_batch(mixed_path, col, flags)
        assert ("def_levels" in b.arrays) == ("def_levels" in rb.arrays)
        core = b.to_device("cpu", td.DECODE_ARRAYS)
        nn, idx = td.decode_levels(core, b.max_def, b.vmax)
        rnn, ridx = jd.decode_levels(np, rb.arrays, rb.max_def, rb.vmax)
        np.testing.assert_array_equal(nn.numpy(), rnn)
        np.testing.assert_array_equal(idx.numpy(), ridx)
        if bool((b.arrays["page_kind"] == 1).any()):
            d, ok = td.decode_dict_indices(core, idx, b.nn_cap)
            rd, rok = jd.decode_dict_indices(np, rb.arrays, ridx, rb.nn_cap)
            np.testing.assert_array_equal(
                np.where(ok.numpy() & nn.numpy(), d.numpy(), -1),
                np.where(rok & rnn, rd, -1))
            np.testing.assert_array_equal(ok.numpy() & nn.numpy(), rok & rnn)


def test_full_decode_matches(mixed_path):
    r = ParquetReader(mixed_path)
    for col in ["i64_opt", "city", "code"]:
        a = r.read_column(col)
        b = r.prescan(r.find_column(col), flags=bindings.PS_RUNS_ONLY,
                      pad_strings=0)
        if r.column(col).type.name == "BYTE_ARRAY":
            got = _materialize_strings(b)
            assert list(got.values) == list(a.values)
        else:
            got = _materialize_fixed(b, device="cpu")
            np.testing.assert_array_equal(got.values, a.values)
        np.testing.assert_array_equal(got.valid, a.valid)


def test_string_values_slicing(mixed_path):
    c = ParquetReader(mixed_path).read_column("comment")
    n = len(c)
    sl = c.values[2:n // 2]
    assert len(sl) == n // 2 - 2
    assert sl[0] == c.values[2]
    assert list(sl) == [c.values[i] for i in range(2, n // 2)]


# ── on the card ─────────────────────────────────────────────────────────────


@pytest.mark.cuda
@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("col", FIXED)
def test_device_decode_matches_cpu(cuda, mixed_path, col, flags):
    b = ParquetReader(mixed_path).prescan(col, flags=FLAGS[flags])
    before = dict_lookup.launches
    got = _port_decode(b, device=cuda)
    torch.cuda.synchronize()
    assert dict_lookup.launches == before + (1 if b.mode != "plain" else 0)
    _same_planes(got, _port_decode(b))
    a, c = _materialize_fixed(b, device=cuda), _materialize_fixed(
        b, device="cpu")
    np.testing.assert_array_equal(a.valid, c.valid)
    np.testing.assert_array_equal(np.asarray(a.values).view(np.uint8),
                                  np.asarray(c.values).view(np.uint8))


@pytest.mark.cuda
def test_device_decode_mixed_pages_and_bad_indices(cuda, tmp_path,
                                                   mixed_path):
    b = ParquetReader(_mixed_pages_file(tmp_path / "mp.parquet")).prescan("v")
    _same_planes(_port_decode(b, device=cuda), _port_decode(b))
    b = ParquetReader(mixed_path).prescan("code")
    arrays = dict(b.arrays)
    idx = np.array(arrays["idx_vals"])
    idx[:, ::7] = 30000
    arrays["idx_vals"] = idx
    _same_planes(_port_decode(b, device=cuda, arrays=arrays),
                 _port_decode(b, arrays=arrays))
