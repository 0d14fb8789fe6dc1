"""The dictionary pages' per-page counts (duckdb_parquet_parser_tpu_torch/ops/
scan.dict_counts and ops/kernels/dict_lookup.dict_count / dict_count_plain)
against the reference: the numpy route `scan_batch(xp=np)` on the same
batch, the JAX `ResidentColumn.scan` on the CPU, and an independent numpy
loop on synthetic planes.  Materialized batches go through `dict_count`
(its plain version on CPU tensors), PS_RUNS_ONLY batches through run
expansion and the gather entry.  Covers nulls, out-of-range indices (a
page dictionary cut short: the values that point past it are NULLs),
REQUIRED columns, planes narrower and wider than V, rows of PLAIN kind and
`negate`.  Tolerance 0: integer counts.  The kernel-vs-plain cases need a
CUDA device."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from duckdb_parquet_parser_tpu_torch.host import bindings
from duckdb_parquet_parser_tpu_torch.host.reader import ParquetReader
from duckdb_parquet_parser_tpu_torch.host.schema import ParquetType
from duckdb_parquet_parser_tpu_torch.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser_tpu_torch.ops import decode, scan
from duckdb_parquet_parser_tpu_torch.ops.kernels import dict_lookup

FLAGS = {"planes": bindings.PS_PAYLOAD,
         "runs_only": bindings.PS_PAYLOAD | bindings.PS_RUNS_ONLY}
PATTERNS = ["alpha", "a.*o", "_[0-4]$", "^(br|ch)"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _required_dict(path, rng):
    from tests import fixtures

    w = ParquetWriter(str(path), [ColumnSpec("s", ParquetType.BYTE_ARRAY)])
    for _rg in range(2):
        w.write_row_group({"s": fixtures.random_strings(rng, 600, n_unique=7)})
    w.close()
    return str(path)


def _mixed(path, rng):
    from tests import fixtures

    w = ParquetWriter(str(path), [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                             optional=True)],
                      key_value={"pad": "x" * 512})
    w.write_row_group({"s": fixtures.random_strings(rng, 800, n_unique=8,
                                                    null_p=0.1)})
    w.write_row_group({"s": fixtures.random_strings(rng, 800, null_p=0.1)})
    w.close()
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from tests import fixtures

    d = tmp_path_factory.mktemp("dcount")
    rng = np.random.default_rng(77)
    return {
        "dict": fixtures.strings_file(str(d / "d.parquet"), rng, n=1500,
                                      n_unique=11, null_p=0.2, rgs=3),
        "required": _required_dict(d / "r.parquet", rng),
        "mixed": _mixed(d / "m.parquet", rng),
    }


def _port_counts(batch, pattern, negate):
    """(counts [N], values [N]) of `scan.dict_counts` on the CPU."""
    _pats, dfas = scan.prepare_patterns([pattern])
    table = scan.accept_table(scan.dict_accepts(batch, dfas), "cpu")
    core = batch.to_device("cpu", decode.DECODE_ARRAYS)
    counts, values = scan.dict_counts(core, table, vmax=batch.vmax,
                                      nn_cap=batch.nn_cap,
                                      max_def=batch.max_def, negate=negate)
    return counts[0].numpy(), values.numpy()


def _cut_dictionaries(batch):
    """Halves the dictionary of every other dictionary page, so that the
    values pointing past it are out of range."""
    size = batch.arrays["page_dict_size"].copy()
    cut = (batch.arrays["page_kind"] == 1) & (np.arange(size.shape[0]) % 2 == 0)
    size[cut] = np.maximum(size[cut] // 2, 1)
    batch.arrays["page_dict_size"] = size
    return int(cut.sum())


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("name", ["dict", "required", "mixed"])
def test_dict_counts_match_numpy_route(files, name, flags, cut, negate):
    from duckdb_parquet_parser_tpu.ops.scan import scan_batch

    batch = ParquetReader(files[name]).prescan("s", pad_strings=8,
                                               flags=FLAGS[flags])
    assert ("idx_vals" in batch.arrays) == (flags == "planes")
    if cut:
        assert _cut_dictionaries(batch) > 0
    is_dict = batch.arrays["page_kind"] == 1
    assert is_dict.any()
    for p in PATTERNS:
        want = scan_batch(batch, p, negate=negate, xp=np)
        counts, values = _port_counts(batch, p, negate)
        msg = f"{name} {flags} cut={cut} {p}"
        np.testing.assert_array_equal(counts[is_dict],
                                      want.match_counts[is_dict], err_msg=msg)
        np.testing.assert_array_equal(values[is_dict],
                                      want.value_counts[is_dict], err_msg=msg)
        assert not counts[~is_dict].any() and not values[~is_dict].any(), msg
    if cut:  # some value really fell out of range
        full = ParquetReader(files[name]).prescan("s", pad_strings=8,
                                                  flags=FLAGS[flags])
        assert values.sum() < _port_counts(full, PATTERNS[0], negate)[1].sum()


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("name", ["dict", "required", "mixed"])
def test_dict_counts_match_jax_resident_scan(files, name, negate):
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JR
    from duckdb_parquet_parser_tpu.models.scan import ResidentColumn as JRC

    want = JRC(JR(files[name]), "s").scan(PATTERNS[1], negate=negate)
    for flags in FLAGS.values():
        batch = ParquetReader(files[name]).prescan("s", pad_strings=8,
                                                   flags=flags)
        is_dict = batch.arrays["page_kind"] == 1
        np.testing.assert_array_equal(batch.arrays["page_gid"], want.page_gid)
        counts, values = _port_counts(batch, PATTERNS[1], negate)
        np.testing.assert_array_equal(counts[is_dict],
                                      want.match_counts[is_dict])
        np.testing.assert_array_equal(values[is_dict],
                                      want.value_counts[is_dict])


# (N, V, index plane width, level plane width, DN, K, max_def)
SHAPES = [(60, 64, 64, 64, 300, 1, 1), (60, 64, 64, 64, 300, 3, 1),
          (41, 37, 37, 37, 513, 3, 1), (33, 100, 64, 128, 70, 1, 2),
          (25, 96, 128, 80, 90, 6, 1), (20, 48, 48, 0, 1, 2, 0),
          (9, 1100, 1104, 1104, 50, 5, 1)]


def _random_planes(seed, n, vmax, idx_w, lev_w, dn, k, max_def):
    rng = np.random.default_rng(seed)
    num_values = rng.integers(0, vmax + 1, n).astype(np.int32)
    num_values[:3] = [0, vmax, vmax + 5]  # empty, full, longer than V
    kind = (rng.random(n) > 0.15).astype(np.int32)
    kind[3] = 0
    size = rng.integers(1, 40, n).astype(np.int32)
    base = rng.integers(0, max(dn - 40, 1), n).astype(np.int32)
    idx = rng.integers(-1, 44, (n, idx_w)).astype(np.int32)
    idx[rng.random((n, idx_w)) < 0.02] = 2**31 - 1
    lev = ((rng.random((n, lev_w)) > 0.2) * max(max_def, 1)).astype(np.uint8)
    table = (rng.random((k, dn)) > 0.6).astype(np.uint8)
    return [idx, lev if max_def > 0 else None, num_values, kind, base, size,
            table]


def _loop_counts(idx, lev, num_values, kind, base, size, table, *, vmax,
                 max_def, negate):
    """The definition of `dict_count`, cell by cell."""
    n, (k, dn) = idx.shape[0], table.shape
    counts, values = np.zeros((k, n), np.int32), np.zeros(n, np.int32)
    for r in range(n):
        if kind[r] != 1:
            continue
        for v in range(min(int(num_values[r]), vmax, idx.shape[1])):
            if max_def > 0 and (v >= lev.shape[1] or lev[r, v] != max_def):
                continue
            if not 0 <= idx[r, v] < size[r]:
                continue
            g = min(max(int(base[r]) + int(idx[r, v]), 0), dn - 1)
            values[r] += 1
            counts[:, r] += (table[:, g] != 0) ^ negate
    return counts, values


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_dict_count_plain_matches_definition(shape, negate):
    arrs = _random_planes(5, *shape)
    kw = dict(vmax=shape[1], max_def=shape[6], negate=negate)
    want_c, want_v = _loop_counts(*arrs, **kw)
    tens = [None if a is None else torch.from_numpy(a) for a in arrs]
    for fn in (dict_lookup.dict_count_plain, dict_lookup.dict_count):
        counts, values = fn(*tens, **kw)
        assert counts.dtype == torch.int32 and values.dtype == torch.int32
        np.testing.assert_array_equal(counts.numpy(), want_c)
        np.testing.assert_array_equal(values.numpy(), want_v)


def test_dict_count_checks_its_inputs():
    arrs = _random_planes(1, *SHAPES[0])
    tens = [None if a is None else torch.from_numpy(a) for a in arrs]
    tens[1] = None
    with pytest.raises(ValueError):
        dict_lookup.dict_count(*tens, vmax=64, max_def=1, negate=False)
    meta = [t.to("meta") for t in
            (torch.from_numpy(a) for a in _random_planes(1, *SHAPES[0]))]
    with pytest.raises(ValueError):
        dict_lookup.dict_count(*meta, vmax=64, max_def=1, negate=False)


def test_gather_entry_takes_a_table_or_a_list():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.integers(-9, 9, (3, 50)).astype(np.int32))
    g = torch.from_numpy(rng.integers(0, 50, (7, 5)).astype(np.int32))
    whole = dict_lookup.dict_lookup(table, g)
    assert whole.shape == (3, 7, 5)
    parts = dict_lookup.dict_lookup(list(table), g)
    for a, b, row in zip(whole, parts, table):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), row.numpy()[g.numpy()])


@pytest.mark.cuda
@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(40, 2500, 2500, 2512, 8192, 3, 1)],
                         ids=lambda s: "-".join(map(str, s)))
def test_count_kernel_matches_plain(cuda, shape, negate):
    arrs = _random_planes(5, *shape)
    tens = [None if a is None else torch.from_numpy(a).to(cuda) for a in arrs]
    kw = dict(vmax=shape[1], max_def=shape[6], negate=negate)
    before = dict_lookup.launches
    counts, values = dict_lookup.dict_count(*tens, **kw)
    assert dict_lookup.launches == before + 1
    want_c, want_v = dict_lookup.dict_count_plain(*tens, **kw)
    assert torch.equal(counts, want_c) and torch.equal(values, want_v)


@pytest.mark.cuda
def test_gather_kernel_on_a_table_matches_plain(cuda):
    rng = np.random.default_rng(4)
    table = torch.from_numpy(
        rng.integers(-2**31, 2**31, (3, 6000), dtype=np.int64).astype(np.int32)
    ).to(cuda)
    g = torch.from_numpy(rng.integers(0, 6000, (301, 64)).astype(np.int32)
                         ).to(cuda)
    before = dict_lookup.launches
    got = dict_lookup.dict_lookup(table, g)
    assert dict_lookup.launches == before + 1
    assert torch.equal(got, dict_lookup.dict_lookup_plain(table, g))
