"""Definition levels and dictionary indices (duckdb_parquet_parser_tpu_torch/
ops/decode.py, ops/expand.py) against the reference's jnp functions on the
CPU.  Covers nulls, several row groups, dictionary and PLAIN pages, and
PS_RUNS_ONLY batches, which take the run-expansion branch.  Tolerance 0:
masks and integer planes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from duckdb_parquet_parser_tpu.host import bindings
from duckdb_parquet_parser_tpu.host.schema import ParquetType
from duckdb_parquet_parser_tpu.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser_tpu_torch.host.reader import ParquetReader
from duckdb_parquet_parser_tpu_torch.ops import decode as td
from duckdb_parquet_parser_tpu_torch.ops import expand as te
from tests import fixtures

FLAGS = {"planes": bindings.PS_PAYLOAD,
         "runs_only": bindings.PS_PAYLOAD | bindings.PS_RUNS_ONLY}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode")
    rng = np.random.default_rng(41)
    out = {
        "plain": fixtures.strings_file(str(d / "p.parquet"), rng, n=900,
                                       null_p=0.2, rgs=2),
        "dict": fixtures.strings_file(str(d / "d.parquet"), rng, n=900,
                                      n_unique=9, null_p=0.3, rgs=3),
        "kitchen": fixtures.mixed_file(str(d / "k.parquet"), rng),
    }
    # long null runs and a required column
    path = str(d / "runs.parquet")
    w = ParquetWriter(path, [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                        optional=True)])
    vals = [None if (i // 37) % 3 == 0 else f"v{i % 5}".encode()
            for i in range(2000)]
    w.write_row_group({"s": vals})
    w.close()
    out["runs"] = path
    return out


# the kitchen file: a required column, a dict string column with nulls, a
# required dict-encoded int column
COLUMNS = {"kitchen": ["i64", "city", "code"]}


def _columns(files, name):
    return ParquetReader(files[name]), COLUMNS.get(name, ["s"])


def _jax_decode(batch):
    import jax.numpy as jnp

    from duckdb_parquet_parser_tpu.ops import decode as jd

    core = {k: jnp.asarray(v) for k, v in batch.arrays.items()
            if k in jd.DECODE_ARRAYS}
    nonnull, nn_idx = jd.decode_levels(jnp, core, batch.max_def, batch.vmax)
    dict_idx, ok = jd.decode_dict_indices(jnp, core, nn_idx, batch.nn_cap,
                                          nonnull=nonnull)
    return [np.asarray(x) for x in (nonnull, nn_idx, dict_idx, ok)]


def _port_decode(batch):
    core = batch.to_device("cpu", td.DECODE_ARRAYS)
    nonnull, nn_idx = td.decode_levels(core, batch.max_def, batch.vmax)
    dict_idx, ok = td.decode_dict_indices(core, nn_idx, batch.nn_cap,
                                          nonnull=nonnull)
    return [x.numpy() for x in (nonnull, nn_idx, dict_idx, ok)]


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("name", ["plain", "dict", "kitchen", "runs"])
def test_levels_and_dict_indices_match_jnp(files, name, flags):
    r, cols = _columns(files, name)
    for col in cols:
        batch = r.prescan(col, flags=FLAGS[flags])
        if flags == "runs_only":
            assert "def_levels" not in batch.arrays
        want = _jax_decode(batch)
        got = _port_decode(batch)
        for label, a, b in zip(("nonnull", "nn_idx", "dict_idx", "ok"),
                               got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{col} {label}")


@pytest.mark.parametrize("prefix", ["def", "idx"])
def test_expand_hybrid_matches_numpy(files, prefix):
    from duckdb_parquet_parser_tpu.ops.expand import expand_hybrid

    r, _cols = _columns(files, "dict")
    batch = r.prescan("s", flags=FLAGS["runs_only"])
    a = batch.arrays
    names = [f"{prefix}_run_{k}" for k in
             ("kind", "count", "value", "bitoff", "vstart")]
    out_len = batch.vmax if prefix == "def" else batch.nn_cap
    args = [a[k] for k in names] + [a[f"{prefix}_bytes"],
                                    a[f"page_{prefix}_bw"]]
    want = expand_hybrid(np, *args, out_len, method="gather")
    got = te.expand_hybrid(*[torch.from_numpy(np.array(x)) for x in args],
                           out_len)
    np.testing.assert_array_equal(got.numpy(), want)


def test_nonnull_rank_dtype_stays_int32():
    levels = torch.tensor([[1, 0, 1, 1], [0, 0, 1, 0]], dtype=torch.int32)
    nonnull, nn_idx = te.nonnull_mask_and_index(
        levels, torch.tensor([4, 3], dtype=torch.int32), 1, 4)
    assert nn_idx.dtype == torch.int32
    np.testing.assert_array_equal(nonnull.numpy(),
                                  [[1, 0, 1, 1], [0, 0, 1, 0]])
    np.testing.assert_array_equal(nn_idx.numpy(), [[0, 0, 1, 2],
                                                   [0, 0, 0, 0]])


def test_batch_slice_and_to_device(files):
    r, _cols = _columns(files, "dict")
    batch = r.prescan("s")
    part = batch.slice_pages(1, 3)
    assert part.n_pages == 2 and part.vmax == batch.vmax
    np.testing.assert_array_equal(part.arrays["page_gid"],
                                  batch.arrays["page_gid"][1:3])
    np.testing.assert_array_equal(part.arrays["dict_lens"],
                                  batch.arrays["dict_lens"])
    rows = np.array([2, 0])
    t = batch.to_device("cpu", ["page_nn", "dict_lens"], rows=rows)
    np.testing.assert_array_equal(t["page_nn"].numpy(),
                                  batch.arrays["page_nn"][rows])
    np.testing.assert_array_equal(t["dict_lens"].numpy(),
                                  batch.arrays["dict_lens"])
