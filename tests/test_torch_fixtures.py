"""The port's seeded fixtures (duckdb_parquet_parser_tpu_torch/utils/
fixtures.py): the lineitem file is byte-identical to the reference
benchmark's `bench.gen_fixture`, and the dictionary file has the
concatenated dictionary its parameters promise."""

from __future__ import annotations

import numpy as np

import bench
from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from duckdb_parquet_parser_tpu_torch.utils import fixtures


def test_lineitem_matches_bench(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "CACHE", tmp_path / "bench")
    want = bench.gen_fixture(3000)
    got = fixtures.lineitem(tmp_path / "port.parquet", 3000)
    assert got.read_bytes() == want.read_bytes()


def test_dict_strings_dictionary(tmp_path):
    path = fixtures.dict_strings(tmp_path / "d.parquet", rows_per_rg=2000,
                                 n_rg=3, distinct=200)
    eng = ScanEngine(str(path))
    col = eng.resident("city", device="cpu")
    assert int(col._batch.dims["dict_n"]) == 600
    assert np.all(np.asarray(col._batch.arrays["page_kind"]) == 1)
    res = col.scan("new (york|orleans)-2")
    ref = eng.cold_scan("city", "new (york|orleans)-2", exact_counts=True,
                        stats_prune=False)
    np.testing.assert_array_equal(res.match_counts, ref.match_counts)
    np.testing.assert_array_equal(res.value_counts, ref.value_counts)
    assert 0 < int(res.value_counts.sum()) < 6000  # 2% null
