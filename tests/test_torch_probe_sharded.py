"""The port's rank-group runner for the sharded paths
(duckdb_parquet_parser_tpu_torch/utils/probe_sharded.run_group) and the
recorder of the kernels' wrappers (utils/record.py), on the CPU over gloo.

One rank saves its answers; two ranks, rank 1 failed by the elastic paths'
hooks, must give every array again, and a rank that finds other answers
fails the group with its error.  The files are small (a few thousand
rows), the pass the one `chip_smoke.py` and the probe run at full width."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from duckdb_parquet_parser_tpu_torch.ops.kernels import dict_lookup
from duckdb_parquet_parser_tpu_torch.utils import fixtures as fx
from duckdb_parquet_parser_tpu_torch.utils.probe_sharded import run_group
from duckdb_parquet_parser_tpu_torch.utils.record import (
    hold_recorded,
    recorded_calls,
)

GROUP_TIMEOUT_S = 200


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("probe_sharded")
    files = {
        "lineitem": fx.lineitem(tmp / "lineitem.parquet", 3000),
        "city": fx.dict_strings(tmp / "city.parquet", rows_per_rg=1500,
                                n_rg=2, distinct=40),
        "decode": (fx.dict_ints(tmp / "ints.parquet", 3000), "k"),
    }
    work, answers = tmp / "work", tmp / "work" / "answers.npz"
    out = {}
    for n in (1, 2):
        out[n] = run_group(n, "gloo", "cpu", files, work, answers,
                           save=n == 1, fail=n // 2 if n > 1 else None,
                           kernel_patterns=[], timeout=GROUP_TIMEOUT_S)
    return {"files": files, "work": work, "answers": answers, "runs": out}


def test_one_rank_saves_the_answers(groups):
    (report,), _wall = groups["runs"][1]
    assert report["compared"] == 0 and report["device"] == "cpu"
    with np.load(groups["answers"]) as saved:
        assert {"scan/l_comment/totals", "index/city/ragged/entries",
                "decode/k/checksum"} <= set(saved.files)


def test_two_ranks_give_the_one_rank_answers(groups):
    reports, _wall = groups["runs"][2]
    with np.load(groups["answers"]) as saved:
        n_arrays = len(saved.files)
    assert [r["rank"] for r in reports] == [0, 1]
    assert [r["compared"] for r in reports] == [n_arrays, n_arrays]
    # rank 1 failed in round 0 of the elastic scans
    assert any("report {'failed': [1]" in ln for ln in reports[0]["lines"])
    # rank 0 saved the emission decode's dict_lookup inputs
    with np.load(groups["work"] / "report_2.emission.npz") as z:
        assert list(z["gidx"].shape) == reports[0]["emission_gidx"]
        assert z["table"].shape[0] == 1


def test_a_rank_with_other_answers_fails_the_group(groups, tmp_path):
    with np.load(groups["answers"]) as saved:
        wrong = {k: saved[k] for k in saved.files}
    wrong["decode/k/checksum"] = wrong["decode/k/checksum"] + 1
    np.savez(tmp_path / "wrong.npz", **wrong)
    with pytest.raises(AssertionError, match="decode/k/checksum differs"):
        run_group(2, "gloo", "cpu", groups["files"], tmp_path / "work",
                  tmp_path / "wrong.npz", save=False, fail=None,
                  kernel_patterns=[], timeout=GROUP_TIMEOUT_S)


def test_recorded_calls_note_and_restore_the_wrapper():
    real = dict_lookup.dict_lookup
    table = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    gidx = torch.tensor([[0, 5], [3, 1]], dtype=torch.int32)
    with recorded_calls(dict_lookup, "dict_lookup", to_host=True) as calls:
        got = dict_lookup.dict_lookup(table, gidx)
        gidx[0, 0] = 4  # the record is the call's copy, not a view
    assert dict_lookup.dict_lookup is real
    assert torch.equal(got, table[:, torch.tensor([[0, 5], [3, 1]])])
    (args, kwargs), = calls
    assert kwargs == {} and args[1].tolist() == [[0, 5], [3, 1]]
    assert hold_recorded({"dict_lookup.dict_lookup": calls}, "cpu") == {
        "dict_lookup.dict_lookup": {"calls": 1, "max_abs_err": 0}}
