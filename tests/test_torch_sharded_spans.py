"""The sharded scan's spans and counter (`ScanEngine(path, mesh).scan`) on
2 and 4 gloo ranks on the CPU, each rank a child process of
tests/torch_spans_worker.py: the page plan `dpq.shard_plan` ⊃
`dpq.shard_plan.assign`, `dpq.shard_plan.reorder` inside `dpq.query`; one
`dpq.exchange` a collective, after `dpq.step`; `exchange_bytes` the bytes
handed to `all_reduce_sum` and `to_global`; nothing opened or counted with
no profiler; and every rank's answer the plain reference's (LIKE in NumPy
over the values the benchmark's data maker wrote, `portbench/reference.py`).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import pytest

from duckdb_parquet_parser_tpu_torch.parallel.mesh import run_processes
from portbench import datagen, reference
from portbench import run as bench_run

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 150
LIKE = "%special%requests%"
RANKS = (2, 4)
# the harness's orders table at a test's size: 6,000 rows in 8 KB pages
TABLE = dict(rows=6000, row_group_rows=1024)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    cfg = bench_run.load_json(ROOT / "portbench" / "configs"
                              / "tpch_sf10_orders.json")
    cfg = dict(cfg, name="spans", **TABLE)
    cfg["values"] = dict(cfg["values"], pool_words=8192)
    path = tmp_path_factory.mktemp("sharded_spans") / "orders.parquet"
    return cfg, datagen.make(cfg, 2**31 + 19, path)


@pytest.fixture(scope="module")
def want(table):
    """The plain reference's (page ids, match counts, value counts)."""
    _cfg, t = table
    return reference.page_answer(t, reference.row_matches(t, LIKE), True)


@pytest.fixture(scope="module", params=RANKS, ids=lambda n: f"{n}ranks")
def ranks(request, table, tmp_path_factory) -> list[dict]:
    """What each of `n` child ranks wrote, in rank order."""
    n = request.param
    cfg, t = table
    tmp = tmp_path_factory.mktemp(f"spans{n}")
    job = tmp / "job.json"
    job.write_text(json.dumps({"path": str(t.path), "column": cfg["column"],
                               "like": LIKE, "out": str(tmp / "out")}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    ends = run_processes(
        [[sys.executable, str(ROOT / "tests" / "torch_spans_worker.py"),
          str(rank), str(n), str(tmp / "store"), str(job)]
         for rank in range(n)], CHILD_TIMEOUT_S, cwd=str(tmp), env=env)
    for rank, end in enumerate(ends):
        assert end.returncode == 0, (f"rank {rank} of {n} failed:\n"
                                     f"{end.err[-4000:]}")
    return [json.loads((tmp / f"out.{rank}").read_text()) for rank in range(n)]


def _named(spans, name) -> list[tuple[float, float]]:
    return [(a, b) for n, a, b in spans if n == name]


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_shard_plan_spans_nest_inside_the_query(ranks):
    for out in ranks:
        spans = out["spans"]
        [query] = _named(spans, "dpq.query")
        [plan] = _named(spans, "dpq.shard_plan")
        [assign] = _named(spans, "dpq.shard_plan.assign")
        [reorder] = _named(spans, "dpq.shard_plan.reorder")
        [prescan] = _named(spans, "dpq.prescan")
        [step] = _named(spans, "dpq.step")
        assert _inside(plan, query)
        assert _inside(assign, plan) and _inside(reorder, plan)
        assert assign[1] <= reorder[0]
        # after the prescan it plans, before the shard's walk
        assert prescan[1] <= plan[0] and plan[1] <= step[0]


def test_exchange_opens_once_a_collective_after_the_step(ranks):
    for out in ranks:
        spans = out["spans"]
        [query] = _named(spans, "dpq.query")
        [step] = _named(spans, "dpq.step")
        exchanges = _named(spans, "dpq.exchange")
        # the all-reduce of the totals, the all-gathers of the two counts
        assert len(exchanges) == len(out["handed"]) == 3
        assert all(_inside(x, query) and step[1] <= x[0] for x in exchanges)


def test_exchange_bytes_are_what_the_collectives_are_handed(ranks):
    n_pages = len(ranks[0]["gid"])
    for out in ranks:
        assert out["counts"]["exchange_bytes"] == sum(out["handed"])
        # the totals' two int64, and two int64 counts a page of the shard
        per_rank = -(-n_pages // len(ranks))
        assert sum(out["handed"]) >= 16 + 2 * 8 * per_rank


def test_no_profiler_opens_no_span_and_counts_nothing(ranks):
    for out in ranks:
        assert out["opened"] == []
        assert out["counters_moved"] is False


def test_every_rank_answers_as_the_plain_reference(ranks, want):
    gid, counts, values = (w.tolist() for w in want)
    totals = [sum(counts), sum(values)]
    for out in ranks:
        assert out["gid"] == gid
        assert out["match"] == counts
        assert out["values"] == values
        assert out["totals"] == totals
    assert 0 < totals[0] < totals[1]
