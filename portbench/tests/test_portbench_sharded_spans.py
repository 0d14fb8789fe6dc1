"""The four-card cell `orders_q13_sharded4`, its sharded Q13 mix and the
readers of the sharded scan's spans and counter: the cell's files load; a
traced run of the route `sharded_scan` on two gloo ranks
(tests/sharded_run.py) reads every reader; an untraced run, and a program
without the spans, read none."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import routes, run, traffic
from portbench.trace import Trace
from portbench.tests.sharded_run import tiny_sharded

ROOT = Path(__file__).resolve().parents[2]
CELL = "orders_q13_sharded4"
MIX = "q13_notlike_sharded"
NEW = ["shard_plan_ms", "shard_assign_ms", "shard_reorder_ms", "exchange_ms",
       "exchange_mb_per_scan", "shard_self_ms"]
# the spans that shard_self_ms takes from dpq.query
INNER = ["dpq.compile", "dpq.prescan", "dpq.shard_plan", "dpq.split_plan",
         "dpq.upload", "dpq.step", "dpq.exchange"]


def _sharded_run(names, *extra):
    """The result line of tests/sharded_run.py's sound two-rank run, with
    the metrics `names` read (traced with `extra` ["trace"])."""
    code = ("import sys\n"
            "from portbench import run\n"
            "from portbench.tests import sharded_run\n"
            "sharded_run.metrics = lambda trace: [\n"
            "    {'name': n, 'unit': run.metric_reader(n).UNIT}\n"
            f"    for n in {names!r}]\n"
            f"sys.exit(sharded_run.main(['none', *{list(extra)!r}]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def test_the_four_card_cell_loads_and_is_within_the_quota():
    bench = run.spec()
    cell, cfg, mix = run.cell_parts(bench, CELL)
    assert (cell["traffic"], cell["chips"]) == (MIX, 4)
    assert (routes.HERE / f"{mix['route']}.py").is_file()
    assert cfg["layout"]["cards"] == cell["chips"]
    # the table is the resident cell's, SF10 whole: only the layout differs
    resident = run.cell_parts(bench, "orders_q13_resident")[1]
    same = ("rows", "row_group_rows", "page_bytes", "encoding", "values",
            "column", "guarantees", "reduced")
    assert {k: cfg[k] for k in same} == {k: resident[k] for k in same}
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    names = {m["name"] for m in run.cell_metrics(bench, cell, True)}
    assert names == set(NEW)
    assert {m["name"] for m in run.cell_metrics(bench, cell, False)} \
        == {"device_peak_gb", "setup_s"}


def test_the_sharded_mix_is_the_q13_mix_on_the_sharded_route():
    mix = run.load_json(run.HERE / "traffic" / f"{MIX}.json")
    assert routes.find(mix["route"]).__module__ == "portbench_route_sharded_scan"
    # the resident cell's Q13 template, 16 combinations, one client
    resident = run.cell_parts(run.spec(), "orders_q13_resident")[2]
    assert mix["templates"] == resident["templates"]
    assert (mix["loop"], mix["clients"]) == ("closed", 1)
    assert len(traffic.pool(mix)) == 16


def test_the_readers_name_their_layer_and_the_metric_they_move():
    layers = {name: run.metric_reader(name).LAYER for name in NEW}
    assert layers == {"shard_plan_ms": "sharded scan",
                      "shard_assign_ms": "sharded scan",
                      "shard_reorder_ms": "sharded scan",
                      "exchange_ms": "collectives",
                      "exchange_mb_per_scan": "collectives",
                      "shard_self_ms": "sharded scan"}
    assert {run.metric_reader(name).MOVES for name in NEW} == {"device_peak_gb"}


def test_a_traced_sharded_run_reads_every_new_reader():
    cell = tiny_sharded()[0]
    try:
        out = _sharded_run(NEW, "trace")
    finally:
        # the CPU's profiles of the two ranks, ~0.2 GB each, are not kept
        for path in (run.CACHE / "trace").glob(f"{cell['name']}*.json"):
            path.unlink()
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == set(NEW)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert all(v > 0 for v in got.values()), got
    assert got["shard_assign_ms"] + got["shard_reorder_ms"] \
        <= got["shard_plan_ms"]
    # the totals' two int64 and two int64 counts a page of rank 0's shard
    assert got["exchange_mb_per_scan"] > 16e-6


def test_an_untraced_sharded_run_reads_none_of_them():
    out = _sharded_run(NEW)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"] == {}


def _window(spans, ops=2):
    win = run.Window()
    win.attempted = ops
    win.trace = Trace(host=[(name, 0.0, dur) for name, dur in spans])
    return win


def test_the_readers_sum_the_spans_and_the_counter(monkeypatch):
    from duckdb_parquet_parser_tpu_torch.utils import tracing

    spans = [("query", 9000.0), ("dpq.query", 8000.0),
             ("dpq.shard_plan", 3000.0), ("dpq.shard_plan.assign", 1000.0),
             ("dpq.shard_plan.reorder", 1500.0), ("dpq.exchange", 200.0),
             ("dpq.exchange", 100.0), ("dpq.prescan", 2000.0),
             ("dpq.compile", 10.0), ("dpq.split_plan", 300.0),
             ("dpq.upload", 400.0), ("dpq.step", 90.0)]
    monkeypatch.setattr(tracing, "_counts", {"exchange_bytes": 3_000_000})
    read = {name: run.metric_reader(name).read(_window(spans)) for name in NEW}
    assert read == pytest.approx({
        "shard_plan_ms": 1.5, "shard_assign_ms": 0.5, "shard_reorder_ms": 0.75,
        "exchange_ms": 0.15, "exchange_mb_per_scan": 1.5,
        "shard_self_ms": (8000.0 - 6100.0) / 2e3}, rel=1e-12)


@pytest.mark.parametrize("counters", ["without exchange_bytes", "none"])
def test_a_program_without_the_spans_reads_none(monkeypatch, counters):
    """The parent's program: its spans (dpq.query and the cold route's), no
    dpq.shard_plan nor dpq.exchange, and no exchange_bytes counter (or, as
    an older one, no counters at all)."""
    from duckdb_parquet_parser_tpu_torch.utils import tracing

    if counters == "none":
        monkeypatch.delattr(tracing, "counters")
    else:
        monkeypatch.setattr(tracing, "_counts", {"h2d_bytes": 10})
    win = _window([("query", 9000.0), ("dpq.query", 8000.0)]
                  + [(name, 100.0) for name in INNER
                     if name not in ("dpq.shard_plan", "dpq.exchange")])
    for name in NEW:
        assert run.metric_reader(name).read(win) is None, name


def test_untraced_windows_read_none(monkeypatch):
    from duckdb_parquet_parser_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "_counts", {})
    win = run.Window()
    win.attempted = 3
    for name in NEW:
        assert run.metric_reader(name).read(win) is None, name
