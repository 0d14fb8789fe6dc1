"""Rank 0 of a run of the route `sharded_scan` with two gloo ranks on the
CPU, on the orders table at a test's size and with two queries in its pool,
a fault of the timed path planted where one is named; prints the result
line as the harness does.

    python -m portbench.tests.sharded_run <fault|none> [trace]

Rank 0's faults are planted here, in the route it runs and in the
program's collectives; the child rank's are planted by a `sitecustomize`
on its PYTHONPATH that calls `plant_child(<fault>)` in a process started
with `--rank` (the test writes it), so that the child breaks where its own
shard is made, or holds a module that no run may load.
"""

from __future__ import annotations

import json
import os
import sys
import time
import types

import numpy as np

# the window's first query is not the one set-up ends with (the pool's
# first), so that a stale answer shows however few scans the window holds
SEED = 2**31 + 4
WINDOW_S = 2.5


def _local(mesh, x):
    """`to_global` without the exchange: this rank's shard in its place,
    zeros where the other ranks' shards belong."""
    import torch

    t = torch.as_tensor(x).cpu().numpy()
    out = np.zeros((mesh.size,) + t.shape, t.dtype)
    out[mesh.rank] = t
    return out.reshape((-1,) + t.shape[1:])


def leave_out_the_exchange() -> None:
    from duckdb_parquet_parser_tpu_torch.parallel import pipeline
    pipeline.to_global = _local


def plant_child(fault: str) -> None:
    """The child rank's side of `fault`."""
    from duckdb_parquet_parser_tpu_torch.ops import scan

    if fault == "exchange left out":
        leave_out_the_exchange()
        return
    if fault == "a child loads jax":
        sys.modules["jax"] = types.ModuleType("jax")
        return
    step = scan.scan_buckets
    calls = []

    def altered(*a, **kw):
        counts, values = step(*a, **kw)
        counts = counts.copy()
        counts[0, 0] += 1
        return counts, values

    def raising(*a, **kw):
        calls.append(1)
        # set-up makes three scans (two queries, then one on the whole
        # file); the fourth is the window's first
        if len(calls) > 3:
            raise RuntimeError("a planted fault of the child rank")
        return step(*a, **kw)

    scan.scan_buckets = {"a count altered in rank 1's shard": altered,
                         "a child raises": raising}[fault]


_LAST: dict = {}


def _stale(ans):
    out = _LAST.get("ans", ans)
    _LAST["ans"] = ans
    return out


def _half(ans):
    counts = np.asarray(ans.match_counts).copy()
    counts[counts.size // 2:] = 0
    ans.match_counts = counts
    return ans


def _gid_dropped(ans):
    for name in ("page_gid", "match_counts", "value_counts"):
        setattr(ans, name, np.delete(np.asarray(getattr(ans, name)), 0))
    return ans


def _pad_kept(ans):
    gid = np.asarray(ans.page_gid).copy()
    gid[np.flatnonzero(gid < 0)[0]] = gid.max() + 1
    ans.page_gid = gid
    return ans


def _totals(ans):
    ans.totals = np.asarray(ans.totals) + np.array([1, 0])
    return ans


RANK0 = {"a stale answer": _stale, "half the pages left out": _half,
         "a page id dropped": _gid_dropped, "a pad page kept": _pad_kept,
         "totals off by one": _totals}
CHILD = {"exchange left out", "a count altered in rank 1's shard",
         "a child raises", "a child loads jax"}
ENDS_THE_RUN = {"a child raises", "a child loads jax"}
FAULTS = sorted(RANK0) + sorted(CHILD)


def tiny_sharded():
    """(cell, configuration, traffic) of a sharded cell at a test's size:
    the orders table, the Q13 mix through the route `sharded_scan` on two
    ranks, its pool cut to two queries (the CPU walks a scan in about two
    seconds)."""
    from portbench.tests.conftest import tiny_cell

    cell, cfg, mix = tiny_cell("orders_q13_resident")
    t = dict(mix["templates"][0])
    t["params"] = {"WORD1": ["special"], "WORD2": ["packages", "requests"]}
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    return (dict(cell, name=f"orders_q13_sharded.test.{worker}", chips=2), cfg,
            dict(mix, route="sharded_scan", templates=[t]))


def metrics(trace: bool) -> list[dict]:
    """The benchmark's metrics that a sharded scan reports: its rate, peak
    and set-up, or with `trace` the spans and counter of its host layers."""
    from portbench import run

    spec = run.spec()
    names = TRACED if trace else UNTRACED
    return [m for m in spec["end_to_end"] + spec["per_layer"]
            if m["name"] in names]


# the rate is read by the cold cell's reader, over rank 0's window
UNTRACED = {"scan_rows_per_s.cold", "device_peak_gb", "setup_s"}
TRACED = {"prescan_span_ms", "split_plan_ms", "upload_span_ms",
          "h2d_gb_per_scan"}


def main(argv=None) -> int:
    fault, *rest = argv or sys.argv[1:]
    trace = rest == ["trace"]
    from portbench import routes, run

    if fault == "exchange left out":
        leave_out_the_exchange()
    if fault in RANK0:
        find = routes.find

        def faulty(name):
            cls = find(name)

            class Faulty(cls):
                def op(self, q):
                    return RANK0[fault](super().op(q))
            return Faulty
        routes.find = faulty
    cell, cfg, mix = tiny_sharded()
    out = run.run_cell(cell, cfg, mix, seed=SEED, seconds=WINDOW_S, trace=trace,
                       device="cpu", t_start=time.perf_counter(),
                       metrics=metrics(trace))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
