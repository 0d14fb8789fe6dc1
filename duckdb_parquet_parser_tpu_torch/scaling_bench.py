"""Scaling-efficiency harness: the sharded scan step on the group's mesh.

Counterpart of `duckdb_parquet_parser_tpu.scaling_bench`.  Runs the
distributed pipeline's scan step (byte-balanced shards, the local step on
each rank's device, all-reduced totals) on the mesh it was launched with
and emits one JSON line, on rank 0, with rows/s and efficiency — the same
keys as the reference's table.  A process has one device, so a run measures
one mesh size, N, beside its own one-rank baseline (rank 0 walks the whole
batch alone while the others wait); the sweep over sizes is a loop of
launches:

    for n in 1 2 4; do
      torchrun --nproc-per-node $n -m duckdb_parquet_parser_tpu_torch.launch \
          scaling-bench --rows 60000
    done

`efficiency_wall` is rate(N) / (N x rate(1)), the step's time at N being
its slowest rank's; `efficiency_compute` (total work / (N x the heaviest
shard's payload bytes)) and `shard_value_skew` are what the sharding
controls, and are meaningful also where the ranks share cores or one card.

Usage: python -m duckdb_parquet_parser_tpu_torch.scaling_bench [--rows N]
       [--device cuda|cpu] [--backend nccl|gloo]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


def _prescan_fixture(rows: int):
    """The harness's seeded string column (`rows` values of four words),
    written to a temporary file and prescanned for the sharded scan."""
    from .host import bindings
    from .host.reader import ParquetReader
    from .host.schema import ParquetType
    from .host.writer import ColumnSpec, ParquetWriter

    rng = np.random.default_rng(1)
    words = [b"alpha", b"bravo", b"gamma", b"delta", b"kappa", b"sigma"]
    fd, path = tempfile.mkstemp(suffix=".parquet", prefix="dpq_scaling_")
    os.close(fd)
    try:
        w = ParquetWriter(
            path, [ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True)],
            key_value={"pad": "x" * 512},
        )
        done = 0
        while done < rows:
            n = min(20_000, rows - done)
            vals = [b" ".join(words[int(k)] for k in rng.integers(0, 6, 4))
                    for _ in range(n)]
            w.write_row_group({"s": vals})
            done += n
        w.close()
        return ParquetReader(path).prescan(
            "s", pad_strings=8,
            flags=bindings.PS_HOST_STRINGS | bindings.PS_PAYLOAD)
    finally:
        os.unlink(path)


def run(mesh, *, rows: int, pattern: str, reps: int) -> int:
    """The harness on `mesh`; every rank calls it, rank 0 prints.  Every
    rank writes its own copy of the seeded fixture: ranks on different
    hosts share no directory."""
    from .ops import scan as _scan
    from .ops.regex import compile_pattern
    from .parallel.mesh import all_reduce_sum, to_global
    from .parallel.partition import (
        assign_balanced_equal,
        pad_pages,
        reorder_pages,
    )

    on_card = mesh.device.type == "cuda"
    batch = _prescan_fixture(rows)
    dfa = compile_pattern(pattern)
    irs, walk_dfa = _scan.resolve_matchers([pattern], [dfa])

    def measure(n: int, rank: int, sharded: bool) -> dict:
        """The scan step at `n` shards, this process walking shard `rank`
        with its data resident: the least seconds of `reps` steps, the
        rows scanned, this shard's values, the shards' work balance.
        `sharded`: the totals are all-reduced over the mesh."""
        padded = pad_pages(batch, n)
        weights = padded.arrays["page_payload_len"].astype(np.int64) + 16
        weights = np.where(padded.arrays["page_num_values"] > 0, weights, 0)
        order = assign_balanced_equal(weights, n).order
        padded = reorder_pages(padded, order)
        pp = padded.n_pages // n
        shard = padded.slice_pages(rank * pp, (rank + 1) * pp)
        buckets, _split = _scan.resident_buckets(shard, mesh.device)

        def step():
            _counts, values = _scan.scan_buckets(
                shard, buckets, irs, walk_dfa, [dfa], False, mesh.device)
            local = torch.tensor([int(values.sum())], dtype=torch.int64)
            total = all_reduce_sum(mesh, local) if sharded else local.numpy()
            if on_card:
                torch.cuda.synchronize()
            return int(total[0]), int(values.sum())

        step()
        best = float("inf")
        for _ in range(reps):
            if sharded:
                dist.barrier(group=mesh.group)
            t0 = time.time()
            total_rows, shard_values = step()
            best = min(best, time.time() - t0)
        # COMPUTE-based efficiency: what independent devices would deliver
        # given this sharding — a shard's cost follows its payload bytes
        work = weights[order].reshape(n, -1).sum(axis=1).astype(np.float64)
        return {"seconds": best, "rows": total_rows, "values": shard_values,
                "efficiency_compute": float(work.sum()
                                            / max(n * work.max(), 1.0))}

    def row(n, m, seconds, shard_values, base):
        rate = m["rows"] / seconds
        shard_values = np.asarray(shard_values, np.float64)
        return rate, {
            "devices": n,
            "rows_per_s": round(rate, 1),
            "efficiency_wall": round(rate / ((base or rate) * n), 3),
            "efficiency_compute": round(m["efficiency_compute"], 3),
            "shard_value_skew": round(float(
                shard_values.max() / max(shard_values.mean(), 1.0)), 3),
        }

    table = []
    base = None
    if mesh.rank == 0:
        # the one-rank baseline: this rank alone over the whole batch
        m = measure(1, 0, sharded=False)
        base, first = row(1, m, m["seconds"], [m["values"]], None)
        table.append(first)
    if mesh.size > 1:
        dist.barrier(group=mesh.group)
        m = measure(mesh.size, mesh.rank, sharded=True)
        shard_values = to_global(mesh, torch.tensor([m["values"]]))
        slowest = float(to_global(mesh, torch.tensor(
            [m["seconds"]], dtype=torch.float64)).max())
        if mesh.rank == 0:
            table.append(row(mesh.size, m, slowest, shard_values, base)[1])
    if mesh.rank == 0:
        where = (torch.cuda.get_device_name(mesh.device) if on_card
                 else "CPU ranks")
        out = {
            "metric": "scan_scaling",
            "platform": "gpu" if on_card else "cpu",
            "note": (
                f"{mesh.size} rank(s) over {mesh.backend}, {where}: "
                "efficiency_wall holds rate(N) against N x the one-rank "
                "rate measured in this run; where the ranks share cores or "
                "one card it is bounded by them — efficiency_compute (work "
                "balance across shards) and shard_value_skew are the "
                "signals the sharding controls"
            ),
            "table": table,
        }
        print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=60_000)
    ap.add_argument("--pattern", default="alpha.*bravo")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    args = ap.parse_args(argv)

    from .parallel.mesh import (
        closing_group,
        distributed_init_from_env,
        make_mesh,
        rank_device,
    )

    with closing_group():
        distributed_init_from_env(args.backend)
        return run(make_mesh(rank_device(args.device), args.backend),
                   rows=args.rows, pattern=args.pattern, reps=args.reps)


if __name__ == "__main__":
    sys.exit(main())
