"""Multi-process launch entrypoint: one command that forms the process
group, builds the mesh over its ranks, and runs the distributed scan /
index build / scaling bench.

Counterpart of `duckdb_parquet_parser_tpu.launch`.  One process per device:
run THE SAME command once per rank.

    # several cards of one host: torchrun sets RANK / WORLD_SIZE /
    # MASTER_ADDR / MASTER_PORT / LOCAL_RANK; rank i takes cuda:i over NCCL
    torchrun --nproc-per-node 4 -m duckdb_parquet_parser_tpu_torch.launch \
        scan data.parquet comment 'a.*b'

    # explicit rendezvous (any backend; CPU ranks over gloo here)
    DPQ_COORDINATOR=127.0.0.1:8476 DPQ_NUM_PROCESSES=2 DPQ_PROCESS_ID=<i> \
        python -m duckdb_parquet_parser_tpu_torch.launch index data.parquet \
        comment --device cpu --backend gloo

    # one process, one card: a group of one rank, the same collectives
    python -m duckdb_parquet_parser_tpu_torch.launch scan data.parquet \
        comment 'a.*b'

`--device` (default `cuda`: the rank's card, `cuda:<LOCAL_RANK>` under
torchrun; without a card the run raises unless `--device cpu` was given)
and `--backend` (default `nccl`, one card per rank; `gloo` for CPU ranks
or ranks that share a card) are explicit; nothing falls from one to the
other.  Every process must see the parquet file at the same path.  Results
print as one JSON line on rank 0 only; the exit code is shared.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="this rank's torch device (default: its card)")
    common.add_argument("--backend", choices=["nccl", "gloo"],
                        default="nccl")
    ap = argparse.ArgumentParser(
        prog="python -m duckdb_parquet_parser_tpu_torch.launch",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_scan = sub.add_parser("scan", parents=[common],
                            help="distributed regex page scan")
    p_scan.add_argument("file")
    p_scan.add_argument("column")
    p_scan.add_argument("pattern")
    p_scan.add_argument("--negate", action="store_true")

    p_idx = sub.add_parser("index", parents=[common],
                           help="distributed chunked-index build")
    p_idx.add_argument("file")
    p_idx.add_argument("column")
    p_idx.add_argument("--chunk-size", type=int, default=4096)

    p_sb = sub.add_parser("scaling-bench", parents=[common],
                          help="scaling harness over the group's mesh")
    p_sb.add_argument("--rows", type=int, default=60_000)
    p_sb.add_argument("--pattern", default="alpha.*bravo")
    p_sb.add_argument("--reps", type=int, default=5)

    args = ap.parse_args(argv)

    from .parallel.mesh import closing_group, distributed_init_from_env

    with closing_group():
        return _run(args, distributed_init_from_env(args.backend))


def _run(args, formed: bool) -> int:
    """The command `args.cmd` on the mesh of the group that was `formed`
    (else of one rank); prints on rank 0."""
    from .parallel.mesh import make_mesh, rank_device

    mesh = make_mesh(rank_device(args.device), args.backend)
    n_proc = mesh.size
    pid = mesh.rank
    if pid == 0:
        print(
            f"[launch] processes={n_proc} (group={'yes' if formed else 'no'})"
            f" device={mesh.device} backend={mesh.backend}",
            file=sys.stderr,
        )

    if args.cmd == "scaling-bench":
        from . import scaling_bench

        return scaling_bench.run(mesh, rows=args.rows, pattern=args.pattern,
                                 reps=args.reps)

    from .models.scan import ScanEngine

    if args.cmd == "scan":
        eng = ScanEngine(args.file, mesh=mesh)
        res = eng.scan(args.column, args.pattern, negate=args.negate)
        if pid == 0:
            out = {
                "cmd": "scan",
                "devices": mesh.size,
                "processes": n_proc,
                "pages": int(len(res.page_gid)),
                "surviving_pages": int(len(res.surviving_pages())),
                "total_matches": int(res.totals[0]),
                "total_values": int(res.totals[1]),
            }
            print(json.dumps(out))
        return 0

    if args.cmd == "index":
        from .host.reader import ParquetReader
        from .parallel.index_build import distributed_index_build

        reader = ParquetReader(args.file)
        res = distributed_index_build(mesh, reader, args.column,
                                      chunk_size=args.chunk_size)
        if pid == 0:
            n_entries = sum(len(r) for r in res.received)
            out = {
                "cmd": "index",
                "devices": mesh.size,
                "processes": n_proc,
                "tuples": n_entries,
                "chunks": int(len(res.index.chunk_starts)),
                "skew": round(res.skew_factor, 3),
                "exchange_mode": res.exchange_mode,
                "capacity_ratio": round(
                    res.exchange_planned_slots / max(n_entries, 1), 3),
            }
            print(json.dumps(out))
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
