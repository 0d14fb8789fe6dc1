"""The multi-device dry run: every sharded path of the package once, on a
mesh of N ranks, one process a rank.

Counterpart of `__graft_entry__.dryrun_multichip`.  `dryrun_multichip(mesh)`
runs the reference's nine sections in its order, through the port's own
functions on `mesh.device`, and returns the reference's line with the rank
count as N:

  1. the sharded scan of the two-row-group example file;
  2. the index build and its entry exchange;
  3. a skewed file (3,000 one-byte values beside 1,500 of 40 bytes): the
     salted ownership must keep the ranks' byte loads under 1.3x their
     mean and the exchange's planned slots under 1.05x the entries
     (ragged) or 1.5x (padded);
  4. `ScanEngine(mesh=...)` on that file;
  5. the elastic scan, rank 0 failed in round 0, equal to the clean scan;
  6. the sharded fixed-width decode and its checksum, against the CPU
     decode;
  7. the sharded scan of a nested LIST<binary> leaf (written with pyarrow,
     skipped with the reference's note where it does not import);
  8. the DELTA_BINARY_PACKED decode, each rank decoding its page shard,
     against the CPU decode (pyarrow as in 7);
  9. the scan and the index build on the sub-meshes of the first 2 and 4
     ranks (where the mesh is larger), the others sitting out.

Every check is computed from global results, so every rank raises the
first failing one, with the reference's exception and message.  The same
fixtures, written from the same seeds, give the same line: at 2 ranks the
reference's; at 4 ranks the reference's own section 3 fails ("ragged
exchange planned 5592 slots for 4500 entries (ratio 1.24)": its salted
ownership leaves the hottest destination that far above the rest), and so
does the port's, whose receive layout is the reference's; at 1 rank
section 5 fails ("all devices failed").

    # N ranks it starts itself, rank i on cuda:i over NCCL
    python -m duckdb_parquet_parser_tpu_torch.dryrun 4
    # CPU ranks, or ranks that share one card
    python -m duckdb_parquet_parser_tpu_torch.dryrun 2 --device cpu --backend gloo
    python -m duckdb_parquet_parser_tpu_torch.dryrun 2 --device cuda --backend gloo
    # a group that torchrun (or DPQ_COORDINATOR) formed: run it once a rank
    torchrun --nproc-per-node 4 -m duckdb_parquet_parser_tpu_torch.dryrun 4

Rank 0 prints the line on stdout; every rank prints its kernel launches on
stderr.  `--record DIR` saves each rank's calls of the kernels' wrappers
(their arguments, on the host) to `DIR/rank<r>.pt`, so that each kernel can
be held against its plain version at the dry run's own shapes
(`utils/record.hold_recorded`).  A failing rank's error ends the run with exit code 1.  Nothing
falls back: without a card `--device cuda` raises, and NCCL with more
ranks than cards raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

RANK_TIMEOUT_S = 900  # a rank process that outlives this is killed
MODULE = "duckdb_parquet_parser_tpu_torch.dryrun"
# the reference's patterns, all three walked by the stream matcher (K1):
SCAN_PATTERN = "word|[aeiou]{2}"  # sections 1, 5 and 9
SKEW_PATTERN = "x+"  # section 4, the skewed file
NESTED_PATTERN = "wor(d|m)"  # section 7, the nested leaf


def _require(ok, *message) -> None:
    """The reference's `assert ok, message`, kept under `python -O`."""
    if not ok:
        raise AssertionError(*message)


def dryrun_multichip(mesh) -> str:
    """The reference's nine sections on `mesh` (every rank calls this);
    returns the reference's line."""
    with tempfile.TemporaryDirectory(prefix="dpq_dryrun_") as tmpdir:
        return _sections(mesh, tmpdir)


def _sections(mesh, tmpdir: str) -> str:
    from .host import bindings
    from .host.reader import ParquetReader, _string_stream
    from .host.schema import ParquetType
    from .host.writer import ColumnSpec, ParquetWriter
    from .models.scan import ScanEngine, build_example_batch
    from .ops.decode import decode_fixed_device
    from .ops.regex import compile_pattern
    from .parallel.elastic import elastic_distributed_scan
    from .parallel.index_build import distributed_index_build
    from .parallel.mesh import run_on_survivors, to_global
    from .parallel.partition import pad_pages
    from .parallel.pipeline import distributed_decode, distributed_scan

    n_devices = mesh.size
    reader, batch = build_example_batch(tmpdir, rows=120)
    padded = pad_pages(batch, n_devices)

    # 1) sharded decode + regex match (all-reduced totals)
    dfa = compile_pattern(SCAN_PATTERN)
    result = distributed_scan(mesh, padded, dfa)
    _require(result.totals.shape == (2,))
    _require((result.match_counts >= 0).all())

    # 2) the index build: sharded emission decode, salted ownership,
    # block-pipelined entry exchange
    res = distributed_index_build(mesh, reader, "s", chunk_size=512)
    pos, _lens, _offs, _chars = _string_stream(batch)
    got = sum(len(r) for r in res.received)
    _require(got == len(pos), (got, len(pos)))

    # 3) a skewed file: one chunk of thousands of tiny values (an
    # entry-count hot key) beside long values; salting must keep the
    # ranks' byte loads and the exchange's capacity flat
    skew_path = os.path.join(tmpdir, "skewed.parquet")
    w = ParquetWriter(
        skew_path, [ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True)],
        key_value={"pad": "x" * 512},
    )
    rng = np.random.default_rng(0)
    vals = [b"x" for _ in range(3000)]
    vals += [bytes(rng.integers(97, 122, 40)) for _ in range(1500)]
    w.write_row_group({"s": vals})
    w.close()
    sres = distributed_index_build(mesh, ParquetReader(skew_path), "s",
                                   chunk_size=512)
    n_entries = sum(len(r) for r in sres.received)
    cap_ratio = sres.exchange_planned_slots / max(n_entries, 1)
    _require(sres.skew_factor < 1.3,
             f"index byte skew {sres.skew_factor:.2f}")
    cap_limit = 1.05 if sres.exchange_mode == "ragged" else 1.5
    _require(cap_ratio <= cap_limit,
             f"{sres.exchange_mode} exchange planned "
             f"{sres.exchange_planned_slots} slots for {n_entries} entries "
             f"(ratio {cap_ratio:.2f})")

    # 4) byte-balanced scan shards of the skewed file
    sr = ScanEngine(skew_path, mesh=mesh).scan("s", SKEW_PATTERN)
    _require(int(sr.totals[0]) > 0)

    # 5) elastic recovery: rank 0 fails in round 0, its pages re-run on the
    # survivors, the merged result equals the clean run
    def _kill_one(result_, rnd):
        return {0} if rnd == 0 else ()

    eres, ereport = elastic_distributed_scan(mesh, padded, dfa,
                                             fault_hook=_kill_one)
    _require(ereport["failed"] == [0] and ereport["reruns"] > 0)
    np.testing.assert_array_equal(eres.match_counts, result.match_counts)
    np.testing.assert_array_equal(eres.totals, result.totals)

    # 6) sharded fixed-width decode, against the CPU decode
    fixed_path = os.path.join(tmpdir, "fixed.parquet")
    fw = ParquetWriter(
        fixed_path, [ColumnSpec("i", ParquetType.INT64, optional=True)],
        key_value={"pad": "x" * 512},
    )
    fw.write_row_group({"i": (rng.integers(0, 1000, 900),
                              (rng.random(900) > 0.2).astype(np.uint8))})
    fw.close()
    ibatch = ParquetReader(fixed_path).prescan("i")
    ipadded = pad_pages(ibatch, n_devices)
    planes, nonnull, checksum = distributed_decode(mesh, ipadded)
    p_cpu, nn_cpu = decode_fixed_device(
        ipadded.arrays, ipadded.plain_planes, ipadded.dict_planes,
        ipadded.bool_bits, max_def=ipadded.max_def, out_len=ipadded.vmax,
        nn_len=ipadded.nn_cap, mode=ipadded.mode, device="cpu")
    p0, nn_np = p_cpu[0].numpy(), nn_cpu.numpy()
    np.testing.assert_array_equal(nonnull, nn_np)
    np.testing.assert_array_equal(planes[0], p0)
    _require(checksum == int(np.where(nn_np, p0, 0).sum()))

    # 7) the scan of a nested LIST<binary> leaf (repetition levels; the
    # payload path is value-oriented, so sharding is unchanged), against
    # the CPU scan
    nested_path = os.path.join(tmpdir, "nested.parquet")
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq

        lists = [
            None if rng.random() < 0.1 else
            [b"word" if rng.random() < 0.3 else b"zz" for _ in
             range(int(rng.integers(0, 4)))]
            for _ in range(300)
        ]
        pq.write_table(
            pa.table({"l": pa.array(lists, type=pa.list_(pa.binary()))}),
            nested_path, compression="NONE", data_page_size=512)
        nres = ScanEngine(nested_path, mesh=mesh).scan("l", NESTED_PATTERN)
        from .ops.scan import scan_batch

        nref = scan_batch(
            ParquetReader(nested_path).prescan("l", pad_strings=8),
            NESTED_PATTERN, device="cpu")
        _require(int(nres.totals[0]) == int(nref.match_counts.sum()))
        nested_note = f"nested scan {int(nres.totals[0])} hits"
    except ImportError:
        nested_note = "nested scan skipped (no pyarrow)"

    # 8) DELTA_BINARY_PACKED decode of page shards (pages are independent
    # streams): each rank decodes its shard of the PS_DELTA_RAW planes on
    # its device, the shards gathered, against the CPU decode
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq

        from .ops.delta import decode_delta_planes

        dl_path = os.path.join(tmpdir, "delta.parquet")
        dvals = [None if rng.random() < 0.1 else int(v)
                 for v in np.cumsum(rng.integers(-3, 9, 6000))]
        pq.write_table(
            pa.table({"x": pa.array(dvals, type=pa.int64())}), dl_path,
            use_dictionary=False,
            column_encoding={"x": "DELTA_BINARY_PACKED"},
            data_page_version="2.0", data_page_size=256)
        dbatch = ParquetReader(dl_path).prescan("x",
                                                flags=bindings.PS_DELTA_RAW)
        dar = {k: np.asarray(v) for k, v in dbatch.arrays.items()
               if k.startswith("delta_")}
        n_real = dar["delta_bw"].shape[0]
        pad_n = (-n_real) % n_devices
        pp = (n_real + pad_n) // n_devices
        lo = mesh.rank * pp
        shard = {}
        for k, v in dar.items():
            v = np.pad(v, [(0, pad_n)] + [(0, 0)] * (v.ndim - 1))
            shard[k] = torch.from_numpy(
                np.ascontiguousarray(v[lo:lo + pp])).to(mesh.device)
        ddims = {k: int(v) for k, v in dbatch.dims.items()
                 if str(k).startswith("delta_")}
        d_sh = [to_global(mesh, p) for p in decode_delta_planes(
            shard, ddims, dbatch.nn_cap, 2)]
        d_cpu = decode_delta_planes(
            {k: torch.from_numpy(v.copy()) for k, v in dar.items()},
            ddims, dbatch.nn_cap, 2)
        np.testing.assert_array_equal(d_sh[0][:n_real], d_cpu[0].numpy())
        np.testing.assert_array_equal(d_sh[1][:n_real], d_cpu[1].numpy())
        delta_note = f"sharded delta decode {n_real} pages"
    except ImportError:
        delta_note = "sharded delta decode skipped (no pyarrow)"

    # 9) small meshes: the scan and the index build on the first 2 and 4
    # ranks (capacity planning at small N cannot hide behind the full
    # mesh); the other ranks sit out and receive the answers
    sub_notes = []
    for n_sub in (2, 4):
        if n_sub >= n_devices:
            continue

        def on_sub(sub, n_sub=n_sub):
            sub_scan = distributed_scan(sub, pad_pages(batch, n_sub), dfa)
            sub_idx = distributed_index_build(sub, reader, "s",
                                              chunk_size=512)
            return sub_scan.totals, sum(len(r) for r in sub_idx.received)

        sub_totals, sub_entries = run_on_survivors(
            mesh, list(range(n_sub)), on_sub)
        np.testing.assert_array_equal(sub_totals, result.totals)
        _require(sub_entries == len(pos))
        sub_notes.append(f"n={n_sub} ok")

    return (
        f"dryrun_multichip({n_devices}): scan totals={result.totals.tolist()} "
        f"exchange={got} entries across {res.index.num_chunks} chunks "
        f"(skew {res.skew_factor:.2f}); skewed fixture: byte skew "
        f"{sres.skew_factor:.2f}, capacity ratio {cap_ratio:.2f}; elastic "
        f"recovery ok (reran {ereport['reruns']} pages); sharded decode "
        f"checksum {checksum}; {nested_note}; {delta_note}; "
        f"sub-meshes: {', '.join(sub_notes) or 'n/a'} — OK"
    )


# ── the rank processes ───────────────────────────────────────────────────────


def _cards(device: str) -> int:
    return torch.cuda.device_count() if device == "cuda" else 0


def run_rank(mesh, record: str | None = None) -> int:
    """The dry run on this rank's `mesh`: rank 0 prints the line on
    stdout, every rank its launches and seconds on stderr (one write a
    line, so that ranks sharing a stream do not interleave).  On a card the
    kernels of the dry run's patterns build first, in one `nvcc` run.
    With `record`, the arguments of every call of the kernels' wrappers
    are kept, copied to the host, and saved to `record/rank<r>.pt`."""
    from .bench import build_kernels, launches_of
    from .utils.record import KERNEL_WRAPPERS, recorded_calls

    t0 = time.perf_counter()
    if mesh.device.type == "cuda":
        build_kernels([(p,) for p in (SCAN_PATTERN, SKEW_PATTERN,
                                      NESTED_PATTERN)])
    with contextlib.ExitStack() as stack:
        calls = {}
        if record:
            calls = {name: stack.enter_context(recorded_calls(
                module, attr, to_host=True))
                for name, (module, attr) in KERNEL_WRAPPERS.items()}
        line, launches = launches_of(lambda: dryrun_multichip(mesh))
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    if record:
        os.makedirs(record, exist_ok=True)
        torch.save(calls, os.path.join(record, f"rank{mesh.rank}.pt"))
    sys.stderr.write(
        f"[dryrun] rank {mesh.rank} of {mesh.size} on {mesh.device} over "
        f"{mesh.backend}: launches {json.dumps(launches)}, "
        f"{time.perf_counter() - t0:.1f} s\n")
    sys.stderr.flush()
    if mesh.rank == 0:
        sys.stdout.write(line + "\n")
        sys.stdout.flush()
    return 0


def _child(args) -> int:
    """One rank of a group that `spawn` started, meeting the others at the
    file store `args.store`."""
    from .parallel.mesh import closing_group, join_file_group

    with closing_group():
        return run_rank(join_file_group(args.store, args.rank, args.n,
                                        args.device, args.backend),
                        args.record)


def _joined(args) -> int:
    """This process as one rank of a group that torchrun or
    DPQ_COORDINATOR formed."""
    from .parallel.mesh import (
        check_layout,
        closing_group,
        distributed_init_from_env,
        make_mesh,
        rank_device,
    )

    env = os.environ
    size = int(env["DPQ_NUM_PROCESSES"] if env.get("DPQ_COORDINATOR")
               else env["WORLD_SIZE"])
    if size != args.n:
        raise ValueError(f"the group has {size} ranks, not {args.n}")
    check_layout(int(env.get("LOCAL_WORLD_SIZE", "1")), args.device,
                 args.backend, _cards(args.device))
    with closing_group():
        distributed_init_from_env(args.backend)
        return run_rank(make_mesh(rank_device(args.device), args.backend),
                        args.record)


def spawn(n: int, device: str, backend: str,
          record: str | None = None) -> int:
    """Starts `n` rank processes of this module over a file store and
    relays them: rank 0's line to stdout, every rank's stderr to stderr.
    Returns 0, or 1 when a rank failed, its error printed last."""
    from .parallel.mesh import check_layout, run_processes

    check_layout(n, device, backend, _cards(device))

    with tempfile.TemporaryDirectory(prefix="dpq_dryrun_group_") as tmp:
        store = os.path.join(tmp, "store")
        ends = run_processes(
            [[sys.executable, "-m", MODULE, str(n), "--device", device,
              "--backend", backend, "--rank", str(r), "--store", store]
             + (["--record", record] if record else [])
             for r in range(n)], RANK_TIMEOUT_S)
    failed = [r for r, e in enumerate(ends) if e.returncode != 0]
    # the first rank that failed by itself (not killed after another did)
    first = next((r for r in failed if ends[r].returncode > 0),
                 failed[0] if failed else None)
    for r, e in enumerate(ends):
        if r != first:
            sys.stderr.write(e.err)
    if first is not None:
        sys.stderr.write(f"[dryrun] rank {first} of {n} exited with "
                         f"{ends[first].returncode}:\n{ends[first].err}")
        sys.stderr.flush()
        return 1
    # gloo may print a banner first: the line is rank 0's last
    out = ends[0].out.strip().splitlines()
    sys.stderr.write("".join(ln + "\n" for ln in out[:-1]))
    print(out[-1] if out else "", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=f"python -m {MODULE}", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, help="ranks (the reference's devices)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    ap.add_argument("--record", metavar="DIR",
                    help="save each rank's calls of the kernels' wrappers "
                         "(their arguments, on the host) to DIR/rank<r>.pt")
    # how `spawn` starts its ranks
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _child(args)
    env = os.environ
    if env.get("DPQ_COORDINATOR") or all(
            env.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                 "MASTER_PORT")):
        return _joined(args)
    return spawn(args.n, args.device, args.backend, args.record)


if __name__ == "__main__":
    sys.exit(main())
