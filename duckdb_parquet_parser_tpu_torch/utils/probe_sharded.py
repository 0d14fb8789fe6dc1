"""The sharded paths at full width, one process a card: the scan, the
elastic scans, both exchange modes of the index build and the sharded
decode, each rank's answers held array by array against one rank's.

`sharded_answers(mesh, files, fail)` is the pass, and `run_group` starts
it as a group of rank processes, each held against saved answers
(`chip_smoke.py` runs both: the pass at one NCCL rank in its own process,
then `run_group` at four gloo ranks that share its card).  Run as a
script, it makes the fixtures (a `lineitem` of `--rows` rows, whose
`l_comment` is the benchmark's, the 400,000-row dictionary `city` file and
a `dict_ints` file of `--rows` rows), builds the kernels, and runs the pass
as a group of N rank processes for each N of `--ranks`, one after another,
rank i on `cuda:i` over NCCL (`--backend gloo` for CPU ranks or ranks that
share a card): first one rank, whose answers the larger groups must give
array for array, rank N // 2 failed by the elastic paths' hooks.  Each rank
reports the ms of each call, the index build's emission-decode and
exchange ms (`utils/metrics` stages `index_emissions`, `index_exchange`)
and its kernel launches; the script prints rank 0's report lines and one
JSON object a group (every rank's seconds, launches and arrays compared),
then the card's name and power limit.

Usage: CXX=g++ python -m duckdb_parquet_parser_tpu_torch.utils.probe_sharded
           [--rows 2000000] [--ranks 1,2,4] [--backend nccl|gloo]
           [--device cuda|cpu] [--work build/probe_sharded]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..bench import build_host_library, build_kernels, card_line, launches_of
from ..host.reader import ParquetReader
from ..models.scan import ScanEngine
from ..ops.kernels import dict_lookup
from ..parallel.index_build import distributed_index_build
from ..parallel.partition import pad_pages
from ..parallel.pipeline import distributed_decode
from ..utils.config import EngineConfig, set_config
from ..utils.metrics import get_metrics
from ..utils.record import recorded_calls

ROOT = Path(__file__).resolve().parents[2]
# (fixture, column, pattern) of the scans and index builds
COLUMNS = (("lineitem", "l_comment", "special.*requests"),
           ("city", "city", "san.*-1[0-9]"))
# the stream-matcher tuples the pass needs, built in one `nvcc` run (the
# ranks ask for the same list and load that library)
KERNEL_PATTERNS = [(pat,) for _name, _column, pat in COLUMNS]
CITY_ROWS_PER_RG, CITY_RG, CITY_DISTINCT = 100_000, 4, 1500
GROUP_TIMEOUT_S = 1200


def sharded_answers(mesh, files: dict, fail):
    """The sharded paths on `mesh`, every rank making the same calls:
    `ScanEngine(mesh=...).scan` of l_comment and city, an elastic scan of
    each whose hook fails rank `fail` (nobody when None), the index build
    of both columns in both exchange modes (with `fail`, once more with a
    hook that fails that rank in block 0), and the sharded decode of
    `files["decode"]` (path, column).  Returns ({name: array}, the results
    in a form that does not depend on the number of ranks; [log lines];
    the (table, gidx) that the emission decode of city gave `dict_lookup`
    on this rank in its first block).  On a card each call's kernel
    launches are checked; CPU ranks launch none."""
    on_card = mesh.device.type == "cuda"
    out, lines = {}, []
    emission_inputs = None

    def counted(fn):
        """(value, ms, launches) of one call."""
        t0 = time.perf_counter()
        res, launches = launches_of(fn)
        return res, (time.perf_counter() - t0) * 1e3, launches

    def by_gid(res):
        keep = res.page_gid >= 0
        order = np.argsort(res.page_gid[keep], kind="stable")
        return {"page_gid": res.page_gid[keep][order],
                "match_counts": res.match_counts[keep][order],
                "value_counts": res.value_counts[keep][order],
                "totals": np.asarray(res.totals)}

    def index_arrays(res):
        entries = np.concatenate(res.received)
        return {"tuple_to_chunk": res.index.tuple_to_chunk,
                "chunk_starts": res.index.chunk_starts,
                "chunk_of_entry": res.index.chunk_of_entry,
                "entries": entries[np.lexsort(entries.T[::-1])]}

    for name, column, pat in COLUMNS:
        eng = ScanEngine(str(files[name]), mesh=mesh)
        res, ms, launches = counted(lambda: eng.scan(column, pat))
        clean = by_gid(res)
        for k, v in clean.items():
            out[f"scan/{column}/{k}"] = v
        lines.append(
            f"scan {column} ~ {pat!r}: {ms:.1f} ms, {len(res.page_gid)} "
            f"padded pages, totals {res.totals.tolist()}, launches "
            f"{launches}")
        kernel = "stream_matcher" if column == "l_comment" else "dict_lookup"
        if on_card and launches[kernel] < 1:
            raise AssertionError(f"sharded scan of {column}: {kernel} was "
                                 "not launched")

        def fail_once(result, rnd):
            return {fail} if fail is not None and rnd == 0 else ()

        res, ms, launches = counted(
            lambda: eng.scan(column, pat, fault_hook=fail_once))
        for k, v in by_gid(res).items():
            if not np.array_equal(v, clean[k]):
                raise AssertionError(f"elastic scan of {column}: {k} differs "
                                     "from the clean scan")
        want = [] if fail is None else [fail]
        if res.elastic_report["failed"] != want:
            raise AssertionError(f"elastic scan of {column}: report "
                                 f"{res.elastic_report}")
        lines.append(f"elastic scan {column} (hook fails "
                     f"{'nobody' if fail is None else f'rank {fail}'}): "
                     f"{ms:.1f} ms, report {res.elastic_report}, launches "
                     f"{launches}; equal to the clean scan")

        built = {}
        for mode in ("ragged", "padded"):
            set_config(EngineConfig(exchange_mode=mode))
            try:
                with recorded_calls(dict_lookup, "dict_lookup") as lookups:
                    res, ms, launches = counted(
                        lambda: distributed_index_build(mesh, eng.reader,
                                                        column))
            finally:
                set_config(None)
            if on_card and len(lookups) != launches["dict_lookup"]:
                raise AssertionError(
                    f"index build {column}: {len(lookups)} dict_lookup calls "
                    f"but {launches['dict_lookup']} launches")
            if lookups and emission_inputs is None:
                emission_inputs = lookups[0][0]
            built[mode] = index_arrays(res)
            for k, v in built[mode].items():
                out[f"index/{column}/{mode}/{k}"] = v
            stages = get_metrics().summary()
            emis = stages["index_emissions"][-1]
            exch = stages["index_exchange"][-1]
            n_entries = sum(len(r) for r in res.received)
            lines.append(
                f"index build {column} ({mode}): {ms:.1f} ms, of which the "
                f"sharded emission decode {emis['seconds'] * 1e3:.1f} ms "
                f"({emis['pages']} pages) and the exchange "
                f"{exch['seconds'] * 1e3:.1f} ms ({exch['blocks']} blocks, "
                f"{res.shuffle_bytes} bytes, capacity "
                f"{res.exchange_capacity}); {n_entries} entries, "
                f"{len(res.index.chunk_starts)} chunks, planned slots over "
                f"entries {res.exchange_planned_slots / max(n_entries, 1):.4f}"
                f", skew {res.skew_factor:.4f}, launches {launches}")
            pages = emis["pages"]
            blocks = -(-pages // 8192)
            want_k2 = blocks if column == "city" else 0
            if on_card and (launches["dict_lookup"] < want_k2 or (
                    column == "l_comment" and launches["dict_lookup"])):
                raise AssertionError(
                    f"index build {column}: dict_lookup launched "
                    f"{launches['dict_lookup']} times over {blocks} blocks")
        for k in ("tuple_to_chunk", "chunk_starts", "chunk_of_entry",
                  "entries"):
            if not np.array_equal(built["ragged"][k], built["padded"][k]):
                raise AssertionError(f"index build {column}: {k} differs "
                                     "between the exchange modes")
        if fail is not None:
            def fail_block(blk, lens, emit):
                return {fail} if blk == 0 else ()

            res, ms, launches = counted(lambda: distributed_index_build(
                mesh, eng.reader, column, fault_hook=fail_block))
            for k, v in index_arrays(res).items():
                if not np.array_equal(v, built["ragged"][k]):
                    raise AssertionError(f"elastic index build {column}: "
                                         f"{k} differs from the clean build")
            lines.append(f"elastic index build {column} (rank {fail} fails in "
                         f"block 0): {ms:.1f} ms, launches {launches}; equal "
                         "to the clean build")

    path, column = files["decode"]
    reader = ParquetReader(str(path))
    batch = reader.prescan(column)
    (planes, nonnull, checksum), ms, launches = counted(
        lambda: distributed_decode(mesh, pad_pages(batch, 8 * mesh.size)))
    if on_card and launches["dict_lookup"] != 1:
        raise AssertionError(f"sharded decode of {column}: dict_lookup "
                             f"launched {launches['dict_lookup']} times")
    n = batch.n_pages
    out[f"decode/{column}/nonnull"] = nonnull[:n]
    out[f"decode/{column}/checksum"] = np.int64(checksum)
    for j, plane in enumerate(planes):
        out[f"decode/{column}/plane{j}"] = plane[:n]
    lines.append(f"sharded decode of {column}: {ms:.1f} ms, {n} pages x "
                 f"{batch.vmax}, checksum {checksum}, launches {launches}")
    return out, lines, emission_inputs


def make_files(fixtures: Path, rows: int) -> dict:
    """The pass's files: {"lineitem", "city": path, "decode": (path,
    column)}."""
    from . import fixtures as fx

    fixtures.mkdir(parents=True, exist_ok=True)
    return {
        "lineitem": fx.lineitem(fixtures / f"lineitem_{rows}.parquet", rows),
        "city": fx.dict_strings(
            fixtures / f"dict_cities_{CITY_ROWS_PER_RG}_{CITY_DISTINCT}"
            ".parquet", rows_per_rg=CITY_ROWS_PER_RG, n_rg=CITY_RG,
            distinct=CITY_DISTINCT),
        "decode": (fx.dict_ints(fixtures / f"dict_ints_{rows}.parquet", rows),
                   "k"),
    }


def _rank(rank: int, job_path: str) -> int:
    """One rank of a group that `run_group` started: the pass, its answers
    saved (`save`) or held against the saved ones, its report written as
    JSON; rank 0 also saves the emission decode's `dict_lookup` inputs."""
    from ..ops.kernels.build import BUILD_DIR
    from ..parallel.mesh import closing_group, join_file_group

    job = json.loads(Path(job_path).read_text())
    size = job["size"]
    if job["device"] != "cpu":
        # the parent built every library: a rank that had to build one
        # would compile beside the others on their clock
        built = sorted(BUILD_DIR.glob("*.so"))
        build_kernels([tuple(t) for t in job["kernel_patterns"]])
        if sorted(BUILD_DIR.glob("*.so")) != built:
            raise AssertionError(f"rank {rank} built a kernel: the parent "
                                 "must build every library first")
    files = {k: (tuple(v) if isinstance(v, list) else v)
             for k, v in job["files"].items()}
    with closing_group():
        mesh = join_file_group(job["store"], rank, size, job["device"],
                               job["backend"])
        t0 = time.perf_counter()
        (got, lines, emission), launches = launches_of(
            lambda: sharded_answers(mesh, files, fail=job["fail"]))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        seconds = time.perf_counter() - t0
        answers = Path(job["answers"])
        if job["save"]:
            np.savez(answers, **got)
            compared = 0
        else:
            with np.load(answers) as want:
                if sorted(want.files) != sorted(got):
                    raise AssertionError(f"rank {rank}: other results than "
                                         "the saved answers")
                for k in want.files:
                    if not np.array_equal(got[k], want[k]):
                        raise AssertionError(f"rank {rank}: {k} differs "
                                             "from the saved answer")
                compared = len(want.files)
        if rank == 0 and emission is not None:
            table, gidx = emission
            np.savez(f"{job['out']}.emission.npz", table=table.cpu().numpy(),
                     gidx=gidx.cpu().numpy())
        Path(f"{job['out']}.{rank}.json").write_text(json.dumps({
            "rank": rank, "size": size, "device": str(mesh.device),
            "backend": job["backend"], "lines": lines, "launches": launches,
            "seconds": seconds, "compared": compared,
            "emission_gidx": None if emission is None
            else list(emission[1].shape)}))
    return 0


def run_group(n: int, backend: str, device: str, files: dict, work: Path,
              answers: Path, *, save: bool, fail, kernel_patterns,
              timeout: float = GROUP_TIMEOUT_S) -> tuple[list, float]:
    """The pass as a group of `n` rank processes of this module (rank i on
    the device `parallel/mesh.spawned_device` gives it), meeting at a file
    store under `work`: each rank saves its answers to `answers` (`save`:
    one rank, whose answers the others are held against) or holds its own
    against them, and the hook fails rank `fail` (None: nobody).  On a card
    the parent must have built `kernel_patterns` (the stream-matcher
    tuples, as `bench.build_kernels` takes them) and every other kernel:
    a rank that builds one fails.  Returns (every rank's report, in rank
    order, the group's seconds of wall clock); rank 0 saves the emission
    decode's `dict_lookup` inputs to `work/report_<n>.emission.npz`.  A
    rank that fails raises here with its error."""
    from ..parallel.mesh import run_processes

    work.mkdir(parents=True, exist_ok=True)
    job = work / f"job_{n}.json"
    store = work / f"store_{n}"
    store.unlink(missing_ok=True)
    job.write_text(json.dumps({
        "size": n, "backend": backend, "device": device, "fail": fail,
        "store": str(store), "answers": str(answers), "save": save,
        "out": str(work / f"report_{n}"),
        "kernel_patterns": [list(t) for t in kernel_patterns],
        "files": {k: ([str(v[0]), v[1]] if isinstance(v, tuple) else str(v))
                  for k, v in files.items()}}))
    t0 = time.perf_counter()
    ends = run_processes(
        [[sys.executable, "-m", "duckdb_parquet_parser_tpu_torch.utils."
          "probe_sharded", "--rank", str(r), "--job", str(job)]
         for r in range(n)], timeout, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    for r, end in enumerate(ends):
        if end.returncode != 0:
            raise AssertionError(f"rank {r} of {n} exited with "
                                 f"{end.returncode}:\n{end.err[-4000:]}")
    return [json.loads((work / f"report_{n}.{r}.json").read_text())
            for r in range(n)], wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--work", default=str(ROOT / "build" / "probe_sharded"))
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--job", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _rank(args.rank, args.job)

    from ..parallel.mesh import check_layout

    sizes = [int(s) for s in args.ranks.split(",")]
    if sizes[0] != 1:
        raise ValueError("--ranks must start with 1: the larger groups are "
                         "held against one rank's answers")
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    for n in sizes:
        check_layout(n, args.device, args.backend, cards)
    work = Path(args.work)
    t0 = time.perf_counter()
    build_host_library()
    if args.device == "cuda":
        build_kernels(KERNEL_PATTERNS)
    files = make_files(ROOT / "build" / "fixtures", args.rows)
    print(f"fixtures and builds: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    answers = work / "answers.npz"
    answers.unlink(missing_ok=True)
    for n in sizes:
        reports, wall = run_group(
            n, args.backend, args.device, files, work, answers, save=n == 1,
            fail=n // 2 if n > 1 else None, kernel_patterns=KERNEL_PATTERNS)
        for line in reports[0]["lines"]:
            print(f"{n} rank(s), rank 0 on {reports[0]['device']} over "
                  f"{args.backend}: {line}", flush=True)
        print(json.dumps({"ranks": n, "wall_s": round(wall, 1), "reports": [
            {k: rep[k] for k in ("rank", "device", "seconds", "launches",
                                 "compared")} for rep in reports]}),
              flush=True)
    if args.device == "cuda":
        print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
