"""One process a card, for a cell whose `chips` is more than 1.

The process started for the cell is rank 0.  It starts ranks 1..n-1 as its
children, each the same `python3 -m portbench` command with its rank, the
group's size, a rendezvous file under `build/portbench/` and the kind of
device; rank r takes `cuda:<r>` (NCCL refuses two ranks on one card), or
the CPU over gloo.  The group is formed by the program's own
`parallel/mesh.join_file_group`.

Rank 0 makes the table and does what the route prepares once (files, the
K1 build); then it hands the others the plan (configuration, traffic, seed,
the table's file) and they open the same file and find the built kernels.
Every rank sets up the route and draws the same queries from the seed;
before each query rank 0 broadcasts go or stop, so that all make the same
calls and stop together.  After the window every rank's peak memory is
gathered to rank 0, with the seconds its card was busy where every rank
ran the profiler (`--trace 1`), and the group closes; only rank 0 keeps
answers and prints.  Children write only to standard error.  A child that
holds `jax`, `jaxlib`, `flax` or the JAX package once its window has closed
exits with `run.EXIT_FORBIDDEN`, as rank 0 would.

A child that exits with another code than 0, or outlives the window plus
`SETUP_MARGIN_S`, ends the run: rank 0 kills every child, waits for each,
and exits with `EXIT_RANK` and no result (a rank left waiting in a
collective would wait for the group's timeout).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.distributed as dist

from duckdb_parquet_parser_tpu_torch.parallel import mesh as pmesh

ROOT = Path(__file__).resolve().parents[1]
EXIT_RANK = 4
SETUP_MARGIN_S = 600.0
CLOSE_WAIT_S = 60.0


class Rank:
    """One rank's side of the group: the collectives the runner needs."""

    def __init__(self, mesh: pmesh.PagesMesh):
        self.mesh = mesh
        self.via = mesh.device if mesh.backend == "nccl" else torch.device("cpu")

    def share(self, value=None):
        """Rank 0's `value` on every rank."""
        return pmesh.broadcast_arrays(self.mesh, value, 0)

    def barrier(self) -> None:
        dist.barrier(group=self.mesh.group)

    def agree(self, go: bool) -> bool:
        """Rank 0's go (True) or stop, on every rank."""
        flag = torch.tensor([int(go)], dtype=torch.int32, device=self.via)
        dist.broadcast(flag, src=self.mesh.ranks[0], group=self.mesh.group)
        return bool(flag.item())

    def gather(self, peak_bytes: int, busy_s: float) -> list[tuple]:
        """Every rank's (peak device memory in bytes, seconds its card was
        busy in a traced window), in rank order."""
        mine = torch.tensor([[int(peak_bytes), round(busy_s * 1e9)]],
                            dtype=torch.int64)
        return [(int(peak), int(busy) / 1e9)
                for peak, busy in pmesh.to_global(self.mesh, mine)]

    def close(self) -> None:
        pmesh.close_group()


def backend_of(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


class Group:
    """Rank 0's children and its side of the group; a context manager that
    leaves no child behind, whatever ends the block."""

    def __init__(self, n: int, device: torch.device, rendezvous: Path,
                 argv: list[str], seconds: float):
        self.n = n
        self.kind = device.type
        self.rendezvous = Path(rendezvous)
        self.argv = list(argv)
        self.deadline = time.monotonic() + seconds + SETUP_MARGIN_S
        self.procs: list[subprocess.Popen] = []
        self.rank: Rank | None = None
        self._done = threading.Event()
        self._lock = threading.Lock()

    def __enter__(self) -> "Group":
        self.rendezvous.parent.mkdir(parents=True, exist_ok=True)
        self.rendezvous.unlink(missing_ok=True)
        for r in range(1, self.n):
            # a child's standard output goes to standard error: only rank 0
            # prints on standard output
            p = subprocess.Popen(
                [sys.executable, "-m", "portbench", *self.argv,
                 "--rank", str(r), "--ranks", str(self.n),
                 "--rendezvous", str(self.rendezvous), "--device", self.kind],
                cwd=ROOT, stdout=2)
            self.procs.append(p)
            print(f"rank {r}: pid {p.pid}", file=sys.stderr, flush=True)
        threading.Thread(target=self._watch, daemon=True).start()
        return self

    def join(self) -> Rank:
        """Forms the group with the children (waits for them to reach it)."""
        self.rank = Rank(pmesh.join_file_group(
            str(self.rendezvous), 0, self.n, self.kind, backend_of(self.kind)))
        return self.rank

    def _watch(self) -> None:
        while not self._done.wait(0.2):
            failed = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                      if p.poll() not in (None, 0)]
            late = time.monotonic() > self.deadline
            if failed or late:
                what = (", ".join(f"rank {r} exited with {c}" for r, c in failed)
                        or f"ranks alive past the window and "
                           f"{SETUP_MARGIN_S:.0f} s of set-up")
                self._end(f"{what}: the run has no result")

    def _end(self, message: str) -> None:
        """Ends the run from any thread: every child killed and waited
        for, then this process, with `EXIT_RANK`."""
        with self._lock:
            print(message, file=sys.stderr, flush=True)
            self._kill()
            sys.stdout.flush()
            os._exit(EXIT_RANK)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self) -> None:
        """Closes the group, then waits for every child to exit 0."""
        self.rank.close()
        end = time.monotonic() + CLOSE_WAIT_S
        for p in self.procs:
            try:
                p.wait(max(end - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                pass
        self._done.set()
        codes = [p.poll() for p in self.procs]
        if any(c != 0 for c in codes):
            self._end(f"ranks 1..{self.n - 1} ended with {codes}: the run "
                      "has no result")

    def __exit__(self, kind, value, tb) -> None:
        self._done.set()
        self.rendezvous.unlink(missing_ok=True)
        if kind is not None:
            # a rank of a group that raised cannot leave its collectives in
            # step: end every process now
            traceback.print_exception(kind, value, tb, file=sys.stderr)
            self._end("rank 0 raised: the run has no result")
        self._kill()


def child(args) -> int:
    """Rank `args.rank` of a cell's group, to the end of the window."""
    from . import traffic as traffic_gen
    from .routes import find

    device = args.device
    rank = Rank(pmesh.join_file_group(args.rendezvous, args.rank, args.ranks,
                                      device, backend_of(device)))
    plan = rank.share()
    dev = rank.mesh.device
    table = SimpleNamespace(path=Path(plan["table"]))
    route = find(plan["traffic"]["route"])(
        plan["cfg"], table, plan["seed"], dev, mesh=rank.mesh)
    route.setup(traffic_gen.pool(plan["traffic"]))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    rank.barrier()
    queries = traffic_gen.draw(plan["traffic"], plan["seed"])
    prof = None
    if args.trace:
        from . import trace as tracing
        prof = tracing.profiler()
        prof.start()
    while rank.agree(True):
        route.op(next(queries))
    busy = 0.0
    if prof is not None:
        prof.stop()
        busy = tracing.read_profile(
            prof, Path(plan["trace"]).with_suffix(f".rank{args.rank}.json")
        ).busy_seconds()
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    rank.gather(peak, busy)
    route.close()
    rank.close()
    # what this rank loaded is checked as rank 0's own is: a rank that
    # exits with another code than 0 leaves the run without a result
    from .run import EXIT_FORBIDDEN, forbidden_modules
    found = forbidden_modules()
    if found:
        print(f"rank {args.rank} loaded {sorted(found)}", file=sys.stderr,
              flush=True)
        return EXIT_FORBIDDEN
    return 0
