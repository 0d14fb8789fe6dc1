"""The pages mesh: one process per device over `torch.distributed`.

Counterpart of `duckdb_parquet_parser_tpu.parallel.mesh`.  The engine's
parallel axis is *pages*: page batches shard along one axis, and the index
build's entry exchange is an all-to-all over the same ranks.  The reference
is single-controller inside a process (one `Mesh` over its devices, sharded
with `shard_map`) and multi-controller across hosts.  The port takes
PyTorch's idiom for both cases: every rank is a process with one device, and
a `PagesMesh` names the rank, the group's size, the rank's device, the
process group and its backend.

The backend is the caller's explicit choice: "nccl" where every rank has a
card of its own, "gloo" where the ranks run on the CPU or share one card
(NCCL refuses two ranks on one device).  Nothing falls from one to the
other.  A process that formed no group gets a group of one rank from
`make_mesh`, so the one-device case runs the same collectives as the
sharded one and not a second code path.

Every rank holds the whole padded batch on the host, as every process of
the reference does, and uploads only its own page rows; `to_global` is the
result boundary, where every rank gets the whole array.  While a profiler
records, `to_global` and `all_reduce_sum` are each a `dpq.exchange` span,
from the staging to the copy back (utils/tracing.py).
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tracing import annotate, count

BACKENDS = ("nccl", "gloo")
# a collective that a lost rank never joins ends here and not at the
# library's half hour
GROUP_TIMEOUT = timedelta(seconds=600)


@dataclass(frozen=True)
class PagesMesh:
    """One rank's view of a 1-D mesh over pages.  `rank` is the rank's slot
    in this mesh (-1 for a process that is not a member of a survivor
    mesh), `size` the number of slots, `ranks` the global rank behind each
    slot."""

    rank: int
    size: int
    device: torch.device
    group: object
    backend: str
    ranks: tuple

    @property
    def member(self) -> bool:
        return self.rank >= 0


def _check(device, backend: str) -> torch.device:
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device for every "
                         f"rank; this rank was given {device}")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        # kernels and NCCL collectives launch on the current device
        torch.cuda.set_device(device)
    return device


def make_mesh(device, backend: str) -> PagesMesh:
    """The mesh over every rank of the process group, with this rank's
    `device`.  With no group formed (`distributed_init_from_env` returned
    False, or was not called) a group of this one rank is formed here."""
    device = _check(device, backend)
    if not dist.is_initialized():
        fd, store = tempfile.mkstemp(prefix="dpq_group_")
        os.close(fd)
        os.unlink(store)  # the file store creates and removes it itself
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=0, world_size=1, timeout=GROUP_TIMEOUT)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group was formed over "
                         f"{dist.get_backend()}, not {backend}")
    size = dist.get_world_size()
    return PagesMesh(rank=dist.get_rank(), size=size, device=device,
                     group=dist.group.WORLD, backend=backend,
                     ranks=tuple(range(size)))


def distributed_init_from_env(backend: str) -> bool:
    """Forms the process group from the environment; returns True when a
    group formed.

    Detection order:
      1. DPQ_COORDINATOR (+ DPQ_NUM_PROCESSES / DPQ_PROCESS_ID): explicit
         rendezvous at `tcp://<coordinator>`, on any backend;
      2. `torchrun`'s RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT;
      3. neither: single process, nothing formed (`make_mesh` then forms a
         group of one)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    env = os.environ
    if env.get("DPQ_COORDINATOR"):
        dist.init_process_group(
            backend, init_method=f"tcp://{env['DPQ_COORDINATOR']}",
            world_size=int(env.get("DPQ_NUM_PROCESSES", "1")),
            rank=int(env.get("DPQ_PROCESS_ID", "0")), timeout=GROUP_TIMEOUT)
        return True
    if all(env.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                "MASTER_PORT")):
        dist.init_process_group(backend, init_method="env://",
                                timeout=GROUP_TIMEOUT)
        return True
    return False


def close_group(barrier: bool = True) -> None:
    """Ends this process's process group, where one is alive: a barrier
    (unless `barrier` is False), so that no rank leaves while another still
    talks to the rendezvous store (rank 0 serves it), then
    `destroy_process_group`.  A process that exits with its group alive may
    abort in the group's C++ destructors ("terminate called without an
    active exception")."""
    if dist.is_initialized():
        if barrier:
            dist.barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def closing_group():
    """Ends the process group alive when the block ends, whoever formed it
    (`distributed_init_from_env`, or `make_mesh`'s group of one): after a
    barrier when the block ends normally, at once when it raises (another
    rank may never reach the barrier)."""
    try:
        yield
    except BaseException:
        close_group(barrier=False)
        raise
    close_group()


def rank_device(device: str) -> str:
    """The device an entry point was asked for, for this rank: a bare
    "cuda" under `torchrun` is the card of the local rank."""
    if device == "cuda" and os.environ.get("LOCAL_RANK"):
        return f"cuda:{os.environ['LOCAL_RANK']}"
    return device


def check_layout(n: int, device: str, backend: str, cards: int) -> None:
    """Raises unless `n` ranks on `device` over `backend` can run where
    `cards` CUDA devices are visible.  Nothing falls back."""
    if n < 1:
        raise ValueError(f"a group needs at least one rank, not {n}")
    if device == "cuda" and cards == 0:
        raise RuntimeError("no CUDA device: --device cuda needs a card "
                           "(--device cpu runs the ranks on the CPU)")
    if backend == "nccl" and device != "cuda":
        raise ValueError("the nccl backend needs a card for every rank: "
                         "use --backend gloo with --device cpu")
    if backend == "nccl" and n > cards:
        raise ValueError("NCCL refuses two ranks on one card: use --backend "
                         f"gloo ({n} ranks, {cards} card(s))")


def spawned_device(device: str, backend: str, rank: int) -> str:
    """The device of rank `rank` of a group that one parent started (see
    `run_processes`): the CPU, card `rank` under nccl, the cards in turn
    under gloo."""
    if device == "cpu":
        return "cpu"
    if backend == "nccl":
        return f"cuda:{rank}"
    return f"cuda:{rank % torch.cuda.device_count()}"


def join_file_group(store: str, rank: int, size: int, device: str,
                    backend: str) -> PagesMesh:
    """This process as rank `rank` of `size` ranks that one parent started,
    meeting at the file store `store`; returns its mesh, on the device
    `spawned_device` gives it."""
    device = spawned_device(device, backend, rank)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=size,
                            timeout=GROUP_TIMEOUT)
    return make_mesh(device, backend)


def _stage(mesh: PagesMesh, x) -> torch.Tensor:
    """`x` where the backend's collectives take it: on the host under
    gloo (a CUDA shard is staged through the host here, in this one
    place), on the rank's card under nccl.  Its bytes, this rank's part of
    the collective, count as `exchange_bytes`."""
    t = torch.as_tensor(x)
    t = t.cpu() if mesh.backend == "gloo" else t.to(mesh.device)
    count("exchange_bytes", t.numel() * t.element_size())
    return t.contiguous()


@annotate("dpq.exchange")
def to_global(mesh: PagesMesh, x) -> np.ndarray:
    """The result boundary of a sharded operation: every rank's shard `x`
    (equal shapes) concatenated along axis 0, in rank order, as a numpy
    array on EVERY rank."""
    t = _stage(mesh, x)
    as_bool = t.dtype == torch.bool
    if as_bool:
        t = t.view(torch.uint8)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    out = torch.cat(parts).cpu().numpy()
    return out.view(bool) if as_bool else out


@annotate("dpq.exchange")
def all_reduce_sum(mesh: PagesMesh, x) -> np.ndarray:
    """The sum of every rank's `x` (an integer tensor), on every rank."""
    t = _stage(mesh, x).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t.cpu().numpy()


def broadcast_arrays(mesh: PagesMesh, arrays, src: int):
    """`arrays` (any picklable value, numpy arrays here) of mesh slot `src`
    on every rank of `mesh`; the other ranks pass None."""
    box = [arrays if mesh.rank == src else None]
    via = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    dist.broadcast_object_list(box, src=mesh.ranks[src], group=mesh.group,
                               device=via)
    return box[0]


def survivor_mesh(mesh: PagesMesh, live: list[int]) -> PagesMesh:
    """A mesh over the surviving slots `live` of `mesh` (elastic recovery
    re-runs orphaned shards on it).  `mesh` must span the whole process
    group, and EVERY rank of it must make this call, the failed ones too:
    forming a sub-group is itself a collective of the parent group.  A rank
    outside `live` gets a mesh of which it is no member (`rank == -1`); it
    sits the re-run out and receives the merged result by
    `broadcast_arrays` over the full mesh."""
    if mesh.group is not dist.group.WORLD:
        raise ValueError("survivor_mesh needs the mesh of the whole group")
    ranks = tuple(mesh.ranks[d] for d in live)
    group = dist.new_group(ranks=list(ranks), backend=mesh.backend,
                           timeout=GROUP_TIMEOUT)
    slot = live.index(mesh.rank) if mesh.rank in live else -1
    return PagesMesh(rank=slot, size=len(live), device=mesh.device,
                     group=group, backend=mesh.backend, ranks=ranks)


def run_on_survivors(mesh: PagesMesh, live: list[int], fn):
    """`fn(sub_mesh)` on the survivor mesh over `live`, its value (numpy
    arrays) on every rank of `mesh`: the members run it, and the first of
    them hands its value to everybody."""
    sub = survivor_mesh(mesh, live)
    value = None
    if sub.member:
        value = fn(sub)
        dist.destroy_process_group(sub.group)
    return broadcast_arrays(mesh, value, live[0])


# ── rank processes started by one parent ─────────────────────────────────────


def free_port() -> int:
    """A TCP port of this host that nothing listens on (for a `tcp://`
    rendezvous or torchrun's MASTER_PORT)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@dataclass(frozen=True)
class ProcessEnd:
    """How one started process ended: its exit code (-9 when it was killed
    for outliving its time), and what it printed."""

    returncode: int
    out: str
    err: str


def run_processes(argvs, timeout: float, *, cwd=None, env=None,
                  grace: float | None = 30.0) -> list[ProcessEnd]:
    """Starts one process an argv of `argvs`, all at once, and waits for
    them: the ranks of one group, which must run together.  Their output
    goes to files, not pipes (a rank blocked on a pipe nobody drains would
    stall the collective the others wait in).  Once one exits non-zero the
    others get `grace` seconds to end (every rank raises the same check;
    None: processes that are not one group, which all run on); a process
    still alive then, or at `timeout`, is killed.  `env` is one
    environment for all, or a list of one a process.  Returns every
    process's end, in the order of `argvs`."""
    argvs = list(argvs)
    envs = env if isinstance(env, list) else [env] * len(argvs)
    with contextlib.ExitStack() as stack:
        files = [(stack.enter_context(tempfile.TemporaryFile("w+")),
                  stack.enter_context(tempfile.TemporaryFile("w+")))
                 for _ in argvs]
        procs = []
        try:
            for argv, e, (out, err) in zip(argvs, envs, files):
                procs.append(subprocess.Popen(argv, cwd=cwd, env=e,
                                              stdout=out, stderr=err,
                                              text=True))
            deadline = time.monotonic() + timeout
            failed = False
            while True:
                # every process polled on each pass, so a failure is seen
                # whichever rank it is
                codes = [p.poll() for p in procs]
                if None not in codes:
                    break
                if grace is not None and not failed and any(codes):
                    failed = True
                    deadline = min(deadline, time.monotonic() + grace)
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ends = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            ends.append(ProcessEnd(p.returncode, out.read(), err.read()))
        return ends
