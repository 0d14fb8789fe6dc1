"""The port's multi-device dry run (duckdb_parquet_parser_tpu_torch/dryrun.py)
against the reference's, `__graft_entry__.dryrun_multichip(n)`, at 1, 2, 4
and 8 ranks.

The reference runs on the tests' virtual CPU devices, one process for each
n (`python -c`, all at once: its sharded delta decode compiles eagerly for
about two minutes at 2 and 8 devices), while the port's ranks run as
child processes over gloo (tests/torch_dist_dryrun.py, which blocks JAX
and the JAX package), one group after another.  What each side gives is
its line, or the exception that ended it as "Type: message": at 2 and 8
the reference's line, character for character (sections 7 and 8 run here,
where pyarrow imports); at 4 the reference's own fault in section 3, the
ragged exchange's 5592 planned slots for 4500 entries; at 1 section 5's
"all devices failed".  The module's own rank spawner
(`python -m duckdb_parquet_parser_tpu_torch.dryrun N --device cpu
--backend gloo`) must relay the same, as must two ranks that torchrun
starts, and the rules that nothing falls back (no card, NCCL with more
ranks than cards) hold in process."""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from duckdb_parquet_parser_tpu_torch import dryrun
from duckdb_parquet_parser_tpu_torch.parallel import mesh
from duckdb_parquet_parser_tpu_torch.parallel.mesh import run_processes
from duckdb_parquet_parser_tpu_torch.utils.record import (
    KERNEL_WRAPPERS,
    hold_recorded,
)

ROOT = Path(__file__).resolve().parents[1]
SIZES = (1, 2, 4, 8)
REFERENCE_TIMEOUT_S = 600
GROUP_TIMEOUT_S = 150
REFERENCE = """
import contextlib, io, sys
import jax
jax.config.update("jax_platforms", "cpu")
import __graft_entry__ as g
out = io.StringIO()
try:
    with contextlib.redirect_stdout(out):
        g.dryrun_multichip(int(sys.argv[1]))
    print(out.getvalue().strip().splitlines()[-1])
except Exception as e:
    print(f"{type(e).__name__}: {e}")
"""
# torch.distributed prefixes a rank's traceback lines with "[rank<r>]: "
RANK_PREFIX = re.compile(r"^\[rank\d+\]:\s?")
LAUNCH_LINE = re.compile(r"^\[dryrun\] rank (\d+) of (\d+) on cpu over gloo: "
                         r"launches \{.*\}, [0-9.]+ s$", re.M)


def _last_line(text: str) -> str:
    lines = text.strip().splitlines()
    return RANK_PREFIX.sub("", lines[-1]) if lines else ""


def _reference(results: dict) -> None:
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    ends = run_processes([[sys.executable, "-c", REFERENCE, str(n)]
                          for n in SIZES], REFERENCE_TIMEOUT_S, cwd=str(ROOT),
                         env=env, grace=None)
    for n, end in zip(SIZES, ends):
        assert end.returncode == 0, end.err[-4000:]
        results[n] = _last_line(end.out)


def _port_group(n: int, tmp: Path) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return run_processes(
        [[sys.executable, str(ROOT / "tests" / "torch_dist_dryrun.py"),
          str(rank), str(n), str(tmp / f"store_{n}")] for rank in range(n)],
        GROUP_TIMEOUT_S, cwd=str(tmp), env=env)


def _outcome(ends) -> str:
    """The group's line (rank 0's last stdout line) when every rank exited
    0, else the error every rank ended with, as "Type: message"."""
    if all(e.returncode == 0 for e in ends):
        return _last_line(ends[0].out)
    errors = {_last_line(e.err) for e in ends}
    assert len(errors) == 1, [e.err[-2000:] for e in ends]
    return errors.pop()


def _spawned(n: int, record: Path) -> object:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    end, = run_processes(
        [[sys.executable, "-m", dryrun.MODULE, str(n), "--device", "cpu",
          "--backend", "gloo", "--record", str(record)]], GROUP_TIMEOUT_S,
        cwd=str(ROOT), env=env)
    return end


def _under_torchrun(n: int) -> object:
    """The dry run as one rank of a group that torchrun formed."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    end, = run_processes(
        [[sys.executable, "-m", "torch.distributed.run", "--standalone",
          "--nproc-per-node", str(n), "-m", dryrun.MODULE, str(n),
          "--device", "cpu", "--backend", "gloo"]], GROUP_TIMEOUT_S,
        cwd=str(ROOT), env=env)
    return end


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"reference": {n: outcome}, "port": {n: outcome}, "ends": {n: the
    port's rank ends}, "spawned": {n: the spawner's end}, "record": {n: the
    directory of the spawned ranks' recorded calls}, "torchrun": the end
    of two ranks under torchrun}."""
    tmp = tmp_path_factory.mktemp("dryrun")
    reference: dict = {}
    failed = []

    def ref():
        try:
            _reference(reference)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            failed.append(e)

    thread = threading.Thread(target=ref)
    thread.start()
    try:
        ends = {n: _port_group(n, tmp) for n in SIZES}
        record = {n: tmp / f"record_{n}" for n in (2, 4)}
        spawned = {n: _spawned(n, record[n]) for n in (2, 4)}
        torchrun = _under_torchrun(2)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return {"reference": reference, "ends": ends, "spawned": spawned,
            "record": record, "torchrun": torchrun,
            "port": {n: _outcome(e) for n, e in ends.items()}}


@pytest.mark.parametrize("n", SIZES)
def test_dryrun_equals_reference(runs, n):
    assert runs["port"][n] == runs["reference"][n]


def test_two_ranks_run_every_section(runs):
    line = runs["port"][2]
    assert line.startswith("dryrun_multichip(2): scan totals=")
    assert line.endswith("; nested scan 113 hits; sharded delta decode 6 "
                         "pages; sub-meshes: n/a — OK"), line


def test_eight_ranks_run_the_sub_meshes(runs):
    assert runs["port"][8].endswith("sub-meshes: n=2 ok, n=4 ok — OK"), \
        runs["port"][8]


@pytest.mark.parametrize("n, error", [
    (4, "AssertionError: ragged exchange planned 5592 slots for 4500 "
        "entries (ratio 1.24)"),
    (1, "RuntimeError: all devices failed"),
])
def test_failing_sizes_raise_the_reference_error(runs, n, error):
    assert runs["reference"][n] == error
    assert runs["port"][n] == error
    assert all(e.returncode == 1 for e in runs["ends"][n])


@pytest.mark.parametrize("n", (2, 8))
def test_every_rank_reports_and_only_rank_zero_prints(runs, n):
    ends = runs["ends"][n]
    assert all(e.returncode == 0 for e in ends), [e.err[-2000:] for e in ends]
    for rank, e in enumerate(ends):
        assert [(int(r), int(s)) for r, s in LAUNCH_LINE.findall(e.err)] == [
            (rank, n)], e.err[-2000:]
        printed = [ln for ln in e.out.splitlines()
                   if ln.startswith("dryrun_multichip")]
        assert len(printed) == (rank == 0), e.out


def test_spawn_relays_rank_zero_line(runs):
    end = runs["spawned"][2]
    assert end.returncode == 0, end.err[-4000:]
    assert end.out.strip().splitlines() == [runs["reference"][2]], end.out
    assert sorted(int(r) for r, _ in LAUNCH_LINE.findall(end.err)) == [0, 1]


def test_spawned_ranks_record_the_kernels_calls(runs):
    """`--record`: each rank saves every call of the kernels' wrappers,
    which made again give what the plain versions give (on the CPU the
    wrappers are the plain versions: this holds the record itself)."""
    assert runs["spawned"][2].returncode == 0
    for rank in range(2):
        calls = torch.load(runs["record"][2] / f"rank{rank}.pt",
                           weights_only=False)
        assert sorted(calls) == sorted(KERNEL_WRAPPERS)
        held = hold_recorded(calls, "cpu")
        assert held["stream_matcher.match_stream"]["calls"] > 0
        assert held["dict_lookup.dict_lookup"]["calls"] > 0
        assert all(h["max_abs_err"] == 0 for h in held.values()), held
    # a rank that raises saves nothing
    assert not list(runs["record"][4].glob("*.pt"))


def test_spawn_relays_failing_rank_error(runs):
    end = runs["spawned"][4]
    assert end.returncode == 1
    assert end.out == ""
    assert _last_line(end.err) == runs["reference"][4], end.err[-4000:]
    assert re.search(r"^\[dryrun\] rank \d of 4 exited with 1:$", end.err,
                     re.M), end.err[-4000:]


def test_ranks_under_torchrun_print_the_reference_line(runs):
    end = runs["torchrun"]
    assert end.returncode == 0, end.err[-4000:]
    assert end.out.strip().splitlines()[-1] == runs["reference"][2], end.out
    assert sorted(int(r) for r, _ in LAUNCH_LINE.findall(end.err)) == [0, 1]


# ── nothing falls back ───────────────────────────────────────────────────────


@pytest.mark.parametrize("argv", [["2"], ["2", "--backend", "nccl"],
                                  ["2", "--device", "cuda", "--backend",
                                   "gloo"]])
def test_cuda_without_a_card_raises(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for k in ("DPQ_COORDINATOR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(argv)


def test_nccl_on_the_cpu_raises():
    with pytest.raises(ValueError, match="nccl backend needs a card"):
        dryrun.main(["2", "--device", "cpu", "--backend", "nccl"])


@pytest.mark.parametrize("n, cards", [(2, 1), (4, 2), (8, 4)])
def test_nccl_with_more_ranks_than_cards_raises(n, cards):
    with pytest.raises(ValueError, match="^NCCL refuses two ranks on one "
                                         "card: use --backend gloo"):
        mesh.check_layout(n, "cuda", "nccl", cards)


@pytest.mark.parametrize("n, device, backend, cards", [
    (1, "cuda", "nccl", 1), (4, "cuda", "nccl", 4), (2, "cuda", "gloo", 1),
    (8, "cpu", "gloo", 0)])
def test_layouts_that_run(n, device, backend, cards):
    mesh.check_layout(n, device, backend, cards)


def test_rank_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [mesh.spawned_device("cuda", "nccl", r) for r in range(4)] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert [mesh.spawned_device("cuda", "gloo", r) for r in range(4)] == [
        "cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert mesh.spawned_device("cpu", "gloo", 3) == "cpu"


def test_joined_group_of_another_size_raises(monkeypatch):
    monkeypatch.delenv("DPQ_COORDINATOR", raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="the group has 2 ranks, not 4"):
        dryrun.main(["4", "--device", "cpu", "--backend", "gloo"])


# ── parallel/mesh.run_processes, which starts the ranks ─────────────────────


def _py(code: str) -> list[str]:
    return [sys.executable, "-c", code]


def test_a_failing_rank_ends_the_group_after_the_grace():
    ends = run_processes([_py("raise SystemExit(3)"),
                          _py("import time; time.sleep(60)")], 60, grace=0.5)
    assert [e.returncode for e in ends] == [3, -9]


@pytest.mark.parametrize("failing", [0, 1, 2])
def test_a_failing_rank_ends_the_group_wherever_it_stands(failing):
    """The grace starts when any rank fails, not only the first one."""
    argvs = [_py("import time; time.sleep(60)") for _ in range(3)]
    argvs[failing] = _py("import time; time.sleep(0.5); raise SystemExit(3)")
    t0 = time.monotonic()
    ends = run_processes(argvs, 60, grace=0.5)
    assert time.monotonic() - t0 < 30
    assert [e.returncode for e in ends] == [
        3 if r == failing else -9 for r in range(3)]


def test_a_rank_that_outlives_the_timeout_is_killed():
    ends = run_processes([_py("print('ok')"), _py("import time; "
                                                  "time.sleep(60)")], 1)
    assert [e.returncode for e in ends] == [0, -9]
    assert ends[0].out == "ok\n"


def test_processes_without_grace_run_on():
    ends = run_processes([_py("raise SystemExit(3)"),
                          _py("import time; time.sleep(1); print('done')")],
                         60, grace=None)
    assert [(e.returncode, e.out) for e in ends] == [(3, ""), (0, "done\n")]


def test_output_larger_than_a_pipe_does_not_stall():
    ends = run_processes([_py("import sys; sys.stderr.write('x' * 1000000); "
                              "print('end')")], 60)
    assert ends[0].returncode == 0
    assert len(ends[0].err) == 1000000 and ends[0].out == "end\n"


def test_chip_smoke_holds_the_reference_line(runs):
    """`chip_smoke.py` holds the dry run on the card to `DRYRUN_LINE`: with
    pyarrow's sections, that is the reference's line at two devices."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.DRYRUN_RANKS == 2
    assert smoke.DRYRUN_LINE.format(
        nested="nested scan 113 hits",
        delta="sharded delta decode 6 pages") == runs["reference"][2]
