"""The port's launch entry point and scaling harness
(duckdb_parquet_parser_tpu_torch/{launch,scaling_bench}.py,
parallel/mesh.distributed_init_from_env).

Two real processes of `python -m duckdb_parquet_parser_tpu_torch.launch`
meet over gloo on the CPU through DPQ_COORDINATOR and print, on rank 0, the
JSON line that two processes of the JAX package's launch print on a mesh of
the same size (one virtual device a process).  Every child runs under a
timeout and is killed when it runs out; a non-zero exit fails the test with
the child's stderr."""

from __future__ import annotations

import contextlib
import json
import os
import re
import sys

import numpy as np
import pytest

from duckdb_parquet_parser_tpu_torch.parallel.mesh import (
    free_port,
    run_processes,
)
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
# what a rendezvous prints when its port was taken between `free_port` and
# the bind
BIND_FAILED = re.compile(r"address already in use|EADDRINUSE", re.I)


def _launch_two(module: str, args: list[str], extra_env: dict) -> dict:
    """Runs `python -m <module> <args>` as two coordinated processes;
    returns the JSON that process 0 printed last.  `free_port` closes its
    socket before the children bind it, so another process may take the
    port first: a pair whose rendezvous could not bind is started once more
    on a fresh port.  A failure shows both processes' stderr."""
    tries = []
    for _attempt in range(2):
        ends = _run_pair(module, args, extra_env, free_port())
        tries.append("\n".join(f"process {i} (rc={e.returncode}):\n"
                               f"{e.err[-3000:]}"
                               for i, e in enumerate(ends)))
        if not any(e.returncode for e in ends):
            break
        if not any(BIND_FAILED.search(e.err) for e in ends):
            break
    assert not any(e.returncode for e in ends), (
        f"{module} failed:\n" + "\n--- retried on a fresh port:\n".join(tries))
    # results print on process 0 only (gloo writes a connection banner)
    assert not [ln for ln in ends[1].out.splitlines() if ln.startswith("{")]
    return json.loads(ends[0].out.strip().splitlines()[-1])


def _run_pair(module, args, extra_env, port):
    """The two processes of one rendezvous at `port`, run to their end (or
    killed at TIMEOUT_S, or 30 s after one of them failed): their
    `ProcessEnd`s."""
    envs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("DPQ_SCALING_PLATFORM", "RANK", "WORLD_SIZE")}
        env.update(DPQ_COORDINATOR=f"127.0.0.1:{port}", DPQ_NUM_PROCESSES="2",
                   DPQ_PROCESS_ID=str(pid), PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1", **extra_env)
        envs.append(env)
    return run_processes([[sys.executable, "-m", module] + args] * 2,
                         TIMEOUT_S, cwd=REPO, env=envs)


def _port(args):
    return _launch_two("duckdb_parquet_parser_tpu_torch.launch",
                       args + ["--device", "cpu", "--backend", "gloo"], {})


def _reference(args):
    return _launch_two(
        "duckdb_parquet_parser_tpu.launch", args,
        dict(DPQ_PLATFORM="cpu", JAX_PLATFORMS="cpu",
             XLA_FLAGS="--xla_force_host_platform_device_count=1"))


@pytest.fixture(scope="module")
def fixture_file(tmp_path_factory):
    rng = np.random.default_rng(31)
    return str(fixtures.strings_file(
        tmp_path_factory.mktemp("torch_mh") / "mh.parquet", rng,
        n=1200, n_unique=None, null_p=0.1, rgs=2))


@pytest.mark.parametrize("args", [
    ["scan", "{file}", "s", "alpha"],
    ["scan", "{file}", "s", "o[a-z]t", "--negate"],
    ["index", "{file}", "s", "--chunk-size", "512"],
], ids=["scan", "scan-negate", "index"])
def test_two_process_launch_prints_the_reference_json(fixture_file, args):
    args = [a.format(file=fixture_file) for a in args]
    got, want = _port(args), _reference(args)
    assert got["processes"] == 2 and got["devices"] == 2
    assert want["processes"] == 2
    want["devices"] = got["devices"]  # one device a process in the port
    assert got == want
    if args[0] == "scan":
        from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine

        golden = ScanEngine(fixture_file).scan(
            "s", args[3], negate="--negate" in args, device="cpu")
        assert got["total_matches"] == int(golden.match_counts.sum())
        assert got["total_values"] == int(golden.value_counts.sum())


def test_two_process_scaling_bench_emits_table():
    out = _port(["scaling-bench", "--rows", "4000", "--reps", "2"])
    assert out["metric"] == "scan_scaling" and out["platform"] == "cpu"
    assert "CPU ranks" in out["note"]
    assert [row["devices"] for row in out["table"]] == [1, 2]
    for row in out["table"]:
        assert sorted(row) == ["devices", "efficiency_compute",
                               "efficiency_wall", "rows_per_s",
                               "shard_value_skew"]
        assert row["rows_per_s"] > 0 and row["efficiency_wall"] > 0
        assert row["efficiency_compute"] >= 0.8
        assert row["shard_value_skew"] < 1.5


def test_scaling_bench_one_rank_in_process(capsys):
    from duckdb_parquet_parser_tpu_torch import scaling_bench

    assert scaling_bench.main(["--rows", "3000", "--reps", "2", "--device",
                               "cpu", "--backend", "gloo"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [row["devices"] for row in out["table"]] == [1]
    assert out["table"][0]["efficiency_wall"] == 1.0


def test_distributed_init_from_env(monkeypatch):
    """The env contract: DPQ_COORDINATOR first, then torchrun's variables,
    else no group (the group itself is mocked)."""
    import torch.distributed as dist

    from duckdb_parquet_parser_tpu_torch.parallel import mesh as M

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for v in ("DPQ_COORDINATOR", "DPQ_NUM_PROCESSES", "DPQ_PROCESS_ID",
              "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    assert M.distributed_init_from_env("gloo") is False and not calls

    for k, v in (("RANK", "1"), ("WORLD_SIZE", "4"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(k, v)
    assert M.distributed_init_from_env("nccl") is True
    backend, kw = calls.pop()
    assert backend == "nccl" and kw["init_method"] == "env://"

    monkeypatch.setenv("DPQ_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("DPQ_NUM_PROCESSES", "4")
    monkeypatch.setenv("DPQ_PROCESS_ID", "2")
    assert M.distributed_init_from_env("gloo") is True
    backend, kw = calls.pop()
    assert (backend, kw["init_method"], kw["world_size"], kw["rank"]) == (
        "gloo", "tcp://10.0.0.1:1234", 4, 2)
    with pytest.raises(ValueError):
        M.distributed_init_from_env("mpi")


def test_backend_and_device_are_explicit():
    from duckdb_parquet_parser_tpu_torch.parallel import mesh as M

    with pytest.raises(ValueError, match="CUDA device"):
        M.make_mesh("cpu", "nccl")
    with pytest.raises(ValueError, match="backend"):
        M.make_mesh("cpu", "auto")
    mesh = M.make_mesh("cpu", "gloo")
    assert (mesh.rank, mesh.size, mesh.backend, mesh.member) == (
        0, 1, "gloo", True)
    with pytest.raises(ValueError, match="whole group"):
        M.survivor_mesh(M.PagesMesh(0, 1, mesh.device, object(), "gloo",
                                    (0,)), [0])


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
def test_closing_group_ends_a_group_of_one(raises):
    """An entry point's group ends with it, also the group of one that
    `make_mesh` forms itself, and also when the block raises."""
    import torch.distributed as dist

    from duckdb_parquet_parser_tpu_torch.parallel import mesh as M

    with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
        with M.closing_group():
            assert M.make_mesh("cpu", "gloo").size == 1
            assert dist.is_initialized()
            if raises:
                raise RuntimeError("a command failed")
    assert not dist.is_initialized()
    M.close_group()  # nothing alive: nothing to do
