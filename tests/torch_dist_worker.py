"""One rank of the port's sharded paths on the CPU over gloo: a child
process of tests/test_torch_distributed.py.  It imports the port only (JAX
and the JAX package are blocked), joins the group through the file store it
is given, runs its cases (tests/torch_dist_cases.py), holds every array
against the JAX package's answers (an .npz the parent wrote) and writes
{case id: "ok" or what differs} as JSON.  An alarm ends a rank that hangs.

Usage: python tests/torch_dist_worker.py RANK SIZE STORE JOB.json
"""

from __future__ import annotations

import importlib.abc
import json
import signal
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIFETIME_S = 170  # a rank that outlives this is killed by its own alarm


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib",
                                  "duckdb_parquet_parser_tpu"):
            raise ImportError("blocked: " + name)
        return None


def port_namespace() -> types.SimpleNamespace:
    """The port's functions under the names the cases use."""
    from duckdb_parquet_parser_tpu_torch.host import bindings
    from duckdb_parquet_parser_tpu_torch.host.reader import (
        ParquetReader,
        _string_stream,
    )
    from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
    from duckdb_parquet_parser_tpu_torch.ops.index import build_index
    from duckdb_parquet_parser_tpu_torch.ops.regex import compile_pattern
    from duckdb_parquet_parser_tpu_torch.parallel.elastic import (
        elastic_distributed_scan,
    )
    from duckdb_parquet_parser_tpu_torch.parallel.index_build import (
        distributed_index_build,
        sharded_emissions,
    )
    from duckdb_parquet_parser_tpu_torch.parallel.partition import pad_pages
    from duckdb_parquet_parser_tpu_torch.parallel.pipeline import (
        distributed_decode,
        distributed_scan,
        exchange_entries,
        ragged_exchange_entries,
    )
    from duckdb_parquet_parser_tpu_torch.parallel.shuffle import (
        ExchangePlan,
        RaggedExchangePlan,
        balanced_chunk_owners,
    )
    from duckdb_parquet_parser_tpu_torch.utils.config import (
        EngineConfig,
        set_config,
    )

    return types.SimpleNamespace(**locals())


def main(argv) -> int:
    rank, size, store, job_path = int(argv[0]), int(argv[1]), argv[2], argv[3]
    signal.alarm(LIFETIME_S)
    sys.meta_path.insert(0, _Block())
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from tests import torch_dist_cases as cases

    torch.set_num_threads(1)
    job = json.loads(Path(job_path).read_text())
    from duckdb_parquet_parser_tpu_torch.parallel.mesh import (
        GROUP_TIMEOUT,
        make_mesh,
    )

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=size, timeout=GROUP_TIMEOUT)
    mesh = make_mesh("cpu", "gloo")
    assert (mesh.rank, mesh.size) == (rank, size)
    got = cases.run_cases(port_namespace(), mesh, size, job["paths"],
                          job["ids"])
    want = cases.load(job["expected"])
    verdict = {cid: cases.compare(got[cid], want[cid]) for cid in job["ids"]}
    Path(job["out"] + f".{rank}").write_text(json.dumps(verdict))
    dist.barrier()
    dist.destroy_process_group()
    assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
