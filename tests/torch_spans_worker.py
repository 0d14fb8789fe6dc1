"""One rank of the port's sharded scan on the CPU over gloo, for
tests/test_torch_sharded_spans.py.  It imports the port only (JAX and the
JAX package are blocked), joins the group through the file store it is
given and runs `ScanEngine(path, mesh).scan` twice on one engine:

- with no profiler, the byte walk real: the answer, in file page order,
  and whether a span opened (`torch.profiler.record_function` called) or a
  counter moved;
- under a CPU profiler, the byte walk stood in for by zero hits (the plain
  CPU walk records some 30,000 profiler events a page): the `dpq.*` spans
  as (name, start us, end us), what the counters counted, and the bytes of
  each tensor the scan handed to `all_reduce_sum` and `to_global`.

It writes them as JSON to `<out>.<rank>`.  An alarm ends a rank that hangs.

Usage: python tests/torch_spans_worker.py RANK SIZE STORE JOB.json
"""

from __future__ import annotations

import json
import signal
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _no_walk(stream, plen, nn, irs, dfa, steps):
    import torch

    return torch.zeros((max(len(irs), 1), plen.shape[0]), dtype=torch.int32)


def _file_order(ans) -> dict:
    """The answer's pages in file order, pad pages (gid -1) dropped."""
    import numpy as np

    gid = np.asarray(ans.page_gid)
    keep = np.flatnonzero(gid >= 0)
    keep = keep[np.argsort(gid[keep], kind="stable")]
    return {"gid": gid[keep].tolist(),
            "match": np.asarray(ans.match_counts)[keep].tolist(),
            "values": np.asarray(ans.value_counts)[keep].tolist(),
            "totals": np.asarray(ans.totals).tolist()}


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    from tests.torch_dist_worker import LIFETIME_S, _Block

    rank, size, store, job_path = int(argv[0]), int(argv[1]), argv[2], argv[3]
    signal.alarm(LIFETIME_S)
    sys.meta_path.insert(0, _Block())
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
    from duckdb_parquet_parser_tpu_torch.ops import scan as pscan
    from duckdb_parquet_parser_tpu_torch.parallel import pipeline
    from duckdb_parquet_parser_tpu_torch.parallel.mesh import (
        GROUP_TIMEOUT,
        make_mesh,
    )
    from duckdb_parquet_parser_tpu_torch.utils import tracing

    torch.set_num_threads(1)
    job = json.loads(Path(job_path).read_text())
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=size, timeout=GROUP_TIMEOUT)
    mesh = make_mesh("cpu", "gloo")
    engine = ScanEngine(job["path"], mesh)

    def scan():
        return engine.scan(job["column"], job["like"], like=True,
                           negate=True)

    opened = []
    real = torch.profiler.record_function
    torch.profiler.record_function = lambda name: opened.append(name) \
        or real(name)
    before = tracing.counters()
    out = _file_order(scan())
    out["counters_moved"] = tracing.counters() != before
    torch.profiler.record_function = real
    out["opened"] = opened

    handed = []
    for name in ("all_reduce_sum", "to_global"):
        def collective(mesh, x, _fn=getattr(pipeline, name)):
            t = torch.as_tensor(x)
            handed.append(t.numel() * t.element_size())
            return _fn(mesh, x)
        setattr(pipeline, name, collective)
    pscan.walk_hits = _no_walk
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scan()
    out["counts"] = {k: v - before.get(k, 0)
                     for k, v in tracing.counters().items()}
    out["handed"] = handed
    out["spans"] = [(e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith("dpq.")]
    Path(f"{job['out']}.{rank}").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
