"""The port's sharded paths (duckdb_parquet_parser_tpu_torch/parallel/,
`ScanEngine(mesh=...)`) against the JAX package's on a mesh of the same
size, with exact equality of every result array.

One rank runs in this process (gloo, a group of one) against
`make_mesh(1)`; 2 and 4 CPU ranks run as child processes over gloo
(tests/torch_dist_worker.py, which imports the port only) against
`make_mesh(2)` / `make_mesh(4)` of the JAX package's virtual CPU mesh, with
Pallas in interpret mode as its own tests run it.  This process computes
the JAX answers and hands them to the children as an .npz.  The children
meet through a file store under the test's temporary directory, run under
a timeout and are killed when it runs out (`parallel/mesh.run_processes`);
a child's non-zero exit fails its cases with its stderr.
"""

from __future__ import annotations

import json
import os
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from duckdb_parquet_parser_tpu_torch.parallel.mesh import run_processes
from tests import fixtures
from tests import torch_dist_cases as cases
from tests.torch_dist_worker import port_namespace

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 150


def reference_namespace() -> types.SimpleNamespace:
    from duckdb_parquet_parser_tpu.host import bindings
    from duckdb_parquet_parser_tpu.host.reader import (
        ParquetReader,
        _string_stream,
    )
    from duckdb_parquet_parser_tpu.models.scan import ScanEngine
    from duckdb_parquet_parser_tpu.ops.index import build_index
    from duckdb_parquet_parser_tpu.ops.regex import compile_pattern
    from duckdb_parquet_parser_tpu.parallel.elastic import (
        elastic_distributed_scan,
    )
    from duckdb_parquet_parser_tpu.parallel.index_build import (
        distributed_index_build,
        sharded_emissions,
    )
    from duckdb_parquet_parser_tpu.parallel.partition import pad_pages
    from duckdb_parquet_parser_tpu.parallel.pipeline import (
        distributed_decode,
        distributed_scan,
        exchange_entries,
        ragged_exchange_entries,
    )
    from duckdb_parquet_parser_tpu.parallel.shuffle import (
        ExchangePlan,
        RaggedExchangePlan,
        balanced_chunk_owners,
    )
    from duckdb_parquet_parser_tpu.utils.config import (
        EngineConfig,
        set_config,
    )

    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def paths(tmp_path_factory) -> dict:
    """The fixtures of tests/test_distributed.py: a PLAIN and a dictionary
    string file, and a multi-row-group dictionary INT64 column."""
    from duckdb_parquet_parser_tpu.host.schema import ParquetType
    from duckdb_parquet_parser_tpu.host.writer import (
        ColumnSpec,
        ParquetWriter,
    )

    d = tmp_path_factory.mktemp("torch_dist")
    out = {}
    for kind, seed, uniq in (("plain", 5, None), ("dict", 6, 13)):
        out[kind] = fixtures.strings_file(
            d / f"{kind}.parquet", np.random.default_rng(seed), n=1800,
            null_p=0.2, n_unique=uniq)
    rng = np.random.default_rng(17)
    out["k"] = str(d / "mrg.parquet")
    w = ParquetWriter(out["k"], [ColumnSpec("k", ParquetType.INT64,
                                            optional=True)])
    for rg in range(3):
        n = 1200
        vals = (rng.permutation(30)[rng.integers(0, 30, n)] + rg * 100) * 11
        w.write_row_group({"k": (vals, (rng.random(n) > 0.15).astype(
            np.uint8))})
    w.close()
    return out


def _reference_answers(n: int, paths: dict) -> dict:
    from duckdb_parquet_parser_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return cases.run_cases(reference_namespace(), make_mesh(n), n, paths,
                           cases.case_ids(n))


@pytest.fixture(scope="module")
def one_rank(paths) -> dict:
    """{case id: verdict} of one rank in this process."""
    from duckdb_parquet_parser_tpu_torch.parallel.mesh import make_mesh

    want = _reference_answers(1, paths)
    got = cases.run_cases(port_namespace(), make_mesh("cpu", "gloo"), 1,
                          paths, cases.case_ids(1))
    return {cid: cases.compare(got[cid], want[cid]) for cid in want}


def _child_ranks(n: int, paths: dict, tmp: Path) -> dict:
    """{case id: verdict}, the same on every rank, of `n` child ranks."""
    want = _reference_answers(n, paths)
    expected = tmp / f"expected_{n}.npz"
    cases.save(expected, want)
    job = tmp / f"job_{n}.json"
    out = tmp / f"verdict_{n}.json"
    job.write_text(json.dumps({"paths": paths, "ids": cases.case_ids(n),
                               "expected": str(expected), "out": str(out)}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    ends = run_processes(
        [[sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
          str(rank), str(n), str(tmp / f"store_{n}"), str(job)]
         for rank in range(n)], CHILD_TIMEOUT_S, cwd=str(tmp), env=env)
    for rank, end in enumerate(ends):
        assert end.returncode == 0, (f"rank {rank} of {n} failed:\n"
                                     f"{end.err[-4000:]}")
    verdicts = [json.loads(Path(f"{out}.{rank}").read_text())
                for rank in range(n)]
    assert all(v == verdicts[0] for v in verdicts), verdicts
    return verdicts[0]


@pytest.fixture(scope="module")
def two_ranks(paths, tmp_path_factory) -> dict:
    return _child_ranks(2, paths, tmp_path_factory.mktemp("ranks2"))


@pytest.fixture(scope="module")
def four_ranks(paths, tmp_path_factory) -> dict:
    return _child_ranks(4, paths, tmp_path_factory.mktemp("ranks4"))


@pytest.mark.parametrize("cid", cases.case_ids(1))
def test_one_rank_equals_reference(one_rank, cid):
    assert one_rank[cid] == "ok", one_rank[cid]


@pytest.mark.parametrize("cid", cases.case_ids(2))
def test_two_ranks_equal_reference(two_ranks, cid):
    assert two_ranks[cid] == "ok", two_ranks[cid]


@pytest.mark.parametrize("cid", cases.case_ids(4))
def test_four_ranks_equal_reference(four_ranks, cid):
    assert four_ranks[cid] == "ok", four_ranks[cid]


def test_pad_pages_need_no_walk(paths):
    """A shard of a dictionary column holds pad pages (PLAIN by kind, no
    values): its buckets hold no page to walk, so the stream matcher is not
    launched for them, and the pad pages count 0 of 0."""
    from duckdb_parquet_parser_tpu_torch.ops import scan

    ns = port_namespace()
    batch = ns.ParquetReader(paths["dict"]).prescan(
        "s", pad_strings=8,
        flags=ns.bindings.PS_HOST_STRINGS | ns.bindings.PS_PAYLOAD)
    padded = ns.pad_pages(batch, 8)
    assert padded.n_pages > batch.n_pages
    buckets, _split = scan.resident_buckets(padded, "cpu")
    assert [b["has_plain"] for b in buckets] == [False] * len(buckets)
    assert any(b["has_dict"] for b in buckets)
    dfa = ns.compile_pattern("alpha")
    counts, values = scan.scan_buckets(padded, buckets, *scan.resolve_matchers(
        ["alpha"], [dfa]), [dfa], True, "cpu")
    assert (counts[0, batch.n_pages:] == 0).all()
    assert (values[0, batch.n_pages:] == 0).all()
