"""The port stands alone: in a fresh interpreter that refuses to import
jax, jaxlib, pyarrow or the JAX package `duckdb_parquet_parser_tpu`, every
port module imports, and a resident scan runs on the CPU over the port's
own native library, built from `duckdb_parquet_parser_tpu_torch/host/native/`
(a register-machine pattern and a table-DFA one); so do the decode entry
points, `matching_rows` of both kinds of pattern, the command line,
`ScanEngine.build_index`, a one-rank `distributed_scan`, the dry run's
first five sections and two routes of the benchmark program."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLOCK = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "pyarrow", "duckdb_parquet_parser_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, {root!r})
""")

SCRIPT = BLOCK + textwrap.dedent("""
    import duckdb_parquet_parser_tpu_torch as pkg
    from pathlib import Path
    pkg_dir = Path(pkg.__file__).resolve().parent

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)

    from duckdb_parquet_parser_tpu_torch.host import build
    from duckdb_parquet_parser_tpu_torch.host.schema import ParquetType
    from duckdb_parquet_parser_tpu_torch.host.writer import (
        ColumnSpec,
        ParquetWriter,
    )
    from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine

    path = {path!r}
    w = ParquetWriter(path, [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                        optional=True)])
    w.write_row_group({{"s": [b"special requests", None, b"quick fox",
                              b"", b"specially requested"] * 40}})
    w.write_row_group({{"s": [b"abc", b"def"] * 300}})
    w.close()
    col = ScanEngine(path).resident("s", device="cpu")
    res = col.scan("special.*requests")
    assert int(res.match_counts.sum()) == 40, res.match_counts
    assert int(res.value_counts.sum()) == 160 + 600, res.value_counts
    # a pattern outside the register-machine family: the table-DFA walk
    res = col.scan("(cial|ly)+ req", negate=True)
    assert int(res.match_counts.sum()) == 160 + 600 - 80, res.match_counts
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    lib = build.build_library()
    assert lib.name.startswith("libdpqhost_torch-"), lib
    assert build._NATIVE_DIR == pkg_dir / "host" / "native", build._NATIVE_DIR
    print("modules", len(names))
""")


def test_port_runs_without_jax(tmp_path):
    script = SCRIPT.format(root=str(ROOT), path=str(tmp_path / "s.parquet"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("modules")[1])
    assert n >= 23, proc.stdout


DECODE_SCRIPT = BLOCK + textwrap.dedent("""
    import numpy as np

    from duckdb_parquet_parser_tpu_torch.host.reader import ParquetReader
    from duckdb_parquet_parser_tpu_torch.host.schema import ParquetType
    from duckdb_parquet_parser_tpu_torch.host.writer import (
        ColumnSpec,
        ParquetWriter,
    )
    from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
    from duckdb_parquet_parser_tpu_torch.ops.delta import read_delta_column

    path = {path!r}
    rng = np.random.default_rng(3)
    k = rng.integers(0, 7, 900) * 1000003
    valid = rng.random(900) > 0.1
    words = [b"special requests", b"quick fox", b"", b"specially requested"]
    s = [words[int(i)] if v else None
         for i, v in zip(rng.integers(0, 4, 900), valid)]
    w = ParquetWriter(path, [ColumnSpec("k", ParquetType.INT64, optional=True),
                             ColumnSpec("x", ParquetType.DOUBLE),
                             ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                        optional=True)])
    x = rng.standard_normal(900)
    w.write_row_group({{"k": (k, valid.astype(np.uint8)), "x": x, "s": s}})
    w.close()
    reader = ParquetReader(path)
    col = reader.read_column("k")
    assert np.array_equal(col.valid, valid)
    assert np.array_equal(col.values[col.valid], k[valid])
    assert np.array_equal(reader.read_column("x").values.view(np.int64),
                          x.view(np.int64))
    rows = reader.read_rows("k", 100, 200)
    assert np.array_equal(rows.valid, valid[100:200])
    got = ScanEngine(path).matching_rows("s", "special.*requests",
                                         device="cpu")
    want = [i for i, v in enumerate(s) if v == words[0]]
    assert got.tolist() == want, (got[:8], want[:8])
    got = ScanEngine(path).matching_rows("s", "(cial|ly)+ req", device="cpu")
    want = [i for i, v in enumerate(s) if v in (words[0], words[3])]
    assert got.tolist() == want, (got[:8], want[:8])

    delta = ParquetReader({delta_path!r})
    d = read_delta_column(delta, "v", device="cpu")
    want = np.load({delta_values!r})
    assert np.array_equal(d.values, want) and bool(d.valid.all())
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("decoded", len(col.values), len(got), len(d.values))
""")


def test_port_decodes_without_jax(tmp_path):
    """`read_column`, `read_rows`, `matching_rows` and `read_delta_column`
    with the JAX package and pyarrow blocked; the DELTA_BINARY_PACKED file
    is written here, by pyarrow, before the blocked interpreter starts."""
    import numpy as np
    import pytest

    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(8)
    values = np.cumsum(rng.integers(-2**40, 2**40, 5000)).astype(np.int64)
    delta_path = tmp_path / "delta.parquet"
    pq.write_table(pa.table({"v": pa.array(values, pa.int64())}),
                   str(delta_path), use_dictionary=False, compression="none",
                   column_encoding={"v": "DELTA_BINARY_PACKED"},
                   data_page_size=4096)
    np.save(tmp_path / "values.npy", values)
    script = DECODE_SCRIPT.format(
        root=str(ROOT), path=str(tmp_path / "t.parquet"),
        delta_path=str(delta_path), delta_values=str(tmp_path / "values.npy"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split()[:1] == ["decoded"], proc.stdout


FRONT_DOOR_SCRIPT = BLOCK + textwrap.dedent("""
    import contextlib, io

    import numpy as np

    from duckdb_parquet_parser_tpu_torch import (
        bench,
        cli,
        dryrun,
        launch,
        scaling_bench,
    )
    from duckdb_parquet_parser_tpu_torch.host import bindings
    from duckdb_parquet_parser_tpu_torch.host.schema import ParquetType
    from duckdb_parquet_parser_tpu_torch.host.writer import (
        ColumnSpec,
        ParquetWriter,
    )
    from duckdb_parquet_parser_tpu_torch.models.scan import (
        ScanEngine,
        make_engine,
    )
    from duckdb_parquet_parser_tpu_torch.ops.regex import compile_pattern
    from duckdb_parquet_parser_tpu_torch.parallel.mesh import make_mesh
    from duckdb_parquet_parser_tpu_torch.parallel.partition import pad_pages
    from duckdb_parquet_parser_tpu_torch.parallel.pipeline import (
        distributed_scan,
    )

    path = {path!r}
    w = ParquetWriter(path, [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                        optional=True)])
    w.write_row_group({{"s": [b"special requests", None, b"quick fox",
                              b"", b"specially requested"] * 40}})
    w.write_row_group({{"s": [b"abc", b"def"] * 300}})
    w.close()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([path]) == 0
        assert cli.main([path, "--regex-column", "s", "--regex",
                         "special.*requests", "--engine", "torch",
                         "--device", "cpu", "--rows"]) == 0
        assert cli.main(["index", path, "s", "--chunk-size", "256"]) == 0
    text = out.getvalue()
    assert "Total data pages:" in text and "Total tuples: 800" in text
    assert "760 values, 40 matching 'special.*requests'" in text, text

    eng = ScanEngine(path)
    plain = eng.build_index("s", 256).index
    again = eng.build_index("s", 256, checkpoint_dir={ckpt!r}).index
    assert np.array_equal(plain.tuple_to_chunk, again.tuple_to_chunk)
    assert plain.num_chunks > 1

    mesh = make_mesh("cpu", "gloo")
    batch = eng.reader.prescan(
        "s", pad_strings=8,
        flags=bindings.PS_HOST_STRINGS | bindings.PS_PAYLOAD)
    res = distributed_scan(mesh, pad_pages(batch, 8),
                           compile_pattern("special.*requests"))
    assert res.totals.tolist() == [40, 760], res.totals
    sharded = make_engine(path, mesh=mesh)
    assert sharded.scan("s", "special.*requests").totals.tolist() == [40, 760]
    owned = sharded.build_index("s", 256)
    assert np.array_equal(owned.index.tuple_to_chunk, plain.tuple_to_chunk)
    assert len(owned.chunk_owners) == plain.num_chunks
    # the dry run's sections 1-5 on one rank: section 5 fails its only
    # rank, as the reference's does
    try:
        dryrun.dryrun_multichip(mesh)
    except RuntimeError as e:
        assert str(e) == "all devices failed", e
    else:
        raise AssertionError("the one-rank dry run passed section 5")

    # the benchmark's routes over fixtures that are not files
    bench.ROUNDS = 1
    b = bench.Bench("cpu", 1)
    bench.bigpage_route(b, 3000)
    bench.delta_route(b, 3000)
    assert b.out["scan_bigpage_rows_per_s"] > 0, b.out
    assert b.out["decode_delta_i64_rows_per_s"] > 0, b.out
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("front door", plain.num_chunks)
""")


def test_port_front_door_runs_without_jax(tmp_path):
    """`cli.main`, `ScanEngine.build_index` (plain and checkpointed), a
    one-rank `distributed_scan` / `ScanEngine(mesh=...)` over gloo, the
    one-rank dry run (`dryrun.dryrun_multichip`, which must stop in its
    section 5 as the reference's does) and the benchmark's big-page and
    delta routes, with the JAX package blocked
    (tests/test_torch_bench.py runs the whole benchmark so)."""
    script = FRONT_DOOR_SCRIPT.format(
        root=str(ROOT), path=str(tmp_path / "s.parquet"),
        ckpt=str(tmp_path / "ckpt"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split()[-3:-1] == ["front", "door"], proc.stdout
