"""The port stands alone: in a fresh interpreter that refuses to import
jax, jaxlib, pyarrow or the JAX package `duckdb_parquet_parser_tpu`, every
port module imports, and a resident scan runs on the CPU over the port's
own native library, built from `duckdb_parquet_parser_tpu_torch/host/native/`."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "pyarrow", "duckdb_parquet_parser_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, {root!r})
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
    assert n >= 12, proc.stdout
