"""The program's front doors that a traffic mix can name as its `route`.

Each route is a file of its own, `routes/<route>.py`, found by the name the
mix gives, as a metric's reader is: a new route is a new file.  The file's
`Route` class is made as `Route(cfg, table, seed, device)`, and with
`mesh=` (a `parallel/mesh.PagesMesh`) where the cell runs one process a
card.  It has:

- `setup(pool)`: load and warm up every query of the pool (on every rank);
- `op(q)`: what one query calls; only the public entry points of
  `duckdb_parquet_parser_tpu_torch` are called in the window;
- `close()`: drop the program's state before the reference runs;

and, where it needs them:

- `prepare(pool)`: on rank 0 alone, before the other ranks open anything:
  what they then find made (files, built kernels);
- `answer(ans)`: a kept answer as the check reads it (`check.compare`).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def find(name: str):
    """The `Route` class of routes/<name>.py; a name with no file ends the
    run with a message."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no route {name!r}: no file {path.name} in "
                         f"{HERE.name}/")
    spec = importlib.util.spec_from_file_location(
        f"portbench_route_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Route


def warm_file(cfg: dict, seed: int) -> Path:
    """The cell's table cut to its first row group, written to a file of its
    own: set-up warms each query of the pool on it."""
    from portbench import datagen

    small = dict(cfg, rows=min(int(cfg["row_group_rows"]), int(cfg["rows"])))
    return datagen.make(small, seed, datagen.data_path(
        dict(cfg, name=cfg["name"] + ".warm"), seed)).path


def build_walks(patterns, *, like: bool) -> None:
    """Builds the stream matcher for every register-machine pattern of the
    pool in one `nvcc` run (each query's own build would be one run each);
    a built kernel is found again in the program's build directory, by
    every process that asks for the same patterns."""
    from duckdb_parquet_parser_tpu_torch.ops import scan as pscan
    from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher

    tuples = []
    for p in patterns:
        pats, dfas = pscan.prepare_patterns([p], like=like)
        irs, _dfa = pscan.resolve_matchers(pats, dfas)
        if irs:
            tuples.append(irs)
    stream_matcher.prepare(tuples)
