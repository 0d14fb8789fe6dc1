"""The program's front doors that a traffic mix can name as its `route`: what
set-up loads and warms, and what one query calls.  Only the public entry
points of `duckdb_parquet_parser_tpu_torch` are called in the window."""

from __future__ import annotations

from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from duckdb_parquet_parser_tpu_torch.ops import scan as pscan
from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher

from . import datagen


def build_walks(patterns, *, like: bool) -> None:
    """Builds the stream matcher for every register-machine pattern of the
    pool in one `nvcc` run (each query's own build would be one run each);
    a built kernel is found again in the program's build directory."""
    tuples = []
    for p in patterns:
        pats, dfas = pscan.prepare_patterns([p], like=like)
        irs, _dfa = pscan.resolve_matchers(pats, dfas)
        if irs:
            tuples.append(irs)
    stream_matcher.prepare(tuples)


class ResidentScan:
    """`ResidentColumn.scan(like, like=True, negate=...)` on a column that
    set-up made resident: "load once, query many"."""

    def __init__(self, cfg: dict, table: datagen.Table, seed: int, device):
        self.cfg, self.table, self.device = cfg, table, device
        self.column = None

    def setup(self, pool) -> None:
        if self.device.type == "cuda" and self.table.encoding == "PLAIN":
            build_walks(sorted({q.like for q in pool}), like=True)
        self.column = ScanEngine(str(self.table.path)).resident(
            self.cfg["column"], self.device)
        for q in pool:
            self.op(q)

    def op(self, q):
        return self.column.scan(q.like, like=True, negate=q.negate)

    def close(self) -> None:
        self.column = None


class StreamingScan:
    """`ScanEngine(path).scan_streaming(column, regex, negate=...)` on a fresh
    engine each query: the one-shot device scan of a file that is not on the
    card (it sits in the OS page cache)."""

    def __init__(self, cfg: dict, table: datagen.Table, seed: int, device):
        self.cfg, self.table, self.device = cfg, table, device
        self.seed = seed

    def setup(self, pool) -> None:
        if self.device.type == "cuda":
            build_walks(sorted({q.regex for q in pool}), like=False)
        # every query of the pool once on a file of one row group, which
        # compiles and caches its matchers, then one query on the whole file
        small = dict(self.cfg, rows=min(int(self.cfg["row_group_rows"]),
                                        int(self.cfg["rows"])))
        warm = datagen.make(small, self.seed, datagen.data_path(
            dict(self.cfg, name=self.cfg["name"] + ".warm"), self.seed))
        for q in pool:
            ScanEngine(str(warm.path)).scan_streaming(
                self.cfg["column"], q.regex, negate=q.negate,
                device=self.device)
        self.op(pool[0])

    def op(self, q):
        return ScanEngine(str(self.table.path)).scan_streaming(
            self.cfg["column"], q.regex, negate=q.negate, device=self.device)

    def close(self) -> None:
        pass


ROUTES = {"resident_scan": ResidentScan, "streaming_scan": StreamingScan}
