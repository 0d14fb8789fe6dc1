"""`ScanEngine(path).scan_streaming(column, regex, negate=...)` on a fresh
engine each query: the one-shot device scan of a file that is not on the
card (it sits in the OS page cache)."""

from __future__ import annotations

from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine

from portbench import datagen
from portbench.routes import build_walks, warm_file


class Route:
    def __init__(self, cfg: dict, table: datagen.Table, seed: int, device):
        self.cfg, self.table, self.device = cfg, table, device
        self.seed = seed

    def setup(self, pool) -> None:
        if self.device.type == "cuda":
            build_walks(sorted({q.regex for q in pool}), like=False)
        # every query of the pool once on a file of one row group, which
        # compiles and caches its matchers, then one query on the whole file
        warm = warm_file(self.cfg, self.seed)
        for q in pool:
            ScanEngine(str(warm)).scan_streaming(
                self.cfg["column"], q.regex, negate=q.negate,
                device=self.device)
        self.op(pool[0])

    def op(self, q):
        return ScanEngine(str(self.table.path)).scan_streaming(
            self.cfg["column"], q.regex, negate=q.negate, device=self.device)

    def close(self) -> None:
        pass
