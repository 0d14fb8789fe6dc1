"""`ResidentColumn.scan(like, like=True, negate=...)` on a column that set-up
made resident: "load once, query many"."""

from __future__ import annotations

from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine

from portbench import datagen
from portbench.routes import build_walks


class Route:
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
