"""`ScanEngine(path, mesh).scan(column, like, like=True, negate=...)` on an
engine that each rank opened once: the one-shot LIKE scan of the file with
its pages sharded over the group, one process a card.  Every rank prescans
the whole file, partitions its pages by bytes (`assign_balanced_equal`),
reorders them, uploads and walks its own shard, and the all-reduce and
all-gathers end the scan; every rank gets the whole answer.

The answer lists the pages in partition order, pad pages (gid -1) among
them; `answer` puts it in file page order for the check."""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from duckdb_parquet_parser_tpu_torch.parallel.mesh import broadcast_arrays

from portbench.routes import build_walks, warm_file


class Route:
    def __init__(self, cfg: dict, table, seed: int, device, mesh):
        self.cfg, self.table, self.device = cfg, table, device
        self.seed, self.mesh = seed, mesh
        self.engine = None
        self.warm = None

    def prepare(self, pool) -> None:
        """Rank 0: the pool's K1 kernels built, and a file of one row group
        made, before the other ranks look for them."""
        if self.device.type == "cuda":
            build_walks(sorted({q.like for q in pool}), like=True)
        self.warm = warm_file(self.cfg, self.seed)

    def setup(self, pool) -> None:
        if self.device.type == "cuda" and self.warm is None:
            # the other ranks find the kernels that rank 0's `prepare` built
            build_walks(sorted({q.like for q in pool}), like=True)
        # every query of the pool once on the file of one row group, then
        # one query on the whole file: every rank makes the same calls
        warm = broadcast_arrays(self.mesh, str(self.warm), 0)
        small = ScanEngine(warm, self.mesh)
        for q in pool:
            small.scan(self.cfg["column"], q.like, like=True, negate=q.negate)
        self.engine = ScanEngine(str(self.table.path), self.mesh)
        self.op(pool[0])

    def op(self, q):
        return self.engine.scan(self.cfg["column"], q.like, like=True,
                                negate=q.negate)

    def answer(self, ans):
        """`ans` in file page order: pad pages (gid -1) dropped, the rest
        ordered by gid.  Page ids that are not the table's, each once, are
        left for the check to find; so are arrays of unequal lengths."""
        gid = np.asarray(ans.page_gid)
        counts = np.asarray(ans.match_counts)
        values = np.asarray(ans.value_counts)
        if not gid.shape == counts.shape == values.shape:
            return ans
        keep = np.flatnonzero(gid >= 0)
        keep = keep[np.argsort(gid[keep], kind="stable")]
        return replace(ans, page_gid=gid[keep], match_counts=counts[keep],
                       value_counts=values[keep])

    def close(self) -> None:
        self.engine = None
