"""Elastic recovery for the scan fleet.

Counterpart of `duckdb_parquet_parser_tpu.parallel.elastic`; `FleetState`
is a copy (numpy only).  Scan jobs are stateless (decode + match over
immutable page shards), so "failure recovery" is pure re-assignment: when a
rank drops out, its page shard re-partitions across the survivors and those
pages re-run — no in-flight state to checkpoint.  The inverted-index build,
the only long-running stateful op, checkpoints via utils.checkpoints.

Every rank runs the same control flow over the same global results, so
every rank's `fault_hook` must name the same failed ranks.  The re-run is
a collective of the survivors (`mesh.run_on_survivors`); a rank that
"failed" sits it out and receives the merged counts like everybody else.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .partition import PageAssignment, assign_balanced


@dataclass
class FleetState:
    """Tracks device liveness + page ownership across failures."""

    weights: np.ndarray                 # [N] per-page cost (bytes)
    n_devices: int
    failed: set = field(default_factory=set)
    assignment: PageAssignment | None = None

    def __post_init__(self):
        if self.assignment is None:
            self.assignment = assign_balanced(self.weights, self.n_devices)

    @property
    def live_devices(self) -> list[int]:
        return [d for d in range(self.n_devices) if d not in self.failed]

    def mark_failed(self, device: int) -> np.ndarray:
        """Marks a device dead; returns the page ids needing re-run.

        The orphaned pages re-partition over the remaining devices balanced
        by weight; ownership of unaffected pages is preserved (idempotent
        scan tasks mean only the orphans re-execute).
        """
        if device in self.failed:
            return np.zeros(0, np.int64)
        self.failed.add(device)
        live = self.live_devices
        if not live:
            raise RuntimeError("all devices failed")
        orphans = np.nonzero(self.assignment.device_of == device)[0]
        if len(orphans):
            sub = assign_balanced(self.weights[orphans], len(live))
            remap = np.array(live, np.int64)
            self.assignment.device_of[orphans] = remap[sub.device_of]
            self.assignment.order = np.argsort(
                self.assignment.device_of, kind="stable"
            )
        return orphans

    def loads(self) -> np.ndarray:
        out = np.zeros(self.n_devices, np.int64)
        np.add.at(out, self.assignment.device_of, self.weights.astype(np.int64))
        return out


def elastic_distributed_scan(mesh, batch, dfa, *, negate: bool = False,
                             fleet: FleetState | None = None,
                             fault_hook=None, max_rounds: int | None = None):
    """Failure-detecting distributed scan: run sharded, DETECT failed
    ranks, re-run only the orphaned page shards on the survivors, merge.

    `batch` must be padded + rank-major ordered (rank d owns the contiguous
    page rows [d*pp, (d+1)*pp)) — the layout ScanEngine.scan produces.
    `fault_hook(result, round) -> iterable of failed rank ids` is the
    detection seam: production detection is a health probe or a
    collective's error; tests inject failures through it.  Orphan re-runs
    are bit-identical to the original shards (scan tasks are stateless),
    so the merged result equals a clean run.

    Returns (result, report) where report = {"failed": [...], "rounds": k,
    "reruns": pages re-executed}.
    """
    from .mesh import run_on_survivors
    from .partition import pad_pages, take_pages
    from .pipeline import distributed_scan

    n_dev = mesh.size
    pp = batch.n_pages // n_dev
    if fleet is None:
        weights = batch.arrays["page_payload_len"].astype(np.int64)
        fleet = FleetState(
            weights=weights, n_devices=n_dev,
            assignment=PageAssignment(
                order=np.arange(batch.n_pages),
                device_of=np.arange(batch.n_pages) // pp,
            ),
        )

    result = distributed_scan(mesh, batch, dfa, negate=negate)
    report = {"failed": [], "rounds": 0, "reruns": 0}
    rnd = 0
    while fault_hook is not None:
        if max_rounds is not None and rnd >= max_rounds:
            break
        failed = set(map(int, fault_hook(result, rnd))) - set(report["failed"])
        if not failed:
            break
        rnd += 1
        report["rounds"] = rnd
        orphan_parts = []
        for d in sorted(failed):
            report["failed"].append(d)
            orphan_parts.append(fleet.mark_failed(d))
        orphans = np.concatenate(orphan_parts) if orphan_parts else np.zeros(0, np.int64)
        # drop empty pad pages from the re-run (they contribute nothing)
        orphans = orphans[batch.arrays["page_num_values"][orphans] > 0]
        if not len(orphans):
            continue
        report["reruns"] += int(len(orphans))
        live = fleet.live_devices
        sub = pad_pages(take_pages(batch, orphans), len(live))

        def rerun(sub_mesh):
            res = distributed_scan(sub_mesh, sub, dfa, negate=negate)
            return res.match_counts, res.value_counts

        sub_counts, sub_values = run_on_survivors(mesh, live, rerun)
        result.match_counts[orphans] = sub_counts[:len(orphans)]
        result.value_counts[orphans] = sub_values[:len(orphans)]
        keep = result.page_gid >= 0
        result.totals = np.array(
            [int(result.match_counts[keep].sum()),
             int(result.value_counts[keep].sum())], np.int64)
    return result, report
