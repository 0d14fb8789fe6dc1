"""The sharded scan pipeline: decode, regex match and the index entry
exchange over a `PagesMesh` (parallel/mesh.py), one process per device.

Counterpart of `duckdb_parquet_parser_tpu.parallel.pipeline`.  Everything
per-page shards along the mesh: rank r owns the contiguous page rows
[r * pp, (r + 1) * pp) of the padded batch, which every rank holds on the
host, and uploads only those.  Dictionaries and the per-dictionary-entry
match bits replicate (they are small by construction: pages are ~1 KB,
dictionaries at most a fifth of the non-null values).  The collectives are
an `all_reduce` for global totals, `all_gather` at the result boundary
(`mesh.to_global`) and the `all_to_all_single` of the index entry exchange;
they are the library's (NCCL or gloo), as they were the compiler's in the
reference.

The local step is the single-device one: the resident layout of
`ops/scan.resident_buckets` and `device_scan_step` on the rank's rows — the
stream matcher (kernel K1) over the buckets with PLAIN pages, the
dictionary kernel's fused count (K2's `dict_count`) over the buckets with
dictionary pages, the dictionary entries matched on the host.  The
reference's cache of compiled steps and its matrix-unit walk are mechanisms
of its machine and have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import decode as _decode
from ..ops import scan as _scan
from . import shuffle
from .mesh import PagesMesh, all_reduce_sum, to_global


@dataclass
class DistributedScanResult:
    page_gid: np.ndarray
    match_counts: np.ndarray
    value_counts: np.ndarray
    totals: np.ndarray  # [2] global (matches, values), all-reduced

    def pruned_pages(self) -> np.ndarray:
        keep = self.page_gid >= 0
        return self.page_gid[keep & (self.match_counts == 0)]

    def surviving_pages(self) -> np.ndarray:
        keep = self.page_gid >= 0
        return self.page_gid[keep & (self.match_counts > 0)]


def shard_bounds(mesh: PagesMesh, n_pages: int) -> tuple[int, int]:
    """[lo, hi): the page rows of this rank."""
    if n_pages % mesh.size:
        raise ValueError(f"{n_pages} pages do not divide over {mesh.size} "
                         "ranks: pad_pages first")
    pp = n_pages // mesh.size
    return mesh.rank * pp, (mesh.rank + 1) * pp


def distributed_scan(mesh: PagesMesh, batch, dfa, *,
                     negate: bool = False) -> DistributedScanResult:
    """Runs the regex page-pruning scan sharded over `mesh`.

    `batch` must be page-padded to a multiple of the mesh size
    (parallel.partition.pad_pages) and prescanned with PS_PAYLOAD
    (pad_strings > 0 so dictionary tables are packed).  Pad pages count 0
    matches of 0 values."""
    if "payload" not in batch.arrays:
        raise ValueError("distributed_scan needs a PS_PAYLOAD batch")
    lo, hi = shard_bounds(mesh, batch.n_pages)
    shard = batch.slice_pages(lo, hi)
    irs, walk_dfa = _scan.resolve_matchers([dfa.pattern], [dfa])
    buckets, _split = _scan.resident_buckets(shard, mesh.device)
    counts, values = _scan.scan_buckets(shard, buckets, irs, walk_dfa, [dfa],
                                        negate, mesh.device)
    counts, values = counts[0], values[0]
    totals = all_reduce_sum(mesh, torch.tensor(
        [int(counts.sum()), int(values.sum())], dtype=torch.int64))
    return DistributedScanResult(
        page_gid=batch.arrays["page_gid"].copy(),
        match_counts=to_global(mesh, counts),
        value_counts=to_global(mesh, values),
        totals=totals.astype(np.int64),
    )


# ── sharded column decode ────────────────────────────────────────────────────


def distributed_decode(mesh: PagesMesh, batch):
    """Fixed-width column decode sharded over the mesh: each rank decodes
    its page shard on its device (`ops/decode.decode_fixed_device`; on a
    dictionary column the lookup is the dictionary kernel's gather entry,
    one launch); an all-reduced checksum validates the collective path.
    Returns (planes: list of [N, V] i32 page-major, nonnull [N, V] bool,
    checksum int).  The checksum is the sum of the first plane's valid
    cells, wrapped to int32 as the reference's 32-bit sum wraps."""
    lo, hi = shard_bounds(mesh, batch.n_pages)
    shard = batch.slice_pages(lo, hi)
    planes, nonnull = _decode.decode_fixed_device(
        shard.arrays, shard.plain_planes, batch.dict_planes, shard.bool_bits,
        max_def=batch.max_def, out_len=batch.vmax, nn_len=batch.nn_cap,
        mode=batch.mode, device=mesh.device)
    local = torch.where(nonnull, planes[0], 0).sum(dtype=torch.int64)
    total = int(all_reduce_sum(mesh, local.reshape(1))[0])
    checksum = (total + 2**31) % 2**32 - 2**31
    return ([to_global(mesh, p) for p in planes], to_global(mesh, nonnull),
            checksum)


# ── index entry exchange ─────────────────────────────────────────────────────


def exchange_entries(mesh: PagesMesh, send_buffer: np.ndarray,
                     block: bool = True):
    """Runs the padded all-to-all: send_buffer [D, D, cap, ...]
    (source-major, the same on every rank) -> received rows per
    destination, [D * D * cap, ...] destination-major on every rank.

    block=False returns the exchange in flight (`shuffle.PendingExchange`)
    without waiting — the caller overlaps the collective with packing the
    next block and later passes `pending.wait()` to `mesh.to_global`."""
    pending = shuffle.all_to_all_exchange(mesh, send_buffer[mesh.rank])
    return to_global(mesh, pending.wait()) if block else pending


def ragged_exchange_entries(mesh: PagesMesh, plan, payload: np.ndarray,
                            fill=-1, block: bool = True):
    """Runs one exact-size exchange block per RaggedExchangePlan: packs
    `payload` rows into the destination-major send layout, moves them with
    `all_to_all_single` and its split sizes, and returns [D, recv_cap,
    ...]; rows [0, plan.recv_total[d]) of shard d are the valid receives,
    source-major.  block=False: as `exchange_entries`."""
    send = plan.build_send_buffer(payload, fill=fill)
    pending = shuffle.ragged_exchange(mesh, send[mesh.rank], plan.send_sizes,
                                      plan.recv_cap, fill)
    return to_global(mesh, pending.wait()) if block else pending
