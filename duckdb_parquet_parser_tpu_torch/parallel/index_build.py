"""Distributed chunked-index build: SHARDED device decode -> boundary plan ->
salted, block-pipelined all-to-all entry shuffle -> per-rank chunk
ownership.

Counterpart of `duckdb_parquet_parser_tpu.parallel.index_build`, over a
`PagesMesh` (one process per device, parallel/mesh.py).

Pipeline:
  1. PER-SHARD DECODE (device): each rank turns its page shard's raw payload
     into the (row, len) emission stream — definition levels, PLAIN length
     prefixes, and dictionary lengths (the dictionary kernel's gather entry,
     K2's `dict_lookup`, over a [1, DN] table of the entry lengths) all
     decode on the rank's device; the host only compacts the gathered
     per-shard masks.  Page blocks pipeline: block i+1's decode is
     dispatched before block i's results are fetched.
  2. chunk boundaries come from the greedy prefix-sum recurrence (exact
     flush-before-append semantics, ops/index.py) on the host;
  3. chunk -> rank ownership is SALTED (parallel/shuffle.py): hot chunks
     split across ranks so one key can neither overload a rank nor inflate
     the padded all-to-all capacity;
  4. entries exchange to their owners in fixed-capacity blocks: the
     collective for block i is in flight while the host packs block i+1;
  5. owners hold (row, len, chunk) triples for their chunks — chunk text
     materializes on demand via ChunkedIndex.materialize_chunk.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..host import bindings
from ..host.batch import to_tensor
from ..ops import decode as _decode
from ..ops.expand import take2d
from ..ops.index import ChunkedIndex, build_index
from ..ops.kernels import dict_lookup
from ..ops.strings import string_offsets
from ..utils.config import get_config
from ..utils.metrics import get_metrics
from .elastic import FleetState
from .mesh import PagesMesh, run_on_survivors, to_global
from .partition import pad_pages
from .pipeline import exchange_entries, ragged_exchange_entries
from .shuffle import (
    ExchangePlan,
    RaggedExchangePlan,
    SaltedOwnership,
    salted_chunk_owners,
)


@dataclass
class DistributedIndexResult:
    index: ChunkedIndex
    chunk_owners: np.ndarray          # [num_chunks] primary owner rank
    salted: SaltedOwnership           # full (possibly multi-rank) ownership
    received: list[np.ndarray]        # per rank: [k, 3] (row, len, chunk)
    shuffle_bytes: int                # payload bytes moved by the exchange
    skew_factor: float                # max/mean rank load (bytes)
    exchange_capacity: int            # rows per (src,dst) bucket (padded) or
                                      # per destination (ragged), per block
    n_exchange_blocks: int
    exchange_mode: str = "padded"     # "ragged" | "padded"
    exchange_planned_slots: int = 0   # total receive slots the exchange
                                      # shapes reserve (capacity-ratio
                                      # numerator vs true entry count)


def _emissions_local(core, payload, dict_lens, *, vmax, nn_cap, max_def):
    """Per-page emission decode of one page shard on its device: (lens
    [n, V] i32, emit [n, V] bool) with values addressed by position within
    the page.  `payload` is None for a batch without PLAIN pages,
    `dict_lens` ([1, DN] i32) for one without a dictionary."""
    nonnull, nn_idx = _decode.decode_levels(core, max_def, vmax)
    gidx = nn_idx.clamp(0, nn_cap - 1)
    if payload is not None:
        _offs, lens_rank = string_offsets(payload, core["page_nn"], nn_cap)
        plens = take2d(lens_rank, gidx)
    else:
        plens = torch.zeros(nonnull.shape, dtype=torch.int32,
                            device=nonnull.device)
    is_dict = (core["page_kind"] == 1)[:, None]
    if dict_lens is None:
        return plens.to(torch.int32), nonnull & ~is_dict
    dict_idx, ok = _decode.decode_dict_indices(core, nn_idx, nn_cap,
                                               nonnull=nonnull)
    g = (core["page_dict_base"][:, None] + dict_idx.clamp(min=0)).clamp(
        0, dict_lens.shape[1] - 1).to(torch.int32).contiguous()
    dlens = dict_lookup.dict_lookup(dict_lens, g)[0]
    emit = torch.where(is_dict, nonnull & ok, nonnull)
    return torch.where(is_dict, dlens, plens).to(torch.int32), emit


def sharded_emissions(mesh: PagesMesh, batch, block_pages: int = 0,
                      fleet=None, fault_hook=None):
    """Decodes the (row, len) emission stream with per-shard device decode.

    Returns (pos [M] i64 absolute rows, lens [M] i64), in row order.
    `block_pages` > 0 splits the batch into page blocks whose decodes
    pipeline (block i+1 dispatched before block i's results are fetched).

    Elastic: `fault_hook(block_idx, lens, emit) -> iterable of failed rank
    ids` is the detection seam (same contract as elastic_distributed_scan,
    the same answer on every rank); a failed rank's block shard re-decodes
    on the surviving ranks — decode is stateless, so the recomputed block
    is bit-identical."""
    n_dev = mesh.size
    if block_pages <= 0:
        block_pages = batch.n_pages
    block_pages = max(-(-block_pages // n_dev) * n_dev, n_dev)

    padded = pad_pages(batch, block_pages)
    arrays = padded.arrays
    has_payload = "payload" in arrays
    has_dict = int(padded.dims.get("dict_n", 0)) > 0
    dict_lens = (to_tensor(arrays["dict_lens"], mesh.device,
                           dtype=np.int32)[None].contiguous()
                 if has_dict else None)
    core_keys = [k for k in _decode.DECODE_ARRAYS if k in arrays]
    dims = dict(vmax=padded.vmax, nn_cap=padded.nn_cap,
                max_def=padded.max_def)

    def decode_block(sub: PagesMesh, lo: int, pad_to: int):
        """This rank's shard of the block of pages [lo, lo + block_pages),
        zero-padded to `pad_to` pages, decoded on the rank's device."""
        hi = min(lo + block_pages, padded.n_pages)
        pp = pad_to // sub.size
        a, b = lo + sub.rank * pp, min(lo + (sub.rank + 1) * pp, hi)
        a = min(a, b)

        def rows(v):
            v = np.asarray(v)[a:b]
            return np.pad(v, [(0, pp - (b - a))] + [(0, 0)] * (v.ndim - 1))

        core = {k: to_tensor(rows(arrays[k]), sub.device) for k in core_keys}
        payload = (to_tensor(rows(arrays["payload"]), sub.device)
                   if has_payload else None)
        return _emissions_local(core, payload, dict_lens, **dims)

    starts = list(range(0, padded.n_pages, block_pages))
    pos_parts, len_parts = [], []
    row_start = arrays["page_row_start"]
    ahead = decode_block(mesh, starts[0], block_pages) if starts else None
    for blk, lo in enumerate(starts):
        lens_d, emit_d = ahead
        if blk + 1 < len(starts):
            ahead = decode_block(mesh, starts[blk + 1], block_pages)
        lens = to_global(mesh, lens_d)
        emit = to_global(mesh, emit_d)
        if fault_hook is not None:
            failed = set(map(int, fault_hook(blk, lens, emit)))
            if failed and fleet is not None:
                for d in failed:
                    fleet.mark_failed(d)
                live = fleet.live_devices
                sub_bp = max(-(-block_pages // len(live)) * len(live),
                             len(live))

                def redo(sub_mesh, lo=lo, sub_bp=sub_bp):
                    l2, e2 = decode_block(sub_mesh, lo, sub_bp)
                    return to_global(sub_mesh, l2), to_global(sub_mesh, e2)

                lens, emit = run_on_survivors(mesh, live, redo)
                lens, emit = lens[:block_pages], emit[:block_pages]
        pages, rows_ = np.nonzero(emit[:len(row_start) - lo])
        pos_parts.append(row_start[lo + pages] + rows_)
        len_parts.append(lens[pages, rows_].astype(np.int64))
    pos = np.concatenate(pos_parts) if pos_parts else np.zeros(0, np.int64)
    lens = np.concatenate(len_parts) if len_parts else np.zeros(0, np.int64)
    order = np.argsort(pos, kind="stable")
    return pos[order], lens[order]


def distributed_index_build(mesh, reader, column: str,
                            chunk_size: int = 4096,
                            block_pages: int = 8192,
                            entry_block: int = 262144,
                            salt_threshold: float = 2.0,
                            fleet=None,
                            fault_hook=None) -> DistributedIndexResult:
    n_devices = mesh.size
    batch = reader.prescan(column, pad_strings=8, flags=bindings.PS_PAYLOAD)

    if fault_hook is not None and fleet is None:
        fleet = FleetState(
            weights=np.ones(max(batch.n_pages, 1), np.int64),
            n_devices=n_devices,
        )

    # 1. sharded decode (device) -> emission stream (elastic: a failed
    # device's block shard re-decodes on the survivors — see
    # sharded_emissions)
    metrics = get_metrics()
    with metrics.timed("index_emissions", pages=batch.n_pages):
        pos, lens = sharded_emissions(mesh, batch, block_pages=block_pages,
                                      fleet=fleet, fault_hook=fault_hook)

    # 2. boundary plan (host, exact reference semantics)
    index = build_index(pos, lens, reader.num_rows(), chunk_size)

    # 3. salted ownership (hot in bytes OR entry count)
    chunk_bytes = _chunk_bytes(index, lens)
    chunk_entries = np.zeros(index.chunk_starts.shape[0], np.int64)
    np.add.at(chunk_entries, index.chunk_of_entry, 1)
    salted = salted_chunk_owners(chunk_bytes, n_devices, salt_threshold,
                                 chunk_entries=chunk_entries)
    dst = salted.entry_destinations(index.chunk_of_entry)
    src = (np.arange(len(dst)) * n_devices) // max(len(dst), 1)
    payload = np.stack([pos, lens, index.chunk_of_entry], axis=1).astype(np.int64)

    # 4. block-pipelined exchange at ONE compiled capacity: the collective for
    # block i is in flight while the host packs block i+1.  Default mode is
    # the exact-size ragged exchange (planned slots ~= max/mean over
    # DESTINATIONS); "padded" keeps the dense [D, D, cap] buckets.  Every
    # rank gathers every destination's rows, so `received` is the same list
    # on every rank.
    cfg = get_config()
    slack = cfg.exchange_capacity_slack
    ragged = cfg.exchange_mode != "padded"
    m = len(dst)
    blocks = [(lo, min(lo + entry_block, m)) for lo in range(0, m, entry_block)]
    in_flight = []
    shuffle_bytes = 0
    t_exchange = time.perf_counter()
    if ragged:
        plans = [
            RaggedExchangePlan.plan(dst[lo:hi], src[lo:hi], n_devices)
            for lo, hi in blocks
        ]
        send_cap = max((p.send_cap for p in plans), default=1)
        cap = max((p.recv_cap for p in plans), default=1)
        for (lo, hi), plan in zip(blocks, plans):
            plan.send_cap, plan.recv_cap = send_cap, cap
            shuffle_bytes += n_devices * send_cap * payload.shape[1] * 8
            in_flight.append(
                ragged_exchange_entries(mesh, plan, payload[lo:hi],
                                        fill=-1, block=False))
        received = [[] for _ in range(n_devices)]
        for recv, plan in zip(in_flight, plans):
            rows = to_global(mesh, recv.wait())
            for d in range(n_devices):
                received[d].append(rows[d, : int(plan.recv_total[d])])
        planned_slots = n_devices * cap * len(blocks)
    else:
        plans = [
            ExchangePlan.plan(dst[lo:hi], src[lo:hi], n_devices,
                              capacity_slack=slack)
            for lo, hi in blocks
        ]
        cap = max((p.capacity for p in plans), default=1)
        for (lo, hi), plan in zip(blocks, plans):
            plan.capacity = cap
            send = plan.build_send_buffer(payload[lo:hi], src[lo:hi], fill=-1)
            shuffle_bytes += send.nbytes
            in_flight.append(exchange_entries(mesh, send, block=False))

        received = [[] for _ in range(n_devices)]
        for recv in in_flight:
            rows = to_global(mesh, recv.wait()).reshape(n_devices, -1, 3)
            for d in range(n_devices):
                got = rows[d]
                received[d].append(got[got[:, 0] >= 0])
        planned_slots = n_devices * n_devices * cap * len(blocks)
    received = [
        np.concatenate(parts) if parts else np.zeros((0, 3), np.int64)
        for parts in received
    ]
    metrics.emit("index_exchange", seconds=time.perf_counter() - t_exchange,
                 blocks=len(blocks), bytes=int(shuffle_bytes), entries=m,
                 planned_slots=int(planned_slots),
                 mode="ragged" if ragged else "padded")

    loads = np.zeros(n_devices, np.int64)
    for d in range(n_devices):
        loads[d] = received[d][:, 1].sum() if len(received[d]) else 0
    mean = loads.mean() if loads.size else 0.0
    return DistributedIndexResult(
        index=index,
        chunk_owners=salted.primary,
        salted=salted,
        received=received,
        shuffle_bytes=int(shuffle_bytes),
        skew_factor=float(loads.max() / mean) if mean else 1.0,
        exchange_capacity=cap,
        n_exchange_blocks=len(blocks),
        exchange_mode="ragged" if ragged else "padded",
        exchange_planned_slots=int(planned_slots),
    )


def _chunk_bytes(index: ChunkedIndex, lens: np.ndarray) -> np.ndarray:
    """Per-chunk payload bytes (value bytes + ASCII length prefixes — the
    reference's chunk-string append, src/main.cpp:30)."""
    prefix = np.char.str_len(
        np.char.mod("%d", lens.astype(np.int64))
    ).astype(np.int64)
    entry_bytes = lens + prefix
    out = np.zeros(index.chunk_starts.shape[0], np.int64)
    np.add.at(out, index.chunk_of_entry, entry_bytes)
    return out