"""Distributed exchange primitives: padded and exact-size all-to-all for
ragged entry streams, with capacity planning and skew-aware salting.

Counterpart of `duckdb_parquet_parser_tpu.parallel.shuffle`.  The host half
(`ExchangePlan`, `RaggedExchangePlan`, `_running_rank`,
`balanced_chunk_owners`, `SaltedOwnership`, `salted_chunk_owners`) is a
copy, numpy only, but for `SaltedOwnership.entry_destinations`, which
visits only the salted chunks.  The device half is `torch.distributed`'s
`all_to_all_single`: with equal splits for the padded plan, and with split
sizes for the exact-size plan.  The latter's receive is natively the
layout the reference's `ragged_all_to_all` gives, on every backend, so the
reference's `ragged_exchange_emulated`, `ragged_use_hlo` and the
`DPQ_RAGGED_EMULATE` switch (a portable emulation for backends without
that instruction) have no counterpart here.

The index build's shuffle moves variable-length entries between ranks.  The
padded plan buckets entries per (source, destination) pair at one common
capacity, which the host plans from true counts; heavy destinations can be
*salted* — split across several ranks — so one hot key cannot blow up the
padded capacity for everyone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .mesh import PagesMesh


@dataclass
class ExchangePlan:
    """Host-side plan for one padded all_to_all."""

    n_devices: int
    capacity: int              # entries per (src, dst) bucket
    send_slot: np.ndarray      # [L] slot of each local entry within its bucket
    send_dst: np.ndarray       # [L] destination device of each entry

    @classmethod
    def plan(cls, dst: np.ndarray, src_device: np.ndarray, n_devices: int,
             capacity_slack: float = 1.0) -> "ExchangePlan":
        """dst/src_device: per-entry device ids (global view)."""
        counts = np.zeros((n_devices, n_devices), np.int64)
        np.add.at(counts, (src_device, dst), 1)
        cap = int(np.ceil(counts.max() * capacity_slack)) if counts.size else 1
        cap = max(cap, 1)
        # slot of each entry within its (src,dst) bucket, in stream order
        key = src_device.astype(np.int64) * n_devices + dst
        slot = _running_rank(key)
        return cls(n_devices=n_devices, capacity=cap,
                   send_slot=slot, send_dst=dst.astype(np.int64))

    def build_send_buffer(self, payload: np.ndarray, src_device: np.ndarray,
                          fill=0) -> np.ndarray:
        """Packs per-entry payload rows into [n_dev(src-major), n_dev(dst),
        capacity, ...] ready to shard along axis 0.

        Raises on bucket overflow: a capacity_slack < 1 would otherwise
        silently lose entries.  (Skew is handled BEFORE planning by salting
        hot destinations — see salted_destinations — not by dropping.)"""
        d = self.n_devices
        if len(self.send_slot) and int(self.send_slot.max()) >= self.capacity:
            raise ValueError(
                f"exchange bucket overflow: slot {int(self.send_slot.max())} "
                f">= capacity {self.capacity} (capacity_slack too small)"
            )
        shape = (d, d, self.capacity) + payload.shape[1:]
        out = np.full(shape, fill, payload.dtype)
        out[src_device, self.send_dst, self.send_slot] = payload
        return out


@dataclass
class RaggedExchangePlan:
    """Host-side plan for one EXACT-SIZE exchange (jax.lax.ragged_all_to_all).

    Send layout (per SOURCE device s): entries contiguous, destination-major
    — the slice bound for destination d starts at input_offsets[s, d] and is
    send_sizes[s, d] rows long.  Receive layout (per DESTINATION device d):
    source-major contiguous — source s's rows land at output_offsets[s, d],
    so the valid rows are exactly [0, recv_total[d]) with no interior
    padding.  Planned slots are D x recv_cap (max destination total) per
    block, vs the dense plan's D x D x max-bucket: the padding ratio drops
    from max/mean over (src, dst) BUCKETS to max/mean over DESTINATIONS."""

    n_devices: int
    send_cap: int               # send rows per source shard (>= max total)
    recv_cap: int               # output rows per destination (>= max total)
    input_offsets: np.ndarray   # [D, D] i64: send slice starts (src-local)
    send_sizes: np.ndarray      # [D, D] i64: counts[src, dst]
    output_offsets: np.ndarray  # [D, D] i64: where src s lands on receiver d
    recv_total: np.ndarray      # [D] i64: valid received rows per dest
    send_slot: np.ndarray       # [L] position of each entry in its src shard
    send_src: np.ndarray        # [L] source device of each entry

    @classmethod
    def plan(cls, dst: np.ndarray, src_device: np.ndarray,
             n_devices: int) -> "RaggedExchangePlan":
        dst = np.asarray(dst, np.int64)
        src_device = np.asarray(src_device, np.int64)
        d = n_devices
        counts = np.zeros((d, d), np.int64)
        np.add.at(counts, (src_device, dst), 1)
        input_offsets = np.zeros((d, d), np.int64)
        input_offsets[:, 1:] = np.cumsum(counts, axis=1)[:, :-1]
        output_offsets = np.zeros((d, d), np.int64)
        output_offsets[1:, :] = np.cumsum(counts, axis=0)[:-1, :]
        send_tot = counts.sum(axis=1)
        recv_tot = counts.sum(axis=0)
        # entry position within its source shard: dest-major slice base +
        # rank within the (src, dst) pair (stream order)
        key = src_device * d + dst
        rank = _running_rank(key)
        slot = input_offsets[src_device, dst] + rank
        return cls(
            n_devices=d,
            send_cap=max(int(send_tot.max(initial=0)), 1),
            recv_cap=max(int(recv_tot.max(initial=0)), 1),
            input_offsets=input_offsets,
            send_sizes=counts,
            output_offsets=output_offsets,
            recv_total=recv_tot,
            send_slot=slot,
            send_src=src_device,
        )

    def build_send_buffer(self, payload: np.ndarray, fill=0) -> np.ndarray:
        """Packs per-entry payload rows into [D, send_cap, ...] ready to
        shard along axis 0 (destination-major within each source shard)."""
        shape = (self.n_devices, self.send_cap) + payload.shape[1:]
        out = np.full(shape, fill, payload.dtype)
        out[self.send_src, self.send_slot] = payload
        return out

    def planned_slots(self) -> int:
        """Total receive slots the compiled shape reserves (the capacity-
        ratio numerator; the dense plan's analog is D * D * capacity)."""
        return self.n_devices * self.recv_cap


def _running_rank(key: np.ndarray) -> np.ndarray:
    """Rank of each element among equal keys seen so far (stream order)."""
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    starts = np.concatenate([[0], np.nonzero(np.diff(sorted_key))[0] + 1])
    group_of = np.searchsorted(starts, np.arange(len(key)), side="right") - 1
    rank_sorted = np.arange(len(key)) - starts[group_of]
    rank = np.empty(len(key), np.int64)
    rank[order] = rank_sorted
    return rank


@dataclass
class PendingExchange:
    """One exchange in flight: `wait()` gives this rank's receive buffer
    once the collective has ended (the caller packs the next block
    meanwhile).  `send` keeps the send buffer alive until then."""

    work: object
    out: torch.Tensor
    send: torch.Tensor

    def wait(self) -> torch.Tensor:
        self.work.wait()
        return self.out


def _to_exchange(mesh: PagesMesh, rows: np.ndarray) -> torch.Tensor:
    """This rank's send rows where the backend moves them from: the host
    under gloo; under nccl the rank's card, reached through pinned
    memory."""
    t = torch.from_numpy(np.ascontiguousarray(rows))
    if mesh.backend == "gloo":
        return t
    return t.pin_memory().to(mesh.device, non_blocking=True)


def all_to_all_exchange(mesh: PagesMesh, send: np.ndarray) -> PendingExchange:
    """This rank's block [D, cap, ...] of the padded exchange -> received
    [D * cap, ...] rows, source-major: `all_to_all_single` with equal
    splits."""
    inp = _to_exchange(mesh, send.reshape((-1,) + send.shape[2:]))
    out = torch.empty_like(inp)
    work = dist.all_to_all_single(out, inp, group=mesh.group, async_op=True)
    return PendingExchange(work, out, inp)


def ragged_exchange(mesh: PagesMesh, send: np.ndarray, counts: np.ndarray,
                    recv_cap: int, fill) -> PendingExchange:
    """Exact-size exchange per RaggedExchangePlan: `all_to_all_single` with
    `input_split_sizes = counts[rank, :]` and `output_split_sizes =
    counts[:, rank]`, received into a [1, recv_cap, ...] buffer pre-filled
    with `fill`.  `send` is this rank's [send_cap, ...] shard; its rows are
    destination-major and contiguous because the plan's padding sits at
    the end, so the first `counts[rank].sum()` rows are what goes out.  The
    receive is natively the plan's layout: rows [0, recv_total[rank])
    valid, source-major, no interior padding."""
    r = mesh.rank
    inp = _to_exchange(mesh, send[:int(counts[r].sum())])
    out = torch.full((1, recv_cap) + tuple(send.shape[1:]), fill,
                     dtype=inp.dtype, device=inp.device)
    work = dist.all_to_all_single(
        out[0, :int(counts[:, r].sum())], inp,
        output_split_sizes=[int(c) for c in counts[:, r]],
        input_split_sizes=[int(c) for c in counts[r]],
        group=mesh.group, async_op=True)
    return PendingExchange(work, out, inp)


def balanced_chunk_owners(chunk_bytes: np.ndarray, n_devices: int) -> np.ndarray:
    """Skew-aware chunk->device ownership: greedy largest-first packing, so a
    few huge chunks (hot keys) do not overload one device."""
    owners = np.zeros(len(chunk_bytes), np.int64)
    load = np.zeros(n_devices, np.int64)
    for c in np.argsort(-np.asarray(chunk_bytes, np.int64), kind="stable"):
        d = int(np.argmin(load))
        owners[c] = d
        load[d] += int(chunk_bytes[c])
    return owners


@dataclass
class SaltedOwnership:
    """Chunk ownership with hot chunks split ("salted") across devices.

    A chunk whose byte load exceeds `salt_threshold x (total/n_devices)` is
    split into ceil(bytes / shard_target) salt shards, each balanced onto a
    device like an independent pseudo-chunk; its entries round-robin over
    those shards.  One hot key therefore cannot dominate any device's load
    OR any (src, dst) exchange bucket — without salting, the padded
    all_to_all capacity is set by the hottest destination and every bucket
    pays it (SURVEY.md §2.1 skew handling)."""

    owners: list            # per chunk: np.ndarray of owning devices (1 = cold)
    primary: np.ndarray     # [num_chunks] first owner (API compat)

    def entry_destinations(self, chunk_of_entry: np.ndarray) -> np.ndarray:
        """Destination device per entry (entries salt round-robin by their
        rank within the chunk).  A cold chunk's entries all go to its one
        owner, which is one gather for all of them; only the salted chunks
        are visited one by one (the reference visits every chunk, each
        with a compare over all entries: the same destinations)."""
        chunk_of_entry = np.asarray(chunk_of_entry)
        dst = self.primary[chunk_of_entry].astype(np.int64)
        salted = [c for c, devs in enumerate(self.owners) if len(devs) > 1]
        if salted:
            rank = _running_rank(chunk_of_entry.astype(np.int64))
            for c in salted:
                sel = chunk_of_entry == c
                devs = self.owners[c]
                dst[sel] = devs[rank[sel] % len(devs)]
        return dst


def salted_chunk_owners(chunk_bytes: np.ndarray, n_devices: int,
                        salt_threshold: float = 2.0,
                        chunk_entries: np.ndarray | None = None) -> SaltedOwnership:
    """Splits hot chunks into salt shards, then balances all shards greedily
    (largest first onto the lightest device).

    A chunk is hot when its BYTES exceed `salt_threshold x fair_bytes` (it
    would dominate one device's load) or its ENTRY COUNT exceeds
    `salt_threshold x fair_entries` (it would set the padded all_to_all
    capacity for every (src, dst) bucket)."""
    chunk_bytes = np.asarray(chunk_bytes, np.int64)
    total = int(chunk_bytes.sum())
    fair = max(total // max(n_devices, 1), 1)
    limit = int(salt_threshold * fair)
    shard_target = max(fair // 2, 1)
    if chunk_entries is not None:
        chunk_entries = np.asarray(chunk_entries, np.int64)
        # entry-hot chunks gate the padded all_to_all CAPACITY, whose fair
        # share is a (src, dst) BUCKET: total / n_devices^2
        fair_e = max(int(chunk_entries.sum()) // max(n_devices * n_devices, 1), 1)
        limit_e = int(salt_threshold * fair_e)

    salt_of = np.ones(len(chunk_bytes), np.int64)
    for c, b in enumerate(chunk_bytes):
        s_bytes = -(-int(b) // shard_target) if b > limit else 1
        s_entries = 1
        if chunk_entries is not None and chunk_entries[c] > limit_e:
            s_entries = -(-int(chunk_entries[c]) // max(fair_e // 2, 1))
        salt_of[c] = int(min(max(s_bytes, s_entries), n_devices))

    # heaviest chunks first; a salted chunk's shards go to the S lightest
    # DISTINCT devices (round-robin by entry rank needs them distinct or one
    # device would carry a multiple of its fair share of the hot bucket)
    load = np.zeros(n_devices, np.float64)
    owners: list[np.ndarray] = [np.zeros(0, np.int64)] * len(chunk_bytes)
    for c in np.argsort(-chunk_bytes, kind="stable"):
        s = int(salt_of[c])
        devs = np.argsort(load, kind="stable")[:s]
        owners[int(c)] = devs.astype(np.int64)
        load[devs] += chunk_bytes[c] / s
    return SaltedOwnership(
        owners=owners,
        primary=np.array([devs[0] for devs in owners], np.int64),
    )
