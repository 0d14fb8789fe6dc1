"""Page partitioning and device-friendly re-layout.

The port's own copy of `duckdb_parquet_parser_tpu/parallel/partition.py`
(numpy only, function for function; "device" below is a rank of the
`PagesMesh`, parallel/mesh.py).

Turns a pre-scan DecodeBatch into mesh-shardable arrays: every per-page array
is padded so n_pages divides the device count, and entry-major string tables
are re-laid out page-major ([N, nn_cap, pitch]) so a single PartitionSpec
("pages") shards the entire batch.  Page->device assignment is contiguous by
default or hash-based (the "DP over pages" partitioner of SURVEY.md §2.1);
byte-balanced assignment handles skew (hot pages / fat dictionaries).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..host.batch import DecodeBatch, _PER_PAGE_ARRAYS


def pad_pages(batch: DecodeBatch, multiple: int) -> DecodeBatch:
    """Pads the batch with empty pages so n_pages % multiple == 0.

    Padded pages have num_values == 0 (masked out everywhere) and gid == -1.
    """
    n = batch.n_pages
    target = -(-n // multiple) * multiple
    if target == n:
        return batch
    pad = target - n
    arrays = dict(batch.arrays)
    for name in _PER_PAGE_ARRAYS:
        if name not in arrays:
            continue
        a = arrays[name]
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        arrays[name] = np.pad(a, widths)
    if "page_gid" in arrays:
        arrays["page_gid"][n:] = -1
    if "page_dict_base" in arrays:
        arrays["page_dict_base"][n:] = 0
    if "str_nn_start" in arrays:
        last = arrays["str_nn_start"][-1]
        arrays["str_nn_start"] = np.concatenate(
            [arrays["str_nn_start"], np.full(pad, last, np.int64)]
        )
    dims = dict(batch.dims)
    dims["n_pages"] = target
    return DecodeBatch(dims, arrays)


def strings_page_major(batch: DecodeBatch) -> tuple[np.ndarray, np.ndarray]:
    """Re-lays the PLAIN string table page-major.

    Returns (chars [N, nn_cap, pitch] u8, lens [N, nn_cap] i32); rows beyond a
    page's entry count are zero.  Dictionary tables stay global (they are
    replicated — small by construction).
    """
    n, cap = batch.n_pages, batch.nn_cap
    pitch = int(batch.dims.get("str_pitch", 0))
    chars = np.zeros((n, cap, max(pitch, 1)), np.uint8)
    lens = np.zeros((n, cap), np.int32)
    if pitch == 0 or "str_padded" not in batch.arrays:
        return chars, lens
    nn_start = batch.arrays["str_nn_start"]
    counts = np.diff(nn_start)
    page_of = np.repeat(np.arange(n), counts)
    rank = np.arange(len(page_of)) - np.repeat(nn_start[:-1], counts)
    chars[page_of, rank] = batch.arrays["str_padded"]
    lens[page_of, rank] = batch.arrays["str_lens"]
    return chars, lens


@dataclass
class PageAssignment:
    """Which device owns each page (permutation layout for shard_map)."""

    order: np.ndarray      # [N] page indices in device-major order
    device_of: np.ndarray  # [N] owning device per original page

    @property
    def n_devices(self) -> int:
        return int(self.device_of.max()) + 1 if len(self.device_of) else 1


def assign_contiguous(n_pages: int, n_devices: int) -> PageAssignment:
    device_of = (np.arange(n_pages) * n_devices) // max(n_pages, 1)
    return PageAssignment(order=np.arange(n_pages), device_of=device_of)


def assign_balanced(weights: np.ndarray, n_devices: int) -> PageAssignment:
    """Greedy byte-balanced assignment (skew handling): heaviest pages first
    onto the lightest device, then device-major ordering."""
    n = len(weights)
    device_of = np.zeros(n, np.int64)
    load = np.zeros(n_devices, np.int64)
    for p in np.argsort(-np.asarray(weights, np.int64), kind="stable"):
        d = int(np.argmin(load))
        device_of[p] = d
        load[d] += int(weights[p])
    order = np.argsort(device_of, kind="stable")
    return PageAssignment(order=order, device_of=device_of)


def assign_balanced_equal(weights: np.ndarray, n_devices: int) -> PageAssignment:
    """Byte-balanced assignment under the shard_map constraint that every
    device owns EXACTLY n/n_devices pages (n must divide; pad_pages first —
    pad pages weigh 0): heaviest page first onto the lightest non-full
    device.  This is what ScanEngine.scan(mesh) uses so contiguous shards
    carry near-equal byte loads."""
    n = len(weights)
    assert n % n_devices == 0, "pad_pages before balancing"
    cap = n // n_devices
    device_of = np.zeros(n, np.int64)
    load = np.zeros(n_devices, np.int64)
    slots = np.zeros(n_devices, np.int64)
    for p in np.argsort(-np.asarray(weights, np.int64), kind="stable"):
        open_devs = np.nonzero(slots < cap)[0]
        d = int(open_devs[np.argmin(load[open_devs])])
        device_of[p] = d
        load[d] += int(weights[p])
        slots[d] += 1
    order = np.argsort(device_of, kind="stable")
    return PageAssignment(order=order, device_of=device_of)


def reorder_pages(batch: DecodeBatch, order: np.ndarray) -> DecodeBatch:
    """Permutes pages into device-major order (per-page arrays only; global
    string/dict tables are indexed through per-page offsets and stay put)."""
    arrays = dict(batch.arrays)
    for name in _PER_PAGE_ARRAYS:
        if name in arrays:
            arrays[name] = arrays[name][order]
    if "str_nn_start" in arrays:
        # per-page entry counts follow the permutation; rebuild the prefix
        counts = np.diff(batch.arrays["str_nn_start"])[order]
        arrays["str_nn_start"] = np.concatenate([[0], np.cumsum(counts)])
        arrays["_str_entry_order"] = _entry_permutation(
            batch.arrays["str_nn_start"], order
        )
        for nm in ("str_lens", "str_offs"):
            if nm in arrays:
                arrays[nm] = arrays[nm][arrays["_str_entry_order"]]
        if "str_padded" in arrays:
            arrays["str_padded"] = arrays["str_padded"][arrays["_str_entry_order"]]
    return DecodeBatch(dict(batch.dims), arrays)


def _entry_permutation(nn_start: np.ndarray, order: np.ndarray) -> np.ndarray:
    counts = np.diff(nn_start)
    parts = [np.arange(nn_start[p], nn_start[p + 1]) for p in order]
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def take_pages(batch: DecodeBatch, page_ids: np.ndarray) -> DecodeBatch:
    """Sub-batch holding only `page_ids` (in the given order) — the orphan
    re-run unit of elastic recovery.  Per-page arrays subset; global
    string/dict tables stay whole (per-page offsets keep indexing them)."""
    page_ids = np.asarray(page_ids, np.int64)
    sub = reorder_pages(batch, page_ids)
    sub.dims["n_pages"] = int(len(page_ids))
    return sub
