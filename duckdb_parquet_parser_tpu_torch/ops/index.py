"""Chunked inverted index over a string column.

The port's own copy of `duckdb_parquet_parser_tpu/ops/index.py` (numpy and
the native host library only, function for function).

Reproduces the reference prototype's semantics exactly (reference:
src/main.cpp:10-38): stream the column's non-null values in global row order;
each entry appends `str(len) + value` to the current chunk; the chunk is
flushed BEFORE an append once its size has reached `chunk_size` (so chunks
overshoot by one entry — a quirk preserved deliberately), and every emitted
row records its chunk id in a row->chunk map (rows with no emission keep 0).

The heavy work (decode, lengths, positions) is vectorized; the inherently
sequential chunk-boundary recurrence collapses to O(#chunks · log n) via
searchsorted over the entry-size prefix sum — no per-entry host loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def entry_sizes(lens: np.ndarray) -> np.ndarray:
    """Size each entry contributes: ASCII decimal digits of len, plus len
    (reference: src/main.cpp:30 `std::to_string(len) + value`)."""
    lens = np.asarray(lens, np.int64)
    # digit count via searchsorted over the powers of ten — integer-exact
    # (str(0) is one character, matching std::to_string)
    thresholds = 10 ** np.arange(1, 19, dtype=np.int64)
    digits = np.searchsorted(thresholds, lens, side="right") + 1
    return digits + lens


def chunk_boundaries(sizes: np.ndarray, chunk_size: int) -> np.ndarray:
    """First-entry index of every chunk (always starts with 0).

    Entry i opens a new chunk iff the accumulated size of entries since the
    previous flush had already reached `chunk_size` *before* appending i.
    """
    n = len(sizes)
    prefix = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=prefix[1:])
    starts = [0]
    base = 0
    while True:
        i = int(np.searchsorted(prefix, base + chunk_size, side="left"))
        if i > n:
            break
        starts.append(i)
        base = prefix[i]
    # a flush can also trigger exactly at the end; the reference would clear
    # and bump chunk_id only when another entry arrives — so drop a trailing
    # empty chunk start at n
    if starts[-1] == n:
        starts.pop()
    return np.asarray(starts, np.int64)


@dataclass
class ChunkedIndex:
    num_rows: int
    chunk_size: int
    positions: np.ndarray       # [M] global row of each emitted entry
    lens: np.ndarray            # [M]
    chunk_of_entry: np.ndarray  # [M]
    tuple_to_chunk: np.ndarray  # [num_rows], 0 where no emission
    chunk_starts: np.ndarray    # [num_chunks] first entry of each chunk

    @property
    def num_chunks(self) -> int:
        # reference prints chunk_id + 1 (src/main.cpp:35)
        return int(self.chunk_of_entry[-1]) + 1 if len(self.chunk_of_entry) else 1

    def materialize_chunk(self, chunk_id: int, chars: np.ndarray,
                          offs: np.ndarray) -> bytes:
        """Builds one chunk's byte payload (length-prefixed values)."""
        lo = int(self.chunk_starts[chunk_id])
        hi = (
            int(self.chunk_starts[chunk_id + 1])
            if chunk_id + 1 < len(self.chunk_starts)
            else len(self.lens)
        )
        parts = []
        for k in range(lo, hi):
            ln = int(self.lens[k])
            off = int(offs[k])
            parts.append(str(ln).encode())
            parts.append(chars[off : off + ln].tobytes())
        return b"".join(parts)


def build_index(positions, lens, num_rows: int, chunk_size: int = 4096) -> ChunkedIndex:
    """Builds the chunked index from the (row-ordered) emission stream."""
    positions = np.asarray(positions, np.int64)
    lens = np.asarray(lens, np.int64)
    sizes = entry_sizes(lens)
    starts = chunk_boundaries(sizes, chunk_size)
    # chunk id of each entry: +1 at every chunk start, running sum
    bump = np.zeros(len(lens) + 1, np.int64)
    bump[starts] = 1
    chunk_of = np.cumsum(bump[:-1]) - 1
    t2c = np.zeros(num_rows, np.int64)
    t2c[positions] = chunk_of
    return ChunkedIndex(
        num_rows=num_rows,
        chunk_size=chunk_size,
        positions=positions,
        lens=lens,
        chunk_of_entry=chunk_of,
        tuple_to_chunk=t2c,
        chunk_starts=starts,
    )


def build_index_for_column(reader, column: str, chunk_size: int = 4096,
                           engine: str = "native") -> ChunkedIndex:
    """End-to-end: prescan + decode the column, then build the index.

    Fast path (engine="native"): the pre-scan's pack pass emits the index
    emission stream directly (PS_INDEX: per-value global row + length, one
    cache-hot C++ sweep, no char copies), and the boundary plan is a second
    native O(M) sweep (dpq_index_plan) — the whole build is two native
    calls.  engine="numpy" keeps the vectorized host path (the golden
    model the native plan is parity-tested against).  Emission sets are
    identical: the iterator's silently-dropped OOB dictionary indices
    (reference: src/reader/parquet_reader.cpp:436-439) are NULL in column
    space, so neither path emits them."""
    from ..host import bindings
    from ..host.reader import _string_stream

    if engine == "native":
        # Fused one-call build (round 5): header walk + emission + boundary
        # plan in one native pass.  Unsupported value encodings fall back to
        # the emission route below (engine="emission" forces it).
        try:
            dims, arrays = bindings.native_index_build(
                reader._h, reader.find_column(column), reader.num_rows(),
                chunk_size,
            )
        except bindings.NativeError as e:
            if "unsupported" not in str(e):
                raise
            engine = "emission"
        else:
            m = int(dims["m"])
            return ChunkedIndex(
                num_rows=int(dims["num_rows"]),
                chunk_size=chunk_size,
                positions=arrays["positions"][:m],
                lens=arrays["lens"][:m],
                chunk_of_entry=arrays["chunk_of_entry"][:m],
                tuple_to_chunk=arrays["tuple_to_chunk"],
                chunk_starts=arrays["chunk_starts"],
            )
    if engine == "emission":
        batch = reader.prescan(
            column, flags=bindings.PS_INDEX | bindings.PS_RUNS_ONLY)
        dims, arrays = bindings.native_index_plan(
            batch.arrays["idx_emit_pos"], batch.arrays["idx_emit_len"],
            reader.num_rows(), chunk_size,
        )
        m = int(dims["m"])
        return ChunkedIndex(
            num_rows=int(dims["num_rows"]),
            chunk_size=chunk_size,
            positions=arrays["positions"][:m],
            lens=arrays["lens"][:m],
            chunk_of_entry=arrays["chunk_of_entry"][:m],
            tuple_to_chunk=arrays["tuple_to_chunk"],
            chunk_starts=arrays["chunk_starts"],
        )

    batch = reader.prescan(
        column,
        flags=(bindings.PS_HOST_STRINGS | bindings.PS_STR_VIEWS
               | bindings.PS_COLUMN),
    )
    if int(batch.dims.get("col_mat", 0)):
        total = int(batch.dims["total_rows"])
        valid = batch.arrays["col_valid"][:total].view(bool)
        pos = np.flatnonzero(valid)
        lens = batch.arrays["col_lens"][:total][pos]
        return build_index(pos, lens, reader.num_rows(), chunk_size)
    pos, lens, _offs, _chars = _string_stream(batch)
    return build_index(pos, lens, reader.num_rows(), chunk_size)


def emissions_for_rg(reader, column: str, rg: int) -> tuple[np.ndarray, np.ndarray]:
    """One row group's index emission stream as (GLOBAL row positions,
    lens) — the per-block unit of partial checkpointing (the native
    PS_INDEX pack emits it in one C++ sweep)."""
    from ..host import bindings

    batch = reader.prescan(column, rg, rg + 1,
                           flags=bindings.PS_INDEX | bindings.PS_RUNS_ONLY)
    raw_pos = batch.arrays["idx_emit_pos"]
    raw_len = batch.arrays["idx_emit_len"]
    keep = raw_len >= 0
    base = sum(int(g["num_rows"])
               for g in reader.metadata()["row_groups"][:rg])
    return (raw_pos[keep] + base).astype(np.int64), \
        raw_len[keep].astype(np.int64)
