"""Seeded fixtures for the port's smoke run and benchmarks.

`lineitem` writes the same file as the reference benchmark's
`bench.gen_fixture` (TPC-H-lineitem-like: an `l_comment` string column of
five words each, 1% null, beside INT64/DOUBLE columns, 500,000-row row
groups); `dict_ints` the same file as its `bench.gen_dict_fixture` (a
dictionary-encoded INT64 column); `dict_strings` writes a
dictionary-encoded string column over several row groups, each with its own
distinct values.  These use the port's writer (host/writer.py) and return
the path, writing only when it does not exist.

`delta_planes` is not a file: the port's writer cannot write
DELTA_BINARY_PACKED pages, so it packs seeded int64 values with numpy into
the structure planes the PS_DELTA_RAW prescan emits, for machines without
another Parquet writer.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..host.schema import ParquetType
from ..host.writer import ColumnSpec, ParquetWriter

LINEITEM_WORDS = [
    b"carefully", b"furiously", b"quickly", b"slyly", b"blithely", b"requests",
    b"deposits", b"packages", b"accounts", b"theodolites", b"pending", b"final",
    b"special", b"express", b"regular", b"ironic", b"unusual", b"bold",
    b"among", b"across", b"above", b"sleep", b"haggle", b"nag", b"wake",
]
CITY_BASES = [b"san diego", b"san francisco", b"new york", b"new orleans",
              b"chicago", b"boston", b"seattle", b"denver"]


def lineitem(path, rows: int, seed: int = 2026) -> Path:
    """`rows` lineitem-like rows: l_quantity INT64, l_extendedprice DOUBLE,
    l_tax DOUBLE (10% null) and l_comment BYTE_ARRAY (1% null)."""
    path = Path(path)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w = ParquetWriter(
        str(path),
        [ColumnSpec("l_quantity", ParquetType.INT64),
         ColumnSpec("l_extendedprice", ParquetType.DOUBLE),
         ColumnSpec("l_tax", ParquetType.DOUBLE, optional=True),
         ColumnSpec("l_comment", ParquetType.BYTE_ARRAY, optional=True)],
        key_value={"pad": "x" * 512},
    )
    lens_of = np.array([len(x) for x in LINEITEM_WORDS])
    done = 0
    while done < rows:
        n = min(500_000, rows - done)
        pick = rng.integers(0, len(LINEITEM_WORDS), (n, 5))
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens_of[pick].sum(axis=1) + 4, out=offs[1:])
        chars = np.full(offs[-1], ord(" "), np.uint8)
        at = offs[:-1].copy()
        for k in range(5):
            for wi, word in enumerate(LINEITEM_WORDS):
                sel = pick[:, k] == wi
                if not sel.any():
                    continue
                wb = np.frombuffer(word, np.uint8)
                idx = at[sel][:, None] + np.arange(len(wb))[None, :]
                chars[idx.ravel()] = np.tile(wb, int(sel.sum()))
            at += lens_of[pick[:, k]] + 1
        valid = (rng.random(n) > 0.01).astype(np.uint8)
        valid_tax = (rng.random(n) > 0.10).astype(np.uint8)
        w.write_row_group({
            "l_quantity": rng.integers(1, 51, n),
            "l_extendedprice": rng.random(n) * 1e5,
            "l_tax": (rng.random(n) * 0.1, valid_tax),
            "l_comment": (offs, chars, valid),
        })
        done += n
    w.close()
    return path


def dict_strings(path, rows_per_rg: int, n_rg: int, distinct: int,
                 seed: int = 11) -> Path:
    """A `city` BYTE_ARRAY column (2% null), dictionary-encoded: row group
    `rg` draws from its own `distinct` values, so the concatenated
    dictionary holds n_rg * distinct entries."""
    path = Path(path)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w = ParquetWriter(str(path), [ColumnSpec("city", ParquetType.BYTE_ARRAY,
                                             optional=True)],
                      key_value={"pad": "x" * 512})
    for rg in range(n_rg):
        pool = [CITY_BASES[k % len(CITY_BASES)] + f"-{rg}{k}".encode()
                for k in range(distinct)]
        pick = rng.integers(0, distinct, rows_per_rg)
        valid = rng.random(rows_per_rg) > 0.02
        w.write_row_group({"city": [pool[int(k)] if v else None
                                    for k, v in zip(pick, valid)]})
    w.close()
    return path


def dict_ints(path, rows: int) -> Path:
    """A dictionary-heavy INT64 column `k` (100 distinct values, 5% nulls),
    500,000-row row groups, seed 7."""
    path = Path(path)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    w = ParquetWriter(str(path),
                      [ColumnSpec("k", ParquetType.INT64, optional=True)])
    done = 0
    while done < rows:
        n = min(500_000, rows - done)
        w.write_row_group({
            "k": (rng.integers(0, 100, n) * 1000003,
                  (rng.random(n) > 0.05).astype(np.uint8)),
        })
        done += n
    w.close()
    return path


# miniblock bit widths the delta fixture mixes, 0 (a constant run) to 64
DELTA_WIDTHS = (0, 1, 3, 7, 8, 13, 16, 24, 31, 32, 33, 40, 48, 57, 63, 64)


def delta_planes(seed: int, n_pages: int, values_per_page: int, *,
                 mb_values: int = 32, mb_per_block: int = 4,
                 ragged: bool = False):
    """Seeded int64 values, `values_per_page` a page (with `ragged`, some
    pages hold fewer), packed as DELTA_BINARY_PACKED miniblocks of mixed bit
    widths into the structure planes of a PS_DELTA_RAW prescan.

    Returns (dims, arrays, values, nn): `dims` holds `delta_mb_values`,
    `delta_mb_cap`, `delta_pitch`, `n_pages` and `nn_cap`; `arrays` holds
    `delta_bw`, `delta_cnt`, `delta_md_lo` / `delta_md_hi` [n_pages, mb_cap]
    int32, `delta_first_lo` / `delta_first_hi` [n_pages] int32 and
    `delta_bytes` [n_pages, mb_cap * pitch] u8; `values` is [n_pages, nn_cap]
    int64, zero past each page's `nn` values.  The values wrap around int64
    (steps of up to 64 bits), as the encoding allows.  A block of
    `mb_per_block` miniblocks shares one min-delta, the least delta of the
    block, as a writer computes it."""
    rng = np.random.default_rng(seed)
    u64 = np.uint64
    nn_cap = int(values_per_page)
    n_deltas = max(nn_cap - 1, 0)
    mbc = max(-(-n_deltas // mb_values), 1)
    mbc = -(-mbc // mb_per_block) * mb_per_block      # whole blocks
    n_blocks = mbc // mb_per_block
    nn = np.full(n_pages, nn_cap, np.int64)
    if ragged:
        nn -= (np.arange(n_pages) % 5) * min(7, max(nn_cap - 1, 0) // 4)

    # values: steps of a per-miniblock width on a per-block base step
    width = rng.choice(np.array(DELTA_WIDTHS), (n_pages, mbc))
    step = rng.integers(0, 2**64, (n_pages, mbc, mb_values), dtype=u64)
    shift = (64 - width).astype(u64)[:, :, None]
    step = np.where(width[:, :, None] == 0, u64(0),
                    step >> np.minimum(shift, u64(63)))
    base = rng.integers(-2**40, 2**40, (n_pages, n_blocks)).astype(np.int64)
    base[rng.random((n_pages, n_blocks)) < 0.2] = np.iinfo(np.int64).min + 3
    step = step + np.repeat(base, mb_per_block, axis=1).view(u64)[:, :, None]
    first = rng.integers(-2**63, 2**63 - 1, n_pages).astype(np.int64)
    values = np.empty((n_pages, 1 + mbc * mb_values), u64)
    values[:, 0] = first.view(u64)
    np.cumsum(step.reshape(n_pages, -1), axis=1, out=values[:, 1:])
    values[:, 1:] += first.view(u64)[:, None]
    values = values[:, :max(nn_cap, 1)]
    pos = np.arange(values.shape[1])[None, :]
    values = np.where(pos < nn[:, None], values, u64(0)).view(np.int64)

    # the writer's side: deltas, min-delta per block, width per miniblock
    deltas = np.zeros((n_pages, mbc * mb_values), u64)
    if n_deltas:
        deltas[:, :n_deltas] = np.diff(values.view(u64), axis=1)
    live = (np.arange(mbc * mb_values)[None, :] < (nn - 1)[:, None])
    signed = np.where(live, deltas.view(np.int64), np.iinfo(np.int64).max)
    md = signed.reshape(n_pages, n_blocks, -1).min(axis=2)
    block_live = live.reshape(n_pages, n_blocks, -1).any(axis=2)
    md = np.where(block_live, md, 0)
    md_mb = np.repeat(md, mb_per_block, axis=1)            # [P, mbc]
    packed = np.where(live, deltas - np.repeat(md_mb, mb_values,
                                               axis=1).view(u64), u64(0))
    packed = packed.reshape(n_pages, mbc, mb_values)
    cnt = live.reshape(n_pages, mbc, mb_values).sum(axis=2).astype(np.int32)
    top = packed.max(axis=2)
    bw = np.zeros((n_pages, mbc), np.int32)
    for k in range(64):
        bw += (top >> u64(k)) != 0
    md_mb = np.where(cnt > 0, md_mb, 0)

    # bit-pack LSB first into little-endian 64-bit words, `mb_values` words
    # a miniblock (room for width 64)
    words = np.zeros((n_pages * mbc, mb_values + 1), u64)
    rows = np.arange(n_pages * mbc)
    flat_bw = bw.reshape(-1).astype(np.int64)
    flat = packed.reshape(n_pages * mbc, mb_values)
    for j in range(mb_values):
        bitpos = j * flat_bw
        w0, sh = bitpos >> 6, (bitpos & 63).astype(u64)
        words[rows, w0] |= flat[:, j] << sh
        spill = np.where(sh > 0, flat[:, j] >> ((u64(64) - sh) & u64(63)),
                         u64(0))
        words[rows, w0 + 1] |= spill
    pitch = mb_values * 8
    raw = np.ascontiguousarray(words[:, :mb_values]).view(np.uint8)
    mdu = md_mb.view(u64)
    fu = first.view(u64)
    arrays = {
        "delta_bw": bw,
        "delta_cnt": cnt,
        "delta_md_lo": (mdu & u64(0xFFFFFFFF)).astype(np.uint32).view(np.int32),
        "delta_md_hi": (mdu >> u64(32)).astype(np.uint32).view(np.int32),
        "delta_first_lo": (fu & u64(0xFFFFFFFF)).astype(np.uint32).view(
            np.int32),
        "delta_first_hi": (fu >> u64(32)).astype(np.uint32).view(np.int32),
        "delta_bytes": raw.reshape(n_pages, mbc * pitch),
    }
    dims = {"delta_mb_values": mb_values, "delta_mb_cap": mbc,
            "delta_pitch": pitch, "n_pages": n_pages, "nn_cap": nn_cap}
    return dims, arrays, values, nn
