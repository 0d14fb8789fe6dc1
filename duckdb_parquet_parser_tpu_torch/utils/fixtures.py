"""Seeded fixtures for the port's smoke run and benchmarks.

`lineitem` writes the same file as the reference benchmark's
`bench.gen_fixture` (TPC-H-lineitem-like: an `l_comment` string column of
five words each, 1% null, beside INT64/DOUBLE columns, 500,000-row row
groups); `dict_ints` the same file as its `bench.gen_dict_fixture` (a
dictionary-encoded INT64 column), `sorted_keys` as its
`gen_sorted_fixture` (key-ordered strings) and `dict_cities` as its
`gen_dict_strings_fixture` (64 city names); `dict_strings` writes a
dictionary-encoded string column over several row groups, each with its own
distinct values.  These use the port's writer (host/writer.py) and return
the path, writing only when it does not exist.

The reference benchmark writes two more files with pyarrow, which machines
without it cannot write, so their values come as arrays instead:
`bigpage_arrays` (the values of `gen_bigpage_fixture` in ~1 MiB pages, as
a PS_PAYLOAD prescan's batch) and `delta_column_planes` (those of
`gen_delta_fixture`, DELTA_BINARY_PACKED into PS_DELTA_RAW planes).
`delta_planes` packs seeded int64 values of every miniblock width into the
same planes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..host.batch import DecodeBatch
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


def _join_words(words, pick: np.ndarray):
    """(offsets [n + 1] int64, chars u8) of the n values `b" ".join(words[j]
    for j in row)` over the rows of `pick`."""
    lens_of = np.array([len(x) for x in words])
    n, k = pick.shape
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens_of[pick].sum(axis=1) + (k - 1), out=offs[1:])
    chars = np.full(offs[-1], ord(" "), np.uint8)
    at = offs[:-1].copy()
    for c in range(k):
        for wi, word in enumerate(words):
            sel = pick[:, c] == wi
            if not sel.any():
                continue
            wb = np.frombuffer(word, np.uint8)
            idx = at[sel][:, None] + np.arange(len(wb))[None, :]
            chars[idx.ravel()] = np.tile(wb, int(sel.sum()))
        at += lens_of[pick[:, c]] + 1
    return offs, chars


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
    done = 0
    while done < rows:
        n = min(500_000, rows - done)
        offs, chars = _join_words(
            LINEITEM_WORDS, rng.integers(0, len(LINEITEM_WORDS), (n, 5)))
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



def sorted_keys(path, rows: int) -> Path:
    """A key-ordered `s_key` BYTE_ARRAY column (2% null) of "user_NNNNNNN
    extra" keys in ascending order, 500,000-row row groups, seed 77: the
    layout where ColumnIndex [min, max] pruning pays."""
    path = Path(path)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(77)
    w = ParquetWriter(str(path),
                      [ColumnSpec("s_key", ParquetType.BYTE_ARRAY,
                                  optional=True)])
    pre = np.frombuffer(b"user_", np.uint8)
    post = np.frombuffer(b" extra", np.uint8)
    done = 0
    while done < rows:
        n = min(500_000, rows - done)
        # zero-padded digits: lexicographic order is numeric order
        digits = np.zeros((n, 7), np.uint8)
        v = np.arange(done, done + n)
        for d in range(6, -1, -1):
            digits[:, d] = (v % 10) + ord("0")
            v //= 10
        row = np.concatenate([np.tile(pre, (n, 1)), digits,
                              np.tile(post, (n, 1))], axis=1)
        offs = np.arange(n + 1, dtype=np.int64) * row.shape[1]
        valid = (rng.random(n) > 0.02).astype(np.uint8)
        w.write_row_group({"s_key": (offs, row.ravel(), valid)})
        done += n
    w.close()
    return path


DICT_CITY_BASES = [b"san diego", b"san francisco", b"san antonio", b"new york",
                   b"new orleans", b"chicago", b"boston", b"seattle",
                   b"atlanta", b"houston", b"denver", b"miami", b"dallas",
                   b"portland", b"phoenix", b"detroit"]


def dict_cities(path, rows: int) -> Path:
    """A low-cardinality `city` BYTE_ARRAY column (64 distinct names, 2%
    null), 500,000-row row groups, seed 11: every data page is
    dictionary-encoded."""
    path = Path(path)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    cities = [b + f"-{k}".encode() for b in DICT_CITY_BASES for k in range(4)]
    w = ParquetWriter(str(path), [ColumnSpec("city", ParquetType.BYTE_ARRAY,
                                             optional=True)],
                      key_value={"pad": "x" * 512})
    done = 0
    while done < rows:
        n = min(500_000, rows - done)
        pick = rng.integers(0, len(cities), n)
        valid = rng.random(n) > 0.02
        w.write_row_group({"city": [cities[int(k)] if v else None
                                    for k, v in zip(pick, valid)]})
        done += n
    w.close()
    return path


BIGPAGE_WORDS = [b"carefully", b"furiously", b"quickly", b"slyly", b"requests",
                 b"deposits", b"packages", b"special", b"express", b"regular"]
BIGPAGE_BYTES = 1 << 20  # a data page's payload, at most


def bigpage_arrays(rows: int) -> DecodeBatch:
    """`rows` (at least 1) values of five words each (seed 13, drawn
    250,000 at a time, ten words) as the page batch of a PS_PAYLOAD prescan
    of an `l_comment` column in big data pages: PLAIN BYTE_ARRAY pages cut
    at the last value boundary at or under BIGPAGE_BYTES of payload (4-byte
    length prefix and bytes a value), one row group, nullable with no
    nulls.  Not a file: the port's writer cuts 1 KB pages.  The arrays are `payload` [pages, pitch]
    u8 (the longest page rounded up to 512 bytes), `page_payload_len`,
    `page_nn`, `page_num_values`, `page_kind`, `page_gid`,
    `page_row_start`, `page_rg`, `page_def_bw`, `page_dict_base`,
    `page_dict_size` and `def_levels` [pages, vmax]."""
    rng = np.random.default_rng(13)
    picks, done = [], 0
    while done < rows:
        n = min(250_000, rows - done)
        picks.append(rng.integers(0, len(BIGPAGE_WORDS), (n, 5)))
        done += n
    offs, chars = _join_words(BIGPAGE_WORDS, np.concatenate(picks))
    lens = np.diff(offs)
    # the PLAIN value section: a little-endian uint32 length, then the bytes
    ends = np.cumsum(lens + 4)
    flat = np.empty(int(ends[-1]), np.uint8)
    starts = ends - lens - 4
    flat[starts[:, None] + np.arange(4)[None, :]] = (
        lens.astype("<u4").view(np.uint8).reshape(-1, 4))
    body = np.repeat(starts + 4 - offs[:-1], lens) + np.arange(offs[-1])
    flat[body] = chars
    cuts = [0]                       # value index each page starts at
    while cuts[-1] < rows:
        base = int(starts[cuts[-1]])
        cuts.append(max(int(np.searchsorted(ends, base + BIGPAGE_BYTES,
                                            side="right")), cuts[-1] + 1))
    cuts = np.array(cuts, np.int64)
    n_pages = len(cuts) - 1
    nv = np.diff(cuts).astype(np.int32)
    lo = starts[cuts[:-1]]
    plen = (ends[cuts[1:] - 1] - lo).astype(np.int32)
    pitch = -(-int(plen.max()) // 512) * 512
    payload = np.zeros((n_pages, pitch), np.uint8)
    for p in range(n_pages):
        payload[p, :plen[p]] = flat[lo[p]:lo[p] + plen[p]]
    vmax = int(nv.max())
    arrays = {
        "payload": payload,
        "page_payload_len": plen,
        "page_nn": nv.copy(),
        "page_num_values": nv,
        "page_kind": np.zeros(n_pages, np.int32),
        "page_gid": np.arange(n_pages, dtype=np.int64),
        "page_row_start": cuts[:-1].copy(),
        "page_rg": np.zeros(n_pages, np.int32),
        "page_def_bw": np.ones(n_pages, np.int32),
        "page_dict_base": np.full(n_pages, -1, np.int32),
        "page_dict_size": np.zeros(n_pages, np.int32),
        "def_levels": (np.arange(vmax)[None, :] < nv[:, None]).astype(
            np.uint8),
    }
    dims = {"n_pages": n_pages, "vmax": vmax, "nn_cap": vmax, "max_def": 1,
            "max_rep": 0, "type": int(ParquetType.BYTE_ARRAY), "dict_n": 0,
            "plain_w": 0, "nn_total": 0}
    return DecodeBatch(dims, arrays)

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
    dims, arrays = _pack_delta(values, nn, mb_values, mb_per_block)
    return dims, arrays, values, nn


DELTA_PAGE_BYTES = 64 << 10  # a delta page's encoded data, about
# (deltas a miniblock, miniblocks a block) of pyarrow's INT64 delta pages,
# as a prescan of the reference benchmark's delta file shows them
DELTA_INT64_MB = (64, 4)


def _delta_page_len(vals: np.ndarray) -> int:
    """How many of `vals` (int64, the rest of the column) the next page
    holds: the first value and whole blocks of deltas while their encoded
    size (a block's least delta as up to 10 bytes, a width byte a
    miniblock, each miniblock's deltas at its width) stays within
    DELTA_PAGE_BYTES, at least one block."""
    u64 = np.uint64
    mb_values, mb_per_block = DELTA_INT64_MB
    block, page_bytes = mb_values * mb_per_block, DELTA_PAGE_BYTES
    window = vals[:1 + (page_bytes * 8 // mb_values + 1) * block]
    d = np.diff(window.view(u64)).view(np.int64)
    if d.size == 0:
        return len(window)
    nb = -(-d.size // block)
    signed = np.full(nb * block, np.iinfo(np.int64).max)
    signed[:d.size] = d
    md = signed.reshape(nb, block).min(axis=1)
    packed = np.zeros(nb * block, u64)
    packed[:d.size] = (d.view(u64) - np.repeat(md, block)[:d.size].view(u64))
    top = packed.reshape(-1, mb_values).max(axis=1)
    width = np.zeros(top.shape, np.int64)
    for k in range(64):
        width += (top >> u64(k)) != 0
    cost = 10 + mb_per_block + (width.reshape(nb, mb_per_block).sum(axis=1)
                                * mb_values // 8)
    fit = int(np.searchsorted(np.cumsum(cost), page_bytes, side="right"))
    return min(1 + max(fit, 1) * block, len(window))


def delta_column_planes(rows: int):
    """The INT64 column of the reference benchmark's delta fixture (seed
    21: a running sum of steps in [-50, 200), a +-2**40 spike every 131st
    value, 5% nulls) packed as DELTA_BINARY_PACKED into the structure
    planes of a PS_DELTA_RAW prescan (`delta_planes` says which), in pages
    of about DELTA_PAGE_BYTES of encoded non-null values, in pyarrow's
    INT64 geometry (DELTA_INT64_MB).  Not a file: the port's writer cannot write DELTA_BINARY_PACKED pages.
    Returns (dims, arrays, values, nn) as `delta_planes` does; `values`
    holds the non-null values, page by page."""
    rng = np.random.default_rng(21)
    base = np.cumsum(rng.integers(-50, 200, rows)).astype(np.int64)
    base[::131] += rng.integers(-(1 << 40), 1 << 40, (rows + 130) // 131)
    vals = base[~(rng.random(rows) < 0.05)]
    sizes, at = [], 0
    while at < vals.size:
        sizes.append(_delta_page_len(vals[at:]))
        at += sizes[-1]
    nn = np.array(sizes, np.int64)
    values = np.zeros((nn.size, int(nn.max()) if nn.size else 1), np.int64)
    values[np.arange(values.shape[1])[None, :] < nn[:, None]] = vals
    dims, arrays = _pack_delta(values, nn, *DELTA_INT64_MB)
    return dims, arrays, values, nn


def _pack_delta(values: np.ndarray, nn: np.ndarray, mb_values: int,
                mb_per_block: int):
    """The writer's side of DELTA_BINARY_PACKED for pages of int64 values
    ([n_pages, nn_cap], zero past each page's `nn`): deltas (in uint64,
    wrapping), the least delta of each block of `mb_per_block` miniblocks
    of `mb_values` deltas, the bit width of each miniblock, LSB-first bit
    packing; as (dims, arrays) of a PS_DELTA_RAW prescan (`delta_planes`
    says which)."""
    u64 = np.uint64
    n_pages, nn_cap = values.shape
    n_deltas = max(nn_cap - 1, 0)
    mbc = max(-(-n_deltas // mb_values), 1)
    mbc = -(-mbc // mb_per_block) * mb_per_block      # whole blocks
    n_blocks = mbc // mb_per_block
    first = values[:, 0]
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
    return dims, arrays
