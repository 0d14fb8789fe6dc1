"""The data maker: one configuration's table, made from `--seed`, written as a
one-column Parquet file by the benchmark's own writer (parquet_file.py).

Two kinds of column, named by the configuration's `values.kind`:

- `text`: TPC-H's comment text, as dbgen makes it: a pool of words of the
  configuration's vocabulary joined by spaces, and each value a run of it of
  a length in [min_len, max_len], starting at a word drawn uniformly;
- `syllables`: one syllable of each list, joined by a space (TPC-H's
  P_TYPE).

Lengths and syllable combinations are uniform as dbgen's, and balanced:
each length, and each combination, is taken equally often (as n allows) and
only their order is drawn, so every seed makes a table of the same size.

Pages follow the configuration's layout: `row_group_rows` rows a row group;
PLAIN data pages cut greedily at `page_bytes` of payload, after the row that
crosses it; dictionary data pages of `page_bytes / ceil(bit width / 8)` rows.
Each page's rows and encoded bytes are recorded as it is written, so the
reference knows every page's values without reading the file.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import parquet_file as pq

DATA_DIR = Path(__file__).resolve().parents[1] / "build" / "portbench" / "data"


@dataclass
class Table:
    """A column as the data maker made it.  PLAIN: `chars` is the PLAIN
    encoding of every row in file order (each value's 4-byte length, then its
    bytes) and value i is chars[starts[i]:ends[i]].  Dictionary: row i holds
    domain value codes[i], domain value d being
    dom_chars[dom_offsets[d]:dom_offsets[d + 1]].
    Pages: page j holds rows [page_rows[j], page_rows[j + 1]) and
    page_bytes[j] bytes of encoded data (its payload as written)."""

    column: str
    encoding: str
    n_rows: int
    page_rows: np.ndarray
    page_bytes: np.ndarray
    chars: np.ndarray | None = None
    starts: np.ndarray | None = None
    ends: np.ndarray | None = None
    dom_offsets: np.ndarray | None = None
    dom_chars: np.ndarray | None = None
    codes: np.ndarray | None = None
    path: Path | None = None

    @property
    def n_pages(self) -> int:
        return int(self.page_bytes.size)

    @property
    def rows_per_page(self) -> np.ndarray:
        return np.diff(self.page_rows)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one use (`stream`) of `seed`: any whole number."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) % 2**63, int(seed) < 0, stream])))


def balanced(lo: int, hi: int, n: int, rng: np.random.Generator
             ) -> np.ndarray:
    """n whole numbers of [lo, hi), each as often as n allows (uniform), in
    the order of `rng`: every seed draws the same sizes, in another order."""
    return lo + rng.permutation(np.arange(n, dtype=np.int64) % (hi - lo))


def _joined(words: list[bytes], picks: np.ndarray, sep: bytes
            ) -> tuple[np.ndarray, np.ndarray]:
    """(offsets, chars) of the words picks[i, 0], picks[i, 1], ... of each row
    i, each followed by `sep`."""
    width = max(len(w) for w in words) + len(sep)
    table = np.zeros((len(words), width), np.uint8)
    lens = np.zeros(len(words), np.int64)
    for i, w in enumerate(words):
        b = w + sep
        table[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    flat, row_lens = pq.ragged_rows(
        [(table[picks[:, c]], lens[picks[:, c]]) for c in range(picks.shape[1])],
        picks.shape[0])
    offs = np.zeros(picks.shape[0] + 1, np.int64)
    np.cumsum(row_lens, out=offs[1:])
    return offs, flat


def _text(spec: dict, n: int, rng: np.random.Generator
          ) -> tuple[np.ndarray, np.ndarray]:
    """(PLAIN encoding of the n values, each value's length)."""
    words = [w.encode() for w in spec["words"]]
    pool_words = int(spec["pool_words"])
    word_at, pool = _joined(words, rng.integers(0, len(words),
                                                (pool_words, 1)), b" ")
    lo, hi = int(spec["min_len"]), int(spec["max_len"])
    # enough words after a start to fill the longest value
    room = -(-(hi + 1) // (min(len(w) for w in words) + 1)) + 1
    first = word_at[rng.integers(0, pool_words - room, n)]
    lens = balanced(lo, hi + 1, n, rng)
    windows = np.lib.stride_tricks.sliding_window_view(pool, hi)
    cum = np.zeros(n + 1, np.int64)
    np.cumsum(lens + 4, out=cum[1:])
    out = np.empty(int(cum[-1]), np.uint8)
    cols = np.arange(4 + hi, dtype=np.uint8)

    def fill(a: int) -> None:
        b = min(a + (1 << 18), n)
        rows = np.empty((b - a, 4 + hi), np.uint8)
        rows[:, :4] = lens[a:b].astype("<u4").view(np.uint8).reshape(-1, 4)
        rows[:, 4:] = windows[first[a:b]]
        keep = cols[None, :] < (lens[a:b] + 4).astype(np.uint8)[:, None]
        out[cum[a]:cum[b]] = rows[keep]

    # numpy's copies release the GIL: the chunks fill on the host's cores
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(fill, range(0, n, 1 << 18)))
    return out, lens


def _domain(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """(offsets, chars) of every syllable combination, the first list
    varying slowest."""
    lists = [[s.encode() for s in group] for group in spec["syllables"]]
    sizes = [len(g) for g in lists]
    grid = np.stack(np.unravel_index(np.arange(int(np.prod(sizes))), sizes),
                    axis=1)
    sep = spec.get("separator", " ").encode()
    vals = [sep.join(lists[k][grid[i, k]] for k in range(len(lists)))
            for i in range(grid.shape[0])]
    offs = np.zeros(len(vals) + 1, np.int64)
    np.cumsum([len(v) for v in vals], out=offs[1:])
    return offs, np.frombuffer(b"".join(vals), np.uint8).copy()


def plain_page_rows(row_bytes: np.ndarray, rg_rows: int, page_bytes: int
                    ) -> np.ndarray:
    """Page boundaries (row indices, ending with n) of PLAIN pages: within
    each row group, a page ends after the row at which its bytes reach
    `page_bytes`.  All row groups advance together, one page a step."""
    n = row_bytes.size
    cum = np.zeros(n + 1, np.int64)
    np.cumsum(row_bytes, out=cum[1:])
    rg_start = np.arange(0, n, rg_rows, dtype=np.int64)
    rg_end = np.minimum(rg_start + rg_rows, n)
    cur = rg_start.copy()
    bounds = [rg_start]
    while True:
        live = cur < rg_end
        if not live.any():
            break
        nxt = np.searchsorted(cum, cum[cur[live]] + page_bytes, side="left")
        nxt = np.minimum(nxt, rg_end[live])
        cur[live] = nxt
        bounds.append(nxt)
    return np.unique(np.concatenate(bounds + [np.array([n])]))


def make(cfg: dict, seed: int, path: Path | None = None) -> Table:
    """The configuration's table for `seed`; written to `path` when one is
    given."""
    n = int(cfg["rows"])
    rg_rows = int(cfg["row_group_rows"])
    spec = cfg["values"]
    rng = rng_for(seed, 0)
    writer = None
    if path is not None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        writer = pq.ColumnFileWriter(tmp, cfg["column"])
    if cfg["encoding"] == "PLAIN":
        if spec["kind"] != "text":
            raise ValueError("a PLAIN column here holds text")
        chars, lens = _text(spec, n, rng)
        cum = np.zeros(n + 1, np.int64)
        np.cumsum(lens + 4, out=cum[1:])
        rows = plain_page_rows(lens + 4, rg_rows, int(cfg["page_bytes"]))
        table = Table(cfg["column"], "PLAIN", n, rows, np.diff(cum[rows]),
                      chars=chars, starts=cum[:-1] + 4, ends=cum[1:])
        if writer is not None:
            for a in range(0, n, rg_rows):
                b = min(a + rg_rows, n)
                cut = rows[(rows >= a) & (rows <= b)]
                writer.plain_row_group(chars[cum[a]:cum[b]], cum[cut] - cum[a],
                                       np.diff(cut))
    elif cfg["encoding"] == "RLE_DICTIONARY":
        if spec["kind"] != "syllables":
            raise ValueError("a dictionary column here holds syllables")
        dom_offsets, dom_chars = _domain(spec)
        codes = balanced(0, dom_offsets.size - 1, n, rng).astype(np.int32)
        rows, page_bytes = [], []
        for a in range(0, n, rg_rows):
            b = min(a + rg_rows, n)
            uniq, first = np.unique(codes[a:b], return_index=True)
            order = uniq[np.argsort(first)]      # dictionary in first-use order
            local = np.empty(dom_offsets.size - 1, np.int64)
            local[order] = np.arange(order.size)
            bw = pq.bit_width(order.size)
            per_page = int(cfg["page_bytes"]) // max(1, -(-bw // 8))
            cut = np.append(np.arange(a, b, per_page), b)
            pays = [pq.dict_index_payload(local[codes[c:d]], bw)
                    for c, d in zip(cut[:-1], cut[1:])]
            rows.append(cut[:-1])
            page_bytes.append([p.size for p in pays])
            if writer is not None:
                dvals = [dom_chars[dom_offsets[d]:dom_offsets[d + 1]]
                         for d in order]
                doffs = np.concatenate([[0], np.cumsum([v.size for v in dvals])])
                dict_payload = pq.plain_payload(doffs, np.concatenate(dvals))
                writer.dict_row_group(
                    dict_payload, order.size, np.concatenate(pays),
                    np.concatenate([[0], np.cumsum([p.size for p in pays])]),
                    np.diff(cut))
        table = Table(cfg["column"], "RLE_DICTIONARY", n,
                      np.append(np.concatenate(rows), n),
                      np.concatenate(page_bytes).astype(np.int64),
                      dom_offsets=dom_offsets, dom_chars=dom_chars,
                      codes=codes)
    else:
        raise ValueError(f"unknown encoding {cfg['encoding']!r}")
    if writer is not None:
        writer.close()
        # on the disk before the window: no write-back inside it
        flush(tmp)
        os.replace(tmp, path)
        table.path = path
    return table


def flush(path: Path) -> None:
    """Writes the file's data, and its directory's entry, to the disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    fd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def data_path(cfg: dict, seed: int, root: Path = DATA_DIR) -> Path:
    """The configuration's file for `seed` in its one fixed directory; the
    files of other seeds there are removed, so at most one is kept."""
    d = Path(root) / cfg["name"]
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{cfg['name']}.{int(seed)}.parquet"
    for old in d.iterdir():
        if old != path:
            old.unlink()
    return path
