"""The plain reference: SQL LIKE over the data maker's values, in NumPy, and
each data page's counts from the rows the data maker put in it.

LIKE: '%' matches any run of bytes, '_' any one byte, every other byte
itself, over the whole value (no escape character).  A pattern without '_'
is matched by its literal pieces: the first must start the value, the last
must end it, and each piece between is found at its first occurrence at or
after the end of the one before (the leftmost choice leaves the most room,
so it finds a match whenever there is one).  Occurrences are found over all
values at once.  A pattern with '_' goes through Python's `re`, value by
value.
"""

from __future__ import annotations

import re

import numpy as np

from .datagen import Table

CHUNK = 1 << 25


def _occurrences_in(chars: np.ndarray, piece: bytes) -> np.ndarray:
    """Sorted start positions of every occurrence of `piece` in `chars`,
    overlapping ones included.  Candidates are found by the piece's first
    (up to) four bytes, read as one little-endian word at each of the four
    alignments, then each further byte is checked."""
    n, k = chars.size, min(len(piece), 4)
    if n < len(piece):
        return np.zeros(0, np.int64)
    dtype = {1: np.uint8, 2: "<u2", 4: "<u4"}.get(k)
    if dtype is None:
        k, dtype = 2, "<u2"
    key = np.frombuffer(piece[:k], dtype)[0]
    at = []
    for s in range(k):
        m = (n - s) // k
        at.append(np.flatnonzero(chars[s:s + m * k].view(dtype) == key) * k + s)
    at = np.sort(np.concatenate(at))
    at = at[at <= n - len(piece)]
    for j in range(k, len(piece)):
        at = at[chars[at + j] == piece[j]]
    return at


def occurrences(chars: np.ndarray, piece: bytes, pool=None) -> np.ndarray:
    """`_occurrences_in` over `chars` cut into blocks of CHUNK bytes (each
    read on into the next by the piece's length less one), on `pool`'s
    threads where one is given: numpy's passes release the interpreter."""
    n = chars.size
    over = len(piece) - 1

    def block(a: int) -> np.ndarray:
        return a + _occurrences_in(chars[a:min(a + CHUNK + over, n)], piece)

    starts = range(0, max(n, 1), CHUNK)
    parts = list(pool.map(block, starts)) if pool is not None \
        else [block(a) for a in starts]
    return np.concatenate(parts)


def _starts_with(chars, starts, lens, piece: bytes) -> np.ndarray:
    ok = lens >= len(piece)
    for j, b in enumerate(piece):
        ok &= chars[np.minimum(starts + j, chars.size - 1)] == b
    return ok


def _ends_with(starts, ends, chars, head: bytes, tail: bytes) -> np.ndarray:
    """[n] bool: the values that start with `head` and end with `tail`,
    apart."""
    lens = ends - starts
    return (lens >= len(head) + len(tail)) \
        & _starts_with(chars, starts, lens, head) \
        & _starts_with(chars, np.maximum(ends - len(tail), starts), lens, tail)


def _piece(starts, ends, chars, piece: bytes, pool=None):
    """(occurrences of `piece` in `chars`, [n] bool: the values holding one)."""
    occ = occurrences(chars, piece, pool)
    row = np.searchsorted(starts, occ, side="right") - 1
    inside = (row >= 0) & (occ + len(piece) <= ends[np.maximum(row, 0)])
    holds = np.zeros(starts.size, bool)
    holds[row[inside]] = True
    return occ, holds


def like_matches(starts: np.ndarray, ends: np.ndarray, chars: np.ndarray,
                 like: str, found: dict | None = None, pool=None
                 ) -> np.ndarray:
    """[n] bool: whether value i, chars[starts[i]:ends[i]], matches the LIKE
    pattern.  `found` caches, by piece, its occurrences and the values that
    hold one, and by (head, tail) the values that start and end with them,
    across calls on the same values (an occurrence counts only inside a
    value, so bytes between values do no harm)."""
    pat = like.encode()
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    lens = ends - starts
    if b"_" in pat:
        rx = re.compile(b"".join(
            b".*" if c == ord("%") else b"." if c == ord("_")
            else re.escape(bytes([c])) for c in pat), re.S)
        data = chars.tobytes()
        return np.fromiter((rx.fullmatch(data, s, e) is not None
                            for s, e in zip(starts.tolist(), ends.tolist())),
                           bool, count=lens.size)
    pieces = pat.split(b"%")
    if len(pieces) == 1:
        return (lens == len(pat)) & _starts_with(chars, starts, lens, pat)
    head, middle, tail = pieces[0], [p for p in pieces[1:-1] if p], pieces[-1]
    found = {} if found is None else found
    if (head, tail) not in found:
        found[head, tail] = _ends_with(starts, ends, chars, head, tail)
    ok = found[head, tail].copy()
    for piece in middle:
        if piece not in found:
            found[piece] = _piece(starts, ends, chars, piece, pool)
        ok &= found[piece][1]
    # the values that hold every piece: each piece at its first occurrence
    # at or after the end of the one before
    rows = np.flatnonzero(ok)
    cur = starts[rows] + len(head)
    stop = ends[rows] - len(tail)
    good = np.ones(rows.size, bool)
    for piece in middle:
        # past the end of the data when no occurrence follows
        occ = np.append(found[piece][0], chars.size + 1)
        pos = occ[np.searchsorted(occ, cur, side="left")]
        fits = pos + len(piece) <= stop
        good &= fits
        cur = np.where(fits, pos + len(piece), cur)
    ok[rows[~good]] = False
    return ok


def prepare(table: Table, likes, found: dict, pool) -> None:
    """Fills `found` with the pieces and the (head, tail) masks of every
    LIKE pattern of `likes` that the PLAIN table's values need, one a thread
    of `pool`, so that the patterns can then be matched side by side."""
    if table.encoding != "PLAIN":
        return
    split = [like.encode().split(b"%") for like in likes
             if "%" in like and "_" not in like]
    pieces = {p for s in split for p in s[1:-1] if p} - set(found)
    ends_of = {(s[0], s[-1]) for s in split} - set(found)
    starts = np.asarray(table.starts, np.int64)
    ends = np.asarray(table.ends, np.int64)
    jobs = [(p, lambda p=p: _piece(starts, ends, table.chars, p))
            for p in pieces]
    jobs += [(ht, lambda ht=ht: _ends_with(starts, ends, table.chars, *ht))
             for ht in ends_of]
    for key, got in zip([k for k, _f in jobs],
                        pool.map(lambda job: job[1](), jobs)):
        found[key] = got


def row_matches(table: Table, like: str, found: dict | None = None,
                pool=None) -> np.ndarray:
    """[n_rows] bool of the table's rows under the LIKE pattern."""
    if table.encoding == "PLAIN":
        return like_matches(table.starts, table.ends, table.chars, like, found,
                            pool)
    off = table.dom_offsets
    return like_matches(off[:-1], off[1:], table.dom_chars, like)[table.codes]


def page_answer(table: Table, match: np.ndarray, negate: bool
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(page_gid, match_counts, value_counts) of every data page, from the
    rows' matches: the pages are numbered in file order, every value of this
    REQUIRED column takes part, and `negate` counts the values that do not
    match."""
    hits = np.add.reduceat(match.astype(np.int64), table.page_rows[:-1])
    values = table.rows_per_page.astype(np.int64)
    return (np.arange(table.n_pages, dtype=np.int64),
            values - hits if negate else hits, values)
