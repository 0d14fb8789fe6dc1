"""The edges of a page walk's 16-byte chunks, shared by the tests of the
two kernels that walk the resident [chunks, n, 16] stream: K1, the
register-machine walk (csrc/stream_matcher.cu.in, tests/test_torch_bitprog.py)
and K3's page walk (csrc/dfa_walk.cu, tests/test_torch_dfa_walk.py).  Both
walk a lane's chunks unrolled and handle a value boundary once a value, its
4-byte length prefix read from two chunks, so both must hold the
reference's byte walk where a prefix or a value meets a chunk's edge, where
`plen`, `steps` or `nn` cuts the walk and where several values share a
chunk.  `chip_smoke.py` runs the same lanes on the card.
"""

from __future__ import annotations

import numpy as np

# {name: lanes}, a lane (items, nn, plen) with None for the page's value
# count and length.  An item is a value (bytes, after its length prefix), a
# bare length prefix (int) or raw bytes (bytearray).
_TEXT = b"carefully express deposits ly requests slyly final bold " * 3


def _w(n: int, at: int = 0) -> bytes:
    return _TEXT[at:at + n]


def _prefix_edge(k: int):
    """Lanes whose length prefixes start at byte k of their chunks (one
    straddles into the next chunk where k > 12)."""
    return [([_w(k - 4)] + [_w(12, 27)] * 6, None, None),
            ([_w(k - 4, 5)] + [_w(28)] * 3 + [_w(44, 10)], None, None),
            ([_w(k - 4)] + [b""] * 3 + [_w(12, 27)], None, None)]


PAGE_EDGES = {
    **{f"prefix at byte {k}": _prefix_edge(k) for k in (12, 13, 14, 15)},
    "value ends on byte 15": [
        ([_w(12)] + [_w(12, 3)] * 5, None, None),
        ([_w(28)] + [_w(28, 9)] * 2, None, None),
        ([_w(12), b"", _w(8), b"", b""], None, None)],
    "zero-length values across chunks": [
        ([_w(6)] + [b""] * 8 + [_w(12, 27)], None, None),
        ([b""] * 10 + [_w(20)], None, None),
        ([_w(2)] + [b""] * 5, None, None)],
    "plen in a prefix": [([_w(12), _w(28, 3), _w(20, 7)], None, pl)
                         for pl in (16, 17, 18, 19, 49)],
    "plen in a value": [([_w(12), _w(28, 3), _w(20, 7)], None, pl)
                        for pl in (20, 30, 47, 48)],
    "nn mid-chunk": [([_w(5), _w(3), _w(7), _w(12, 27)], nv, None)
                     for nv in (1, 2, 3)],
    "bit-31 length": [
        ([_w(2), 0x80000005, bytearray(_w(33))], None, None),
        ([_w(11), 0xFFFFFFFF, bytearray(_w(20))], None, None),
        ([_w(11), 500, bytearray(_w(20))], None, None),
        ([0x80000000, bytearray(_w(40))], None, None)],
    "lanes with nn = 0 or plen = 0": [
        ([_w(12, 27), _w(5)], 0, None), ([_w(12, 27)], 1, 0),
        ([], 0, 0), ([_w(3)], 1, 3)],
    # values of 1-3 bytes, several ending in one chunk (some beside
    # zero-length ones), from every byte of a chunk on
    "values of 1-3 bytes, several a chunk": [
        ([_w(1 + i % 3, i) for i in range(24)], None, None),
        ([_w(3, 6), b"", _w(1, 2), _w(2, 9), b"", b"", _w(3, 20)] * 4,
         None, None),
        *[([_w(k)] + [_w(1 + i % 3, 2 * i) for i in range(12)], None, None)
          for k in range(0, 16, 3)],
        ([_w(2, i) for i in range(20)], None, 57),
        ([_w(1, i) for i in range(20)], 9, None)],
}
# cuts of the walk at bytes inside prefixes and values of the edges
PAGE_EDGE_STEPS = (None, 13, 16, 20, 31, 47)
# K1's walks held at the edges: one bitprog pattern (Q13's shape), one
# bitap chain and a fused tuple of patterns, one of which accepts the empty
# value (no registers), so every zero-length value counts
K1_EDGE_WALKS = {"bitprog": "^.*ly.*s.*$", "bitap": (b"ly", b"re"),
                 "fused": ("e.*s", "ly$", "a?", "q[ax]+x")}


def k1_edge_irs(walk: str) -> tuple:
    """The port's register-machine IR tuple of K1_EDGE_WALKS[walk]."""
    from duckdb_parquet_parser_tpu_torch.ops import bitprog, strings

    spec = K1_EDGE_WALKS[walk]
    if walk == "bitprog":
        return (bitprog.bitprog_ir(spec),)
    if walk == "bitap":
        return (strings.bitap_ir(spec),)
    return tuple(strings.pattern_ir(p) for p in spec)


def page_edge(names) -> tuple:
    """([n, pitch] u8, plen, nn) of the lanes of the edges `names`."""
    pages, plens, nns = [], [], []
    for name in names:
        for items, nv, pl in PAGE_EDGES[name]:
            page = b"".join(bytes(x) if isinstance(x, bytearray)
                            else x.to_bytes(4, "little") if isinstance(x, int)
                            else len(x).to_bytes(4, "little") + x
                            for x in items)
            pages.append(page)
            plens.append(len(page) if pl is None else pl)
            nns.append(sum(not isinstance(x, bytearray) for x in items)
                       if nv is None else nv)
    pm = np.zeros((len(pages), max(max(map(len, pages)) + 20, 64)),
                  np.uint8)
    for i, page in enumerate(pages):
        pm[i, :len(page)] = np.frombuffer(page, np.uint8)
    return pm, np.array(plens, np.int32), np.array(nns, np.int32)
