"""The rooflines' byte counts against a count by hand of a tiny file's
encoded page bytes."""

import numpy as np

from portbench import datagen, roofline


def _orders(n, rg, words, lo, hi):
    return {"name": "hand.orders", "column": "c", "rows": n,
            "row_group_rows": rg, "page_bytes": 1024, "encoding": "PLAIN",
            "values": {"kind": "text", "min_len": lo, "max_len": hi,
                       "pool_words": 64, "words": words}}


def test_k1_bytes_are_the_plain_pages_and_a_count_each(tmp_path):
    # every value is "ab ab ab..." cut at 20 bytes: 4 + 20 = 24 bytes a row;
    # a page ends after the row that reaches 1024 bytes: 43 rows, 1032 bytes
    cfg = _orders(100, 100, ["ab"], 20, 20)
    t = datagen.make(cfg, 1, tmp_path / "o.parquet")
    assert list(t.rows_per_page) == [43, 43, 14]
    assert list(t.page_bytes) == [1032, 1032, 336]
    assert roofline.page_walk_bytes(t, "PLAIN") == 1032 + 1032 + 336 + 3 * 4
    assert roofline.page_walk_bytes(t, "RLE_DICTIONARY") == 0
    # the file holds each page's bytes after its header, as counted
    data = t.path.read_bytes()
    for j, (a, b) in enumerate(zip(t.page_rows[:-1], t.page_rows[1:])):
        payload = b"".join(len(v).to_bytes(4, "little") + v for v in
                           [t.chars[s:e].tobytes()
                            for s, e in zip(t.starts[a:b], t.ends[a:b])])
        assert len(payload) == t.page_bytes[j] and payload in data


def test_k2_bytes_are_the_index_pages_and_a_count_each(tmp_path):
    # 150 entries: 8-bit indices, 1024 rows a page; a page is the bit width
    # byte, the run header (varint of 128 groups * 2 + 1 = 257: 2 bytes) and
    # 1024 bytes of indices; the last page of 2000 - 1024 = 976 rows has
    # 122 groups, a 2-byte header (245), and 976 bytes
    cfg = {"name": "hand.part", "column": "c", "rows": 2000,
           "row_group_rows": 2000, "page_bytes": 1024,
           "encoding": "RLE_DICTIONARY",
           "values": {"kind": "syllables",
                      "syllables": [list("ABCDEF"), list("GHIJK"),
                                    list("LMNOP")]}}
    t = datagen.make(cfg, 3, tmp_path / "p.parquet")
    assert len(set(t.codes.tolist())) == 150
    assert list(t.rows_per_page) == [1024, 976]
    assert list(t.page_bytes) == [1 + 2 + 1024, 1 + 2 + 976]
    assert roofline.page_walk_bytes(t, "RLE_DICTIONARY") == 1027 + 979 + 2 * 4
    assert roofline.page_walk_bytes(t, "PLAIN") == 0


def test_share_against_the_peak():
    kind = "NVIDIA H100 80GB HBM3"
    # 3.35 GB in 1 ms is 3.35e12 bytes/s: the whole roofline
    assert np.isclose(roofline.share_pct(3.35e9, 1e-3, kind), 100.0)
    assert np.isclose(roofline.share_pct(3.35e9, 4e-3, kind), 25.0)
    assert roofline.share_pct(1e9, 1e-3, "cpu") is None
    assert roofline.share_pct(1e9, 0.0, kind) is None
