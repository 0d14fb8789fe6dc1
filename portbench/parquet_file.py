"""A small plain Parquet writer: one REQUIRED BYTE_ARRAY column, uncompressed,
PLAIN or dictionary-encoded data pages (v1), Thrift compact footer.

It is the benchmark's own, independent of the program's writer, so the data
maker decides every page boundary itself and records each page's rows and
encoded bytes as it writes.  Page headers are built for all pages of a row
group at once: each header is a few constant bytes around three varints, so
they are assembled as rows of a byte matrix and cut out with a mask.
"""

from __future__ import annotations

import struct

import numpy as np

# Thrift compact protocol type ids
_I32, _I64, _BINARY, _LIST, _STRUCT = 5, 6, 8, 9, 12
# parquet.thrift enums
BYTE_ARRAY = 6
REQUIRED = 0
UTF8 = 0
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
DATA_PAGE, DICTIONARY_PAGE = 0, 2
UNCOMPRESSED = 0
MAGIC = b"PAR1"


def _zigzag(v):
    v = np.asarray(v, np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def _varint_lengths(values) -> np.ndarray:
    v = np.asarray(values, np.uint64)
    n = np.ones(v.size, np.int64)
    for k in range(1, 10):
        n += v >= np.uint64(1) << np.uint64(7 * k)
    return n


def varint_rows(values) -> tuple[np.ndarray, np.ndarray]:
    """(bytes [n, w] u8, lengths [n]) of the ULEB128 encoding of each value."""
    v = np.asarray(values, np.uint64)
    lens = _varint_lengths(v)
    w = int(lens.max()) if v.size else 1
    out = np.zeros((v.size, w), np.uint8)
    rest = v.copy()
    for k in range(w):
        byte = (rest & np.uint64(0x7F)).astype(np.uint8)
        more = (k + 1) < lens
        out[:, k] = byte | (more.astype(np.uint8) << 7)
        rest >>= np.uint64(7)
    return out, lens


def ragged_rows(pieces, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Concatenates, row by row, `pieces`: each a constant `bytes` or a
    (matrix [n, w] u8, lengths [n]) pair.  Returns (flat bytes, row
    lengths): row i's bytes are the concatenation of its pieces."""
    mats, masks = [], []
    for p in pieces:
        if isinstance(p, (bytes, bytearray)):
            row = np.frombuffer(bytes(p), np.uint8)
            mats.append(np.broadcast_to(row, (n, row.size)))
            masks.append(np.ones((n, row.size), bool))
        else:
            m, lens = p
            mats.append(m)
            masks.append(np.arange(m.shape[1])[None, :] < np.asarray(lens)[:, None])
    mat = np.concatenate(mats, axis=1)
    mask = np.concatenate(masks, axis=1)
    return mat[mask], mask.sum(axis=1)


def page_headers(kind: int, sizes, num_values, encoding: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Compact-protocol PageHeaders of n uncompressed pages: (flat bytes,
    length of each header).  `kind` and `encoding` are enum values under 64,
    so each is one zigzag byte after its field header (0x15: the next field,
    an i32)."""
    sizes = np.asarray(sizes, np.int64)
    size_v = varint_rows(_zigzag(sizes))
    nv_v = varint_rows(_zigzag(num_values))
    enc = bytes([0x15, 2 * encoding])
    if kind == DATA_PAGE:
        # 5: DataPageHeader {1: num_values, 2: encoding, 3, 4: RLE levels}
        body = [b"\x2c\x15", nv_v, enc + b"\x15\x06\x15\x06\x00"]
    else:
        # 7: DictionaryPageHeader {1: num_values, 2: encoding}
        body = [b"\x4c\x15", nv_v, enc + b"\x00"]
    return ragged_rows([bytes([0x15, 2 * kind]), b"\x15", size_v, b"\x15",
                        size_v, *body, b"\x00"], sizes.size)


class _Thrift:
    """Compact-protocol writer for the footer (a few hundred fields)."""

    def __init__(self):
        self.buf = bytearray()
        self.last = [0]

    def _field(self, fid: int, ttype: int) -> None:
        delta = fid - self.last[-1]
        if 0 < delta <= 15:
            self.buf.append((delta << 4) | ttype)
        else:
            self.buf.append(ttype)
            self._varint(int(_zigzag([fid])[0]))
        self.last[-1] = fid

    def _varint(self, v: int) -> None:
        while True:
            if v < 0x80:
                self.buf.append(v)
                return
            self.buf.append((v & 0x7F) | 0x80)
            v >>= 7

    def i32(self, fid: int, v: int) -> None:
        self._field(fid, _I32)
        self._varint(int(_zigzag([v])[0]))

    def i64(self, fid: int, v: int) -> None:
        self._field(fid, _I64)
        self._varint(int(_zigzag([v])[0]))

    def binary(self, fid: int, v: bytes) -> None:
        self._field(fid, _BINARY)
        self._varint(len(v))
        self.buf += v

    def list_begin(self, fid: int, etype: int, size: int) -> None:
        self._field(fid, _LIST)
        if size < 15:
            self.buf.append((size << 4) | etype)
        else:
            self.buf.append(0xF0 | etype)
            self._varint(size)

    def list_i32(self, v: int) -> None:
        self._varint(int(_zigzag([v])[0]))

    def list_binary(self, v: bytes) -> None:
        self._varint(len(v))
        self.buf += v

    def struct_begin(self, fid: int | None = None) -> None:
        if fid is not None:
            self._field(fid, _STRUCT)
        self.last.append(0)

    def struct_end(self) -> None:
        self.buf.append(0)
        self.last.pop()


def plain_payload(offsets: np.ndarray, chars: np.ndarray) -> np.ndarray:
    """PLAIN BYTE_ARRAY encoding of the values chars[offsets[i]:offsets[i+1]]:
    each a 4-byte little-endian length, then its bytes."""
    lens = np.diff(offsets).astype(np.int64)
    n = lens.size
    out = np.empty(int(4 * n + lens.sum()), np.uint8)
    starts = np.arange(n, dtype=np.int64) * 4 + (offsets[:-1] - offsets[0])
    for k in range(4):
        out[starts + k] = (lens >> (8 * k)) & 0xFF
    dst = np.repeat(starts + 4 - (offsets[:-1] - offsets[0]), lens) \
        + np.arange(int(lens.sum()), dtype=np.int64)
    out[dst] = chars[offsets[0]:offsets[-1]]
    return out


def bit_width(n_entries: int) -> int:
    return max(int(n_entries - 1).bit_length(), 0) if n_entries > 1 else 0


def dict_index_payload(codes: np.ndarray, bw: int) -> np.ndarray:
    """One data page's dictionary indices: the bit width byte, then one
    bit-packed run of the RLE / bit-packing hybrid (groups of 8 values,
    zero-padded), least significant bit first."""
    n = codes.size
    groups = -(-n // 8)
    vals = np.zeros(groups * 8, np.uint64)
    vals[:n] = codes
    bits = ((vals[:, None] >> np.arange(bw, dtype=np.uint64)[None, :])
            & np.uint64(1)).astype(np.uint8)
    packed = np.packbits(bits.ravel(), bitorder="little")
    head, hl = varint_rows([(groups << 1) | 1])
    return np.concatenate([np.array([bw], np.uint8), head[0, :hl[0]], packed])


class ColumnFileWriter:
    """Writes a one-column Parquet file row group by row group."""

    def __init__(self, path, column: str):
        self.f = open(path, "wb")
        self.f.write(MAGIC)
        self.pos = len(MAGIC)
        self.column = column.encode()
        self.row_groups: list[dict] = []
        self.rows = 0

    def _pages(self, payload: np.ndarray, bounds: np.ndarray, kind: int,
               num_values, encoding: int) -> None:
        """Writes each page's header and payload; page j's payload is
        payload[bounds[j]:bounds[j + 1]]."""
        sizes = np.diff(bounds)
        heads, hl = page_headers(kind, sizes, num_values, encoding)
        hoff = np.concatenate([[0], np.cumsum(hl)]).tolist()
        at = bounds.tolist()
        hv, pv = memoryview(heads), memoryview(payload)
        parts = []
        for j in range(sizes.size):
            parts.append(hv[hoff[j]:hoff[j + 1]])
            parts.append(pv[at[j]:at[j + 1]])
        self.f.writelines(parts)
        self.pos += int(hl.sum() + sizes.sum())

    def _chunk(self, start: int, num_values: int, encodings,
               data_offset: int) -> None:
        self.row_groups.append(dict(
            offset=start, size=self.pos - start, rows=num_values,
            encodings=encodings, data_offset=data_offset,
            dict_offset=start if data_offset != start else None))
        self.rows += num_values

    def plain_row_group(self, payload: np.ndarray, bounds: np.ndarray,
                        rows_per_page: np.ndarray) -> None:
        """PLAIN pages: page j holds payload[bounds[j]:bounds[j + 1]], the
        PLAIN encoding of its rows_per_page[j] values."""
        start = self.pos
        self._pages(payload, bounds, DATA_PAGE, rows_per_page, PLAIN)
        self._chunk(start, int(np.sum(rows_per_page)), [PLAIN, RLE], start)

    def dict_row_group(self, dict_payload: np.ndarray, dict_n: int,
                       data_payload: np.ndarray, bounds: np.ndarray,
                       rows_per_page: np.ndarray) -> None:
        """A dictionary page of `dict_n` PLAIN entries, then dictionary data
        pages (page j's payload data_payload[bounds[j]:bounds[j + 1]])."""
        start = self.pos
        self._pages(dict_payload, np.array([0, dict_payload.size]),
                    DICTIONARY_PAGE, [dict_n], PLAIN_DICTIONARY)
        data_at = self.pos
        self._pages(data_payload, bounds, DATA_PAGE, rows_per_page,
                    RLE_DICTIONARY)
        self._chunk(start, int(np.sum(rows_per_page)),
                    [PLAIN_DICTIONARY, RLE, RLE_DICTIONARY], data_at)

    def close(self) -> None:
        t = _Thrift()
        t.struct_begin()
        t.i32(1, 1)                                   # version
        t.list_begin(2, _STRUCT, 2)                   # schema
        t.struct_begin()
        t.binary(4, b"schema")
        t.i32(5, 1)
        t.struct_end()
        t.struct_begin()
        t.i32(1, BYTE_ARRAY)
        t.i32(3, REQUIRED)
        t.binary(4, self.column)
        t.i32(6, UTF8)
        t.struct_end()
        t.i64(3, self.rows)
        t.list_begin(4, _STRUCT, len(self.row_groups))
        for rg in self.row_groups:
            t.struct_begin()
            t.list_begin(1, _STRUCT, 1)               # columns
            t.struct_begin()
            t.i64(2, rg["offset"])                    # file_offset
            t.struct_begin(3)                         # ColumnMetaData
            t.i32(1, BYTE_ARRAY)
            t.list_begin(2, _I32, len(rg["encodings"]))
            for e in rg["encodings"]:
                t.list_i32(e)
            t.list_begin(3, _BINARY, 1)
            t.list_binary(self.column)
            t.i32(4, UNCOMPRESSED)
            t.i64(5, rg["rows"])
            t.i64(6, rg["size"])
            t.i64(7, rg["size"])
            t.i64(9, rg["data_offset"])
            if rg["dict_offset"] is not None:
                t.i64(11, rg["dict_offset"])
            t.struct_end()
            t.struct_end()
            t.i64(2, rg["size"])                      # total_byte_size
            t.i64(3, rg["rows"])
            t.struct_end()
        t.binary(6, b"portbench plain writer")      # created_by
        t.struct_end()
        footer = bytes(t.buf)
        self.f.write(footer)
        self.f.write(struct.pack("<I", len(footer)))
        self.f.write(MAGIC)
        self.f.close()
