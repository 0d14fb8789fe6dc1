"""Fixture-generating Parquet writer (Python front end over the native lib);
the port's own copy of `duckdb_parquet_parser_tpu/host/writer.py`.

Accepts numpy columnar data; layout rules (dictionary threshold, 1 KB page
splits, pure-RLE def levels, hybrid dict-index encoding) are implemented in
the native library and match the reference writer — see
native/dpq_writer.hpp for the behavioral contract and citations.
"""

from __future__ import annotations

import ctypes as ct
from dataclasses import dataclass

import numpy as np

from . import bindings
from .bindings import NativeError, check, lib
from .schema import ConvertedType, ParquetType

_INT32_MIN = -(2**31)

_FIXED_DTYPES = {
    ParquetType.INT32: np.int32,
    ParquetType.INT64: np.int64,
    ParquetType.FLOAT: np.float32,
    ParquetType.DOUBLE: np.float64,
}


@dataclass
class ColumnSpec:
    name: str
    type: ParquetType
    optional: bool = False
    converted_type: ConvertedType | None = None
    scale: int | None = None
    precision: int | None = None
    type_length: int | None = None  # FIXED_LEN_BYTE_ARRAY width


class ParquetWriter:
    """Writes Parquet files (uncompressed by default; codec="snappy",
    "gzip", "zstd", "lz4", "lz4_raw", or "brotli" enables page compression
    — an engine extension; the reference writes and reads UNCOMPRESSED
    only).

    Usage::

        w = ParquetWriter(path, [ColumnSpec("id", ParquetType.INT64)])
        w.write_row_group({"id": np.arange(100)})
        w.close()

    Column values per row group: numpy arrays for fixed types, list[bytes|str|
    None] or (offsets, chars, valid) for BYTE_ARRAY.  Nulls via None entries
    (lists) or an explicit `valid` mask passed as a tuple (values, valid).
    """

    def __init__(
        self,
        path: str,
        columns: list[ColumnSpec],
        key_value: dict[str, str] | None = None,
        codec: str | int = "uncompressed",
    ):
        self._columns = columns
        err = ct.create_string_buffer(4096)
        self._h = lib().dpq_writer_new(str(path).encode(), err, 4096)
        if not self._h:
            raise NativeError(err.value.decode())
        self._closed = False
        from .schema import CompressionCodec

        cid = (CompressionCodec[codec.upper()] if isinstance(codec, str)
               else CompressionCodec(codec))
        if cid != CompressionCodec.UNCOMPRESSED:
            check(lib().dpq_writer_codec(self._h, int(cid), err, 4096), err)
        for k, v in (key_value or {}).items():
            check(lib().dpq_writer_kv(self._h, k.encode(), v.encode(), err, 4096), err)
        for c in columns:
            conv = int(c.converted_type) if c.converted_type is not None else -1
            check(
                lib().dpq_writer_declare(
                    self._h,
                    c.name.encode(),
                    int(c.type),
                    1 if c.optional else 0,
                    conv,
                    c.scale if c.scale is not None else _INT32_MIN,
                    c.precision if c.precision is not None else _INT32_MIN,
                    c.type_length if c.type_length is not None else _INT32_MIN,
                    err,
                    4096,
                ),
                err,
            )

    def write_row_group(self, columns: dict[str, object]) -> None:
        err = ct.create_string_buffer(4096)
        if set(columns) != {c.name for c in self._columns}:
            raise ValueError("row group columns must match the declared schema")
        for spec in self._columns:
            data = columns[spec.name]
            valid = None
            if isinstance(data, tuple) and len(data) == 2:
                data, valid = data
            self._add_column(spec, data, valid, err)
        check(lib().dpq_writer_rg_end(self._h, err, 4096), err)

    def _add_column(self, spec: ColumnSpec, data, valid, err) -> None:
        def check_required(mask):
            # Nulls on a REQUIRED column would silently produce a file whose
            # page value counts disagree with its payload (readers hit a
            # cursor overrun mid-page) — reject at the API boundary instead.
            if (
                not spec.optional
                and mask is not None
                and not np.all(np.asarray(mask, bool))
            ):
                raise ValueError(
                    f"column '{spec.name}' is REQUIRED but the row group "
                    f"contains nulls (declare ColumnSpec(..., optional=True))"
                )

        def vptr(mask):
            check_required(mask)
            if mask is None:
                return None
            m = np.ascontiguousarray(np.asarray(mask, dtype=np.uint8))
            return m, m.ctypes.data_as(ct.c_void_p)

        if spec.type == ParquetType.BYTE_ARRAY:
            if isinstance(data, (list, tuple)) and not (
                isinstance(data, tuple) and len(data) == 3
            ):
                vals = list(data)
                if valid is None and any(v is None for v in vals):
                    valid = np.array([v is not None for v in vals], np.uint8)
                enc = [
                    b"" if v is None else (v.encode() if isinstance(v, str) else bytes(v))
                    for v in vals
                ]
                offs = np.zeros(len(enc) + 1, np.int64)
                np.cumsum([len(e) for e in enc], out=offs[1:])
                chars = np.frombuffer(b"".join(enc), np.uint8) if enc else np.zeros(0, np.uint8)
            else:
                offs, chars, valid = data
                offs = np.ascontiguousarray(offs, np.int64)
                chars = np.ascontiguousarray(chars, np.uint8)
            n = len(offs) - 1
            keep_v = vptr(valid)
            chars = np.ascontiguousarray(chars)
            check(
                lib().dpq_writer_col_bytes(
                    self._h,
                    keep_v[1] if keep_v else None,
                    offs.ctypes.data_as(ct.c_void_p),
                    chars.ctypes.data_as(ct.c_void_p) if chars.size else ct.c_void_p(),
                    n,
                    err,
                    4096,
                ),
                err,
            )
            return

        if spec.type == ParquetType.BOOLEAN:
            arr = np.ascontiguousarray(np.asarray(data), dtype=np.uint8)
            width = 1
        elif spec.type == ParquetType.FIXED_LEN_BYTE_ARRAY:
            # w-byte values as an [n, w] u8 array (w = declared type_length).
            # The reference reader REJECTS this type (src/reader/
            # column_reader.cpp:254-255) — a deliberate capability extension.
            if not spec.type_length:
                raise ValueError("FIXED_LEN_BYTE_ARRAY needs type_length")
            arr = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
            if arr.ndim != 2 or arr.shape[1] != spec.type_length:
                raise ValueError(
                    f"FLBA data must be an [n, {spec.type_length}] uint8 array"
                )
            width = spec.type_length
        elif spec.type == ParquetType.INT96:
            # 12-byte values as an [n, 12] u8 array (spark-style timestamps)
            arr = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
            if arr.ndim != 2 or arr.shape[1] != 12:
                raise ValueError("INT96 data must be an [n, 12] uint8 array")
            width = 12
        else:
            dtype = _FIXED_DTYPES[spec.type]
            arr = np.ascontiguousarray(np.asarray(data), dtype=dtype)
            width = arr.dtype.itemsize
        keep_v = vptr(valid)
        check(
            lib().dpq_writer_col_fixed(
                self._h,
                keep_v[1] if keep_v else None,
                arr.ctypes.data_as(ct.c_void_p),
                width,
                arr.shape[0],
                err,
                4096,
            ),
            err,
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        err = ct.create_string_buffer(4096)
        check(lib().dpq_writer_close(self._h, err, 4096), err)
        self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._closed:
            self.close()


def write_table(path: str, specs: list[ColumnSpec], row_groups: list[dict]) -> str:
    """Convenience: write a file from a list of row-group dicts."""
    w = ParquetWriter(path, specs)
    for rg in row_groups:
        w.write_row_group(rg)
    w.close()
    return str(path)


# silence linter: bindings imported for side-effectful library build
_ = bindings
