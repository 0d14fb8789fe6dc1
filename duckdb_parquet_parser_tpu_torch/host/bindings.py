"""ctypes bindings over the port's native host library
(`libdpqhost_torch-*.so`, built by `build.py` from this package's
`host/native/`); the port's own copy of
`duckdb_parquet_parser_tpu/host/bindings.py`.

Thin, typed wrappers only — all policy lives in `reader.py` / `writer.py`.
"""

from __future__ import annotations

import ctypes as ct
import json
from typing import Any

import numpy as np

from .build import build_library

_ERRCAP = 4096

_DTYPES = {1: np.uint8, 2: np.int32, 3: np.int64}


class NativeError(RuntimeError):
    pass


def _load() -> ct.CDLL:
    lib = ct.CDLL(str(build_library()))

    lib.dpq_free.argtypes = [ct.c_void_p]
    lib.dpq_free.restype = None

    lib.dpq_open.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_size_t]
    lib.dpq_open.restype = ct.c_void_p
    lib.dpq_close.argtypes = [ct.c_void_p]
    lib.dpq_close.restype = None
    lib.dpq_meta_json.argtypes = [ct.c_void_p]
    lib.dpq_meta_json.restype = ct.c_void_p
    lib.dpq_test_page_head.argtypes = [ct.c_char_p, ct.c_int64, ct.c_int]
    lib.dpq_test_page_head.restype = ct.c_void_p
    lib.dpq_num_pages_all.argtypes = [ct.c_void_p]
    lib.dpq_num_pages_all.restype = ct.c_int64
    lib.dpq_num_data_pages.argtypes = [ct.c_void_p]
    lib.dpq_num_data_pages.restype = ct.c_int64
    lib.dpq_page_table.argtypes = [ct.c_void_p] + [ct.c_void_p] * 10
    lib.dpq_page_table.restype = None
    lib.dpq_read_range.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_int64, ct.c_void_p, ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_read_range.restype = ct.c_int
    lib.dpq_file_view.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int64)]
    lib.dpq_file_view.restype = ct.c_void_p

    lib.dpq_prescan.argtypes = [
        ct.c_void_p, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int64, ct.c_int64,
        ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64, ct.c_char_p,
        ct.c_size_t,
    ]
    lib.dpq_prescan.restype = ct.c_void_p
    lib.dpq_cold_scan.argtypes = [
        ct.c_void_p, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,
        ct.c_int32, ct.c_char_p, ct.c_void_p, ct.c_int32, ct.c_void_p,
        ct.c_void_p, ct.c_int32, ct.c_char_p, ct.c_int32, ct.c_char_p,
        ct.c_int32, ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_cold_scan.restype = ct.c_void_p
    lib.dpq_batch_free.argtypes = [ct.c_void_p]
    lib.dpq_batch_free.restype = None
    lib.dpq_batch_manifest.argtypes = [ct.c_void_p]
    lib.dpq_batch_manifest.restype = ct.c_void_p
    lib.dpq_batch_view.argtypes = [ct.c_void_p, ct.c_char_p, ct.POINTER(ct.c_int64)]
    lib.dpq_batch_view.restype = ct.c_void_p
    lib.dpq_page_stats.argtypes = [ct.c_void_p, ct.c_int32, ct.c_char_p,
                                   ct.c_size_t]
    lib.dpq_page_stats.restype = ct.c_void_p
    lib.dpq_index_plan.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_int64, ct.c_int64,
        ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_index_plan.restype = ct.c_void_p
    lib.dpq_index_build.argtypes = [
        ct.c_void_p, ct.c_int32, ct.c_int64, ct.c_int64,
        ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_index_build.restype = ct.c_void_p
    lib.dpq_split_plan.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_int64, ct.c_void_p, ct.c_void_p,
        ct.c_void_p, ct.c_int64, ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_split_plan.restype = ct.c_void_p

    lib.dpq_writer_new.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_size_t]
    lib.dpq_writer_new.restype = ct.c_void_p
    lib.dpq_writer_declare.argtypes = [
        ct.c_void_p, ct.c_char_p, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,
        ct.c_int32, ct.c_int32, ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_writer_declare.restype = ct.c_int
    lib.dpq_writer_kv.argtypes = [
        ct.c_void_p, ct.c_char_p, ct.c_char_p, ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_writer_kv.restype = ct.c_int
    lib.dpq_writer_col_fixed.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int32, ct.c_int64,
        ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_writer_col_fixed.restype = ct.c_int
    lib.dpq_writer_col_bytes.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int64,
        ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_writer_col_bytes.restype = ct.c_int
    lib.dpq_writer_rg_end.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_size_t]
    lib.dpq_writer_rg_end.restype = ct.c_int
    lib.dpq_writer_close.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_size_t]
    lib.dpq_writer_close.restype = ct.c_int
    lib.dpq_writer_abort.argtypes = [ct.c_void_p]
    lib.dpq_writer_abort.restype = None
    lib.dpq_writer_codec.argtypes = [ct.c_void_p, ct.c_int32, ct.c_char_p,
                                     ct.c_size_t]
    lib.dpq_writer_codec.restype = ct.c_int

    lib.dpq_snappy_max_compressed.argtypes = [ct.c_int64]
    lib.dpq_snappy_max_compressed.restype = ct.c_int64
    lib.dpq_snappy_compress.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int64, ct.c_char_p,
        ct.c_size_t,
    ]
    lib.dpq_snappy_compress.restype = ct.c_int64
    lib.dpq_snappy_decompress.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int64, ct.c_char_p,
        ct.c_size_t,
    ]
    lib.dpq_snappy_decompress.restype = ct.c_int

    lib.dpq_codec_supported.argtypes = [ct.c_int32]
    lib.dpq_codec_supported.restype = ct.c_int
    lib.dpq_codec_max_compressed.argtypes = [ct.c_int32, ct.c_int64]
    lib.dpq_codec_max_compressed.restype = ct.c_int64
    lib.dpq_codec_compress.argtypes = [
        ct.c_int32, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int64,
        ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_codec_compress.restype = ct.c_int64
    lib.dpq_codec_decompress.argtypes = [
        ct.c_int32, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int64,
        ct.c_char_p, ct.c_size_t,
    ]
    lib.dpq_codec_decompress.restype = ct.c_int

    return lib


_lib: ct.CDLL | None = None


def lib() -> ct.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _err_buf() -> Any:
    return ct.create_string_buffer(_ERRCAP)


def _take_str(ptr: int) -> str:
    s = ct.string_at(ptr).decode("utf-8")
    lib().dpq_free(ptr)
    return s


def test_page_head(data: bytes, fast: bool) -> str:
    """Test-only: parse one PageHeader with the fast (hand-rolled) or generic
    Thrift parser; returns the JSON description, "" if the fast parser
    rejected the layout, or "ERR:..." if the generic parser threw."""
    return _take_str(lib().dpq_test_page_head(data, len(data), int(fast)))


def check(ret: int, err: Any) -> None:
    if ret != 0:
        raise NativeError(err.value.decode("utf-8", "replace"))


def native_open(path: str) -> int:
    err = _err_buf()
    h = lib().dpq_open(path.encode(), err, _ERRCAP)
    if not h:
        raise NativeError(err.value.decode("utf-8", "replace"))
    return h


def native_meta(h: int) -> dict:
    return json.loads(_take_str(lib().dpq_meta_json(h)))


def native_page_table(h: int) -> dict[str, np.ndarray]:
    n = lib().dpq_num_pages_all(h)
    cols = {
        "header_off": np.zeros(n, np.int64),
        "data_off": np.zeros(n, np.int64),
        "size": np.zeros(n, np.int64),
        "kind": np.zeros(n, np.int32),
        "rg": np.zeros(n, np.int32),
        "col": np.zeros(n, np.int32),
        "num_values": np.zeros(n, np.int32),
        "encoding": np.zeros(n, np.int32),
        "gid": np.zeros(n, np.int64),
        "row_start": np.zeros(n, np.int64),
    }
    lib().dpq_page_table(h, *[c.ctypes.data_as(ct.c_void_p) for c in cols.values()])
    return cols


def native_file_view(h: int) -> np.ndarray | None:
    """Read-only numpy view over the reader's whole file mapping (zero
    copy).  Valid while the reader handle stays open."""
    size = ct.c_int64()
    ptr = lib().dpq_file_view(h, ct.byref(size))
    if not ptr or size.value <= 0:
        return None
    cbuf = (ct.c_uint8 * size.value).from_address(ptr)
    arr = np.frombuffer(cbuf, dtype=np.uint8)
    arr.flags.writeable = False
    return arr


def native_read_range(h: int, off: int, length: int) -> np.ndarray:
    out = np.zeros(length, np.uint8)
    err = _err_buf()
    check(lib().dpq_read_range(h, off, length, out.ctypes.data_as(ct.c_void_p), err, _ERRCAP), err)
    return out


PS_HOST_STRINGS = 1
PS_PAYLOAD = 2
PS_RUNS_ONLY = 4  # suppress materialized def_levels / idx_vals planes
PS_STR_VIEWS = 8  # zero-copy string tables (absolute file offsets, no chars)
PS_COLUMN = 16    # fully-materialized read_column arrays from the pack pass
PS_REP_LEVELS = 32  # materialize the rep_levels plane (list reconstruction)
PS_INDEX = 64     # chunked-index emission stream (idx_emit_pos/idx_emit_len)
PS_COL_ONLY = 128  # suppress per-value string tables (PS_COLUMN-only reads)
PS_DELTA_RAW = 256  # DELTA_BINARY_PACKED structure planes for the device
                    # bit-unpack + prefix-sum decode (ops/delta.py); throws
                    # on mixed delta/plain pages (host decode fallback)


class _BatchOwner:
    """Owns a native ArrayStore handle; freed when the last numpy view dies.

    Each returned array's base chain is  ndarray -> ndarray(base) -> ctypes
    buffer -> owner, so the native memory outlives every view without a
    single copy.  The free function is captured at construction — module
    globals may already be torn down when interpreter-exit GC runs."""

    __slots__ = ("_h", "_free")

    def __init__(self, h: int):
        self._h = h
        self._free = lib().dpq_batch_free

    def __del__(self):  # pragma: no cover - exercised implicitly by GC
        if self._h:
            self._free(self._h)
            self._h = 0


def native_prescan(
    h: int, leaf: int, rg0: int, rg1: int, align: int, pad_strings: int,
    flags: int = PS_HOST_STRINGS, payload_align: int = 0,
    row_lo: int = -1, row_hi: int = -1,
) -> tuple[dict, dict[str, np.ndarray]]:
    """Runs the structural pre-scan, returning (dims, arrays as numpy).

    The arrays are ZERO-COPY read-only views over the native batch memory
    (the round-1 `ct.string_at` copy cost ~1.4 GB/s over 100+ MB payload
    matrices — pure overhead on the cold path).  Lifetime is tied to the
    views via `_BatchOwner`."""
    err = _err_buf()
    b = lib().dpq_prescan(
        h, leaf, rg0, rg1, align, pad_strings, flags, payload_align, row_lo,
        row_hi, err, _ERRCAP
    )
    if not b:
        raise NativeError(err.value.decode("utf-8", "replace"))
    return _wrap_batch(b)


def _wrap_batch(b: int) -> tuple[dict, dict[str, np.ndarray]]:
    """(dims, zero-copy numpy views) over a native ArrayStore handle."""
    owner = _BatchOwner(b)
    manifest = json.loads(_take_str(lib().dpq_batch_manifest(b)))
    arrays: dict[str, np.ndarray] = {}
    for name, spec in manifest["arrays"].items():
        nbytes = ct.c_int64()
        ptr = lib().dpq_batch_view(b, name.encode(), ct.byref(nbytes))
        dtype = _DTYPES[spec["dtype"]]
        if nbytes.value:
            cbuf = (ct.c_uint8 * nbytes.value).from_address(ptr)
            cbuf._owner = owner  # ctypes instances carry attributes
            arr = np.frombuffer(cbuf, dtype=dtype).reshape(spec["shape"])
            arr.flags.writeable = False
        else:
            arr = np.zeros(spec["shape"], dtype)
        arrays[name] = arr
    return manifest["dims"], arrays


def native_index_plan(pos: np.ndarray, lens: np.ndarray, num_rows: int,
                      chunk_size: int) -> tuple[dict, dict[str, np.ndarray]]:
    """Chunked-index boundary plan over a PS_INDEX emission stream — one
    sequential native sweep (exact reference flush-before-append semantics,
    reference src/main.cpp:21-32).  `pos`/`lens` are the prescan batch's
    idx_emit_pos/idx_emit_len arrays (len -1 slots are skipped)."""
    assert pos.dtype == np.int64 and lens.dtype == np.int32
    err = _err_buf()
    b = lib().dpq_index_plan(
        pos.ctypes.data_as(ct.c_void_p), lens.ctypes.data_as(ct.c_void_p),
        len(pos), num_rows, chunk_size, err, _ERRCAP,
    )
    if not b:
        raise NativeError(err.value.decode("utf-8", "replace"))
    return _wrap_batch(b)


def native_index_build(reader_handle, leaf_idx: int, num_rows: int,
                       chunk_size: int) -> tuple[dict, dict[str, np.ndarray]]:
    """Fused chunked-index build straight off an open reader
    (dpq_index.hpp::Reader::index_build): header walk + emission + boundary
    plan in ONE native pass — same output contract as native_index_plan
    (positions/lens/chunk_of_entry/tuple_to_chunk/chunk_starts + dims)."""
    err = _err_buf()
    b = lib().dpq_index_build(reader_handle, leaf_idx, num_rows, chunk_size,
                              err, _ERRCAP)
    if not b:
        raise NativeError(err.value.decode("utf-8", "replace"))
    return _wrap_batch(b)


def native_split_plan(payload: np.ndarray, plen: np.ndarray, nn: np.ndarray,
                      kind: np.ndarray, target: int
                      ) -> tuple[dict, dict[str, np.ndarray]]:
    """Value-boundary payload split plan (dpq_scan.hpp::split_payload_plan):
    seg_page/seg_off/seg_len/seg_nn arrays re-chunking big PLAIN pages at
    value starts for the device streaming matcher."""
    payload = np.ascontiguousarray(payload, np.uint8)
    plen = np.ascontiguousarray(plen, np.int32)
    nn = np.ascontiguousarray(nn, np.int32)
    kind = np.ascontiguousarray(kind, np.int32)
    err = _err_buf()
    b = lib().dpq_split_plan(
        payload.ctypes.data_as(ct.c_void_p), payload.shape[0],
        payload.shape[1], plen.ctypes.data_as(ct.c_void_p),
        nn.ctypes.data_as(ct.c_void_p), kind.ctypes.data_as(ct.c_void_p),
        int(target), err, _ERRCAP,
    )
    if not b:
        raise NativeError(err.value.decode("utf-8", "replace"))
    return _wrap_batch(b)


def snappy_compress(data: bytes | np.ndarray) -> bytes:
    """Raw-format Snappy compression (native codec; engine extension)."""
    src = np.frombuffer(bytes(data), np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data, np.uint8)
    cap = int(lib().dpq_snappy_max_compressed(len(src)))
    out = np.zeros(cap, np.uint8)
    err = _err_buf()
    n = lib().dpq_snappy_compress(
        src.ctypes.data_as(ct.c_void_p), len(src),
        out.ctypes.data_as(ct.c_void_p), cap, err, _ERRCAP,
    )
    if n < 0:
        raise NativeError(err.value.decode("utf-8", "replace"))
    return out[:n].tobytes()


def snappy_decompress(data: bytes | np.ndarray, out_len: int) -> bytes:
    """Raw-format Snappy decompression into exactly out_len bytes."""
    src = np.frombuffer(bytes(data), np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data, np.uint8)
    out = np.zeros(max(out_len, 1), np.uint8)
    err = _err_buf()
    check(lib().dpq_snappy_decompress(
        src.ctypes.data_as(ct.c_void_p), len(src),
        out.ctypes.data_as(ct.c_void_p), out_len, err, _ERRCAP,
    ), err)
    return out[:out_len].tobytes()


def codec_supported(codec: int) -> bool:
    """Whether the native library was built with this page codec."""
    return bool(lib().dpq_codec_supported(int(codec)))


def codec_compress(codec: int, data: bytes | np.ndarray) -> bytes:
    """Compress a page payload with any supported codec (engine extension)."""
    src = np.frombuffer(bytes(data), np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data, np.uint8)
    cap = int(lib().dpq_codec_max_compressed(int(codec), len(src)))
    out = np.zeros(max(cap, 1), np.uint8)
    err = _err_buf()
    n = lib().dpq_codec_compress(
        int(codec), src.ctypes.data_as(ct.c_void_p), len(src),
        out.ctypes.data_as(ct.c_void_p), cap, err, _ERRCAP,
    )
    if n < 0:
        raise NativeError(err.value.decode("utf-8", "replace"))
    return out[:n].tobytes()


def codec_decompress(codec: int, data: bytes | np.ndarray,
                     out_len: int) -> bytes:
    """Decompress a page payload into exactly out_len bytes."""
    src = np.frombuffer(bytes(data), np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data, np.uint8)
    out = np.zeros(max(out_len, 1), np.uint8)
    err = _err_buf()
    check(lib().dpq_codec_decompress(
        int(codec), src.ctypes.data_as(ct.c_void_p), len(src),
        out.ctypes.data_as(ct.c_void_p), out_len, err, _ERRCAP,
    ), err)
    return out[:out_len].tobytes()


def native_page_stats(h: int, leaf: int) -> tuple[dict, dict[str, np.ndarray]]:
    """Page Index (ColumnIndex/OffsetIndex) per-data-page stats (see
    native/dpq_pageindex.hpp); returns (dims, arrays) aligned with global
    page ids."""
    err = _err_buf()
    b = lib().dpq_page_stats(h, leaf, err, _ERRCAP)
    if not b:
        raise NativeError(err.value.decode("utf-8", "replace"))
    return _wrap_batch(b)


def native_cold_scan(
    h: int, leaf: int, rg0: int, rg1: int, *, negate: bool, exact: bool = True,
    needles: list[bytes] | None = None,
    table: np.ndarray | None = None, accept: np.ndarray | None = None,
    prune_range: tuple[bytes, bytes | None] | None = None,
) -> tuple[dict, dict[str, np.ndarray]]:
    """Fused cold-path regex scan (see native/dpq_scan.hpp); returns
    (dims, {page_gid, match_counts, value_counts}).  exact=False turns
    match_counts into 0/1 survivor indicators (same page sets, faster).
    `prune_range` = (lo, hi-or-None) from ops/regex.anchored_prune_range
    (sound only for non-negated scans; the native side ignores it under
    negation) enables ColumnIndex stats pruning: pages whose [min, max]
    cannot intersect [lo, hi) are skipped before any decode;
    dims["stats_pruned_pages"] reports how many."""
    err = _err_buf()
    lo = prune_range[0] if prune_range else None
    hi = (prune_range[1] or None) if prune_range else None
    lo_len = len(lo) if lo else 0
    hi_len = len(hi) if hi else 0
    if needles:
        buf = b"".join(needles)
        lens = np.array([len(x) for x in needles], np.int32)
        b = lib().dpq_cold_scan(
            h, leaf, rg0, rg1, int(negate), int(exact), buf,
            lens.ctypes.data_as(ct.c_void_p), len(needles), None, None, 0,
            lo, lo_len, hi, hi_len, err, _ERRCAP,
        )
    else:
        t = np.ascontiguousarray(table, np.int32)
        a = np.ascontiguousarray(accept, np.uint8)
        b = lib().dpq_cold_scan(
            h, leaf, rg0, rg1, int(negate), int(exact), None, None, 0,
            t.ctypes.data_as(ct.c_void_p), a.ctypes.data_as(ct.c_void_p),
            t.shape[0], lo, lo_len, hi, hi_len, err, _ERRCAP,
        )
    if not b:
        raise NativeError(err.value.decode("utf-8", "replace"))
    return _wrap_batch(b)
