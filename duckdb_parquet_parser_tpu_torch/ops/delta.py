"""DELTA_BINARY_PACKED decode on tensors.

Port of `duckdb_parquet_parser_tpu.ops.delta`.  The host prescan
(PS_DELTA_RAW, native/dpq_prescan.hpp) emits structure planes only — per
miniblock its bit width, min-delta and live count, the page's first value,
and the raw bit-packed bytes — and the values are rebuilt here:

  * the packed bytes are read as little-endian 64-bit words; delta j of a
    miniblock of width bw sits at bits [j*bw, (j+1)*bw), so it is one or
    two gathered words, a logical shift and a mask (`>>` on int64 is
    arithmetic: the shift is made logical and the mask comes after it);
  * delta = min_delta + unpacked, zero past each miniblock's live count
    (padding must not accumulate min_delta);
  * one prefix sum along the value axis of the [n_pages, 1 + mb_cap *
    mb_values] matrix, position 0 holding a zero (the page's first value is
    added to every position), all in int64, where two's-complement wrap is
    what the format asks for;
  * the int64 values split into the decode's canonical nn-space planes
    ([n_pages, out_len] int32 per 4-byte lane: lo, hi) by a view, so null
    placement, validity and row accounting go through `decode_fixed`
    unchanged.

The reference specializes the unpack per distinct bit width and does the
64-bit arithmetic on paired uint32 planes with carries, because its machine
has slow gathers and no 64-bit integers; both are cost choices with
identical outputs and are not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import bindings
from . import decode as _decode

_INT64_MAX = 0x7FFFFFFFFFFFFFFF


def delta_bws(arrays) -> tuple[int, ...]:
    """The distinct miniblock bit widths of a PS_DELTA_RAW batch
    (host-side)."""
    bw = np.asarray(arrays["delta_bw"])
    cnt = np.asarray(arrays["delta_cnt"])
    return tuple(sorted(int(b) for b in np.unique(bw[cnt > 0])))


def _shift_right_logical(x: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """`x >> sh` on int64 bit patterns with zero fill, sh in [0, 63]."""
    return torch.where(sh > 0,
                       ((x >> 1) & _INT64_MAX) >> (sh - 1).clamp(min=0), x)


def decode_delta_planes(arrays, dims, out_len: int, n_planes: int):
    """PS_DELTA_RAW structure planes (tensors on one device) -> nn-space
    value planes ([P, out_len] int32 x n_planes; [lo] for INT32, [lo, hi]
    for INT64)."""
    mbv = int(dims["delta_mb_values"])
    mbc = int(dims["delta_mb_cap"])
    pitch = int(dims["delta_pitch"])
    raw = arrays["delta_bytes"]
    n = raw.shape[0]
    dev = raw.device
    n_words = pitch // 8
    # little-endian 64-bit words of each miniblock's packed bytes
    words = raw.reshape(n, mbc, n_words, 8).contiguous().view(
        torch.int64).reshape(n, mbc, n_words)

    bw = arrays["delta_bw"].long()[:, :, None]            # [P, mbc, 1]
    cnt = arrays["delta_cnt"][:, :, None]
    md = ((arrays["delta_md_hi"].long() << 32)
          | (arrays["delta_md_lo"].long() & 0xFFFFFFFF))[:, :, None]

    j = torch.arange(mbv, dtype=torch.int64, device=dev)[None, None, :]
    bitpos = j * bw                                       # [P, mbc, mbv]
    w0 = (bitpos >> 6).clamp(max=n_words - 1)
    sh = bitpos & 63
    lo = _shift_right_logical(torch.gather(words, 2, w0), sh)
    # the bits that spill into the next word (none when sh == 0)
    w1 = torch.gather(words, 2, (w0 + 1).clamp(max=n_words - 1))
    hi = torch.where(sh > 0, w1 << ((64 - sh) & 63), 0)
    mask = torch.where(bw >= 64, -1, ~(-1 << bw.clamp(max=63)))
    unpacked = (lo | hi) & mask

    live = j < cnt
    delta = torch.where(live, unpacked + md, 0)

    # a zero at position 0 (the page's first value), then ONE prefix sum
    flat = torch.cat([torch.zeros((n, 1), dtype=torch.int64, device=dev),
                      delta.reshape(n, mbc * mbv)], dim=1)
    first = ((arrays["delta_first_hi"].long() << 32)
             | (arrays["delta_first_lo"].long() & 0xFFFFFFFF))[:, None]
    values = torch.cumsum(flat, dim=1) + first
    values = _decode.fit_columns(values, out_len, 0).contiguous()
    lanes = values.view(torch.int32).reshape(n, out_len, 2)
    return [lanes[:, :, k].contiguous() for k in range(min(n_planes, 2))]


def read_delta_column(reader, column: str, *, device):
    """End-to-end decoded column for a DELTA_BINARY_PACKED INT32 / INT64
    column: PS_DELTA_RAW prescan -> bit unpack and prefix sum on `device`
    -> the unchanged `decode_fixed` null / validity machinery.  Raises
    NativeError on non-delta or mixed files (callers use read_column's
    host path there)."""
    batch = reader.prescan(column, flags=bindings.PS_DELTA_RAW)
    if "delta_bw" not in batch.arrays:
        raise bindings.NativeError("column carries no DELTA_BINARY_PACKED "
                                   "pages")
    n_planes = 2 if int(batch.dims["plain_w"]) == 8 else 1
    arrays = batch.to_device(device, [k for k in batch.arrays
                                      if k.startswith("delta_")])
    planes = decode_delta_planes(arrays, batch.dims, batch.nn_cap, n_planes)
    return _materialize_fixed_with_planes(batch, planes, device)


def _materialize_fixed_with_planes(batch, planes, device):
    """`host.reader._materialize_fixed` with the PLAIN value planes given
    (tensors on `device`) instead of taken from the batch."""
    from ..host.reader import _flatten_decoded

    dplanes, nonnull = _decode.decode_fixed_device(
        batch.arrays, planes, [], None, max_def=batch.max_def,
        out_len=batch.vmax, nn_len=batch.nn_cap, mode="plain", device=device)
    return _flatten_decoded(batch, dplanes, nonnull)
