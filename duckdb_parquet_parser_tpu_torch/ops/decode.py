"""Vectorized page decode on tensors: levels, dictionary indices and
fixed-width values.

Port of `duckdb_parquet_parser_tpu.ops.decode`.  Values move through int32
planes (an INT64 / DOUBLE value is two little-endian int32 lanes, INT32 /
FLOAT one, INT96 three): the decode never does arithmetic on a decoded
value, only moves it, and the host reassembles the dtype by viewing the
plane stack as little-endian bytes (`planes_to_array`), so NaN payloads and
`-0.0` survive bit for bit.

Per batch of N pages (V = padded values a page, K = padded non-nulls):
  1. definition levels  <- the materialized plane, or run expansion
  2. null bookkeeping   <- nonnull mask + prefix-sum rank (expand.py)
  3a. PLAIN fixed       <- gather plane[nn_idx] (REQUIRED: the identity)
  3b. PLAIN boolean     <- bit nn_idx of the page's packed bit stream
  3c. dictionary        <- index plane, then the dictionary kernel's gather
                           entry (K2, ops/kernels/dict_lookup.dict_lookup)
                           over one [P, DN] table; an out-of-range index
                           decodes to NULL

When the prescan materialized the value-space planes (`def_levels`,
`idx_vals`, its default) the regex scan's dictionary kernel reads them as
they lie (`dict_lookup.dict_count`) and no level decode runs per query; run
expansion with the rank of each non-null value is the path for PS_RUNS_ONLY
batches.

The reference's `take2d_shift` / `max_null_shift` null scatter, its
`def_literal` / `idx_literal` switches and its per-page local tables
(`dict_planes_pp`, `dict_lookup_local` / `dict_lookup_select`,
`SELECT_DICT_MAX`) are cost choices of the TPU with identical outputs; a
gather is the plain operation here and they are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .expand import expand_hybrid, nonnull_mask_and_index, take2d

# Arrays the core decode consumes (subset of the pre-scan batch contract).
DECODE_ARRAYS = [
    "page_num_values", "page_nn", "page_kind", "page_def_bw", "page_idx_bw",
    "page_dict_base", "page_dict_size",
    "def_run_kind", "def_run_count", "def_run_value", "def_run_bitoff",
    "def_run_vstart", "def_bytes",
    "idx_run_kind", "idx_run_count", "idx_run_value", "idx_run_bitoff",
    "idx_run_vstart", "idx_bytes",
    # materialized planes (pre-scan default; absent under PS_RUNS_ONLY)
    "def_levels", "idx_vals",
]


def fixed_planes_from_bytes(raw: np.ndarray, width: int) -> list[np.ndarray]:
    """Host-side: [N, K*width] u8 -> list of [N, K] i32 little-endian planes."""
    n = raw.shape[0]
    k = raw.shape[1] // max(width, 1)
    if width == 0:
        return []
    i32 = raw.view("<i4").reshape(n, k, width // 4)
    return [np.ascontiguousarray(i32[:, :, j]) for j in range(width // 4)]


def dict_planes_from_bytes(raw: np.ndarray, width: int) -> list[np.ndarray]:
    """Host-side: [DN, width] u8 -> list of [DN] i32 planes (width==1: bool)."""
    if width == 1:  # boolean dictionary entries are stored one byte each
        return [raw.reshape(-1).astype(np.int32)]
    i32 = raw.view("<i4").reshape(raw.shape[0], width // 4)
    return [np.ascontiguousarray(i32[:, j]) for j in range(width // 4)]


def planes_to_array(planes, dtype: np.dtype) -> np.ndarray:
    """Reassemble i32 planes into the target little-endian dtype."""
    stack = np.stack([np.asarray(p, dtype="<i4") for p in planes], axis=-1)
    flat = stack.view(np.uint8).reshape(*stack.shape[:-1], stack.shape[-1] * 4)
    itemsize = np.dtype(dtype).itemsize
    return flat[..., :itemsize].copy().view(dtype).reshape(stack.shape[:-1])


def fit_columns(a: torch.Tensor, out_len: int, fill: int) -> torch.Tensor:
    """Columns [0, out_len) of `a`, padded with `fill` when it is
    narrower."""
    if a.shape[1] >= out_len:
        return a[:, :out_len]
    pad = torch.full((a.shape[0], out_len - a.shape[1]), fill,
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=1)


def decode_levels(arrays, max_def: int, out_len: int):
    """(nonnull [N, V] bool, nn_idx [N, V] int32) from the definition
    levels of each page.  The rank `nn_idx` costs a prefix sum over the
    plane; only the run-expansion route of `decode_dict_indices` reads it,
    so the scan calls this on PS_RUNS_ONLY batches alone."""
    num_values = arrays["page_num_values"]
    if max_def > 0 and "def_levels" in arrays:
        levels = fit_columns(arrays["def_levels"], out_len, 0).to(torch.int32)
    elif max_def > 0:
        levels = expand_hybrid(
            arrays["def_run_kind"], arrays["def_run_count"],
            arrays["def_run_value"], arrays["def_run_bitoff"],
            arrays["def_run_vstart"], arrays["def_bytes"],
            arrays["page_def_bw"], out_len,
        )
    else:
        levels = torch.zeros((num_values.shape[0], out_len),
                             dtype=torch.int32, device=num_values.device)
    return nonnull_mask_and_index(levels, num_values, max_def, out_len)


def decode_dict_indices(arrays, nn_idx, nn_len: int, nonnull=None):
    """(dict_idx [N, V] int32, ok [N, V] bool) per row.

    The materialized `idx_vals` plane is value-space (-1 at nulls and
    padding).  The run-expansion path maps non-null ranks to rows; its
    null and pad cells point at a neighbouring index, so pass `nonnull` to
    bound them (callers that omit it must AND `ok` with their own mask)."""
    if "idx_vals" in arrays:
        dict_idx = fit_columns(arrays["idx_vals"], nn_idx.shape[1], -1).to(
            torch.int32)
    else:
        idx_stream = expand_hybrid(
            arrays["idx_run_kind"], arrays["idx_run_count"],
            arrays["idx_run_value"], arrays["idx_run_bitoff"],
            arrays["idx_run_vstart"], arrays["idx_bytes"],
            arrays["page_idx_bw"], nn_len,
        )
        dict_idx = take2d(idx_stream, nn_idx.clamp(0, nn_len - 1))
        if nonnull is not None:
            dict_idx = torch.where(nonnull, dict_idx, -1)
    ok = (dict_idx >= 0) & (dict_idx < arrays["page_dict_size"][:, None])
    return dict_idx, ok


def _lookup_values(arrays, dict_planes, dict_idx) -> list[torch.Tensor]:
    """Dictionary values of the in-page indices `dict_idx` [N, V]: one
    [N, V] int32 tensor per plane of `dict_planes` ([P, DN] int32, all
    pages' dictionaries concatenated; a sequence of [DN] planes is stacked
    here).  The page's base is added and the index clipped into the table;
    the gather is the dictionary kernel's (K2's gather entry)."""
    from .kernels import dict_lookup

    if not isinstance(dict_planes, torch.Tensor):
        if not len(dict_planes):
            return []
        dict_planes = torch.stack(list(dict_planes))
    dn = dict_planes.shape[1]
    gidx = (arrays["page_dict_base"][:, None] + dict_idx.clamp(min=0)).clamp(
        0, dn - 1).to(torch.int32).contiguous()
    return list(dict_lookup.dict_lookup(dict_planes, gidx).unbind(0))


def decode_fixed(arrays, plain_planes, dict_planes, bool_bits, *,
                 max_def: int, out_len: int, nn_len: int, mode: str):
    """Decodes a batch of fixed-width (or boolean) pages, all tensors on
    one device.

    arrays: DECODE_ARRAYS tensors; plain_planes: list of [N, K] int32 (may
    be empty); dict_planes: [P, DN] int32 or a list of [DN] int32 (may be
    empty); bool_bits: [N, B] u8 or None; mode: "plain" | "dict" | "mixed".
    Returns (planes: list of [N, V] int32, nonnull: [N, V] bool); masked
    cells are zero."""
    if mode == "dict" and "idx_vals" in arrays:
        # Level-free dictionary path: the value-space index plane is -1 at
        # nulls and at padding, so (0 <= idx < dict_size) is the validity
        # and neither the levels nor the rank are needed.
        dict_idx = fit_columns(arrays["idx_vals"], out_len, -1).to(
            torch.int32)
        ok = (dict_idx >= 0) & (dict_idx < arrays["page_dict_size"][:, None])
        vals = _lookup_values(arrays, dict_planes, dict_idx)
        return [torch.where(ok, p, 0) for p in vals], ok

    identity = (max_def == 0 and bool_bits is None and len(plain_planes) > 0
                and plain_planes[0].shape[1] >= out_len)
    if mode == "plain" and identity:
        # REQUIRED PLAIN columns: every value below the page's count is
        # present and its non-null rank is its row index, so the decode is
        # a view of the planes under the count mask; no levels, no rank
        # (eager PyTorch would compute them for nothing, where the
        # reference's compiler drops them as dead code)
        num_values = arrays["page_num_values"]
        valid = torch.arange(out_len, dtype=torch.int32,
                             device=num_values.device)[None, :] \
            < num_values[:, None]
        return [torch.where(valid, p[:, :out_len], 0)
                for p in plain_planes], valid

    nonnull, nn_idx = decode_levels(arrays, max_def, out_len)
    gather_idx = nn_idx.clamp(0, max(nn_len - 1, 0))

    plain_vals = None
    if mode in ("plain", "mixed"):
        if bool_bits is not None:
            byte = take2d(bool_bits.to(torch.int32), gather_idx >> 3)
            plain_vals = [(byte >> (gather_idx & 7)) & 1]
        elif identity:
            # REQUIRED columns: the non-null rank is the row index, so the
            # gather is the identity
            plain_vals = [p[:, :out_len] for p in plain_planes]
        else:
            plain_vals = [take2d(p, gather_idx) for p in plain_planes]

    dict_vals = dict_ok = None
    if mode in ("dict", "mixed"):
        dict_idx, dict_ok = decode_dict_indices(arrays, nn_idx, nn_len,
                                                nonnull=nonnull)
        dict_vals = _lookup_values(arrays, dict_planes, dict_idx) or None

    def finish(planes, valid):
        return [torch.where(valid, p, 0) for p in planes], valid

    if mode == "plain":
        return finish(plain_vals, nonnull)
    if mode == "dict":
        return finish(dict_vals, nonnull & dict_ok)
    # mixed: per-page select
    is_dict = arrays["page_kind"][:, None] == 1
    n_planes = len(plain_vals or dict_vals or ())
    zeros = torch.zeros(nonnull.shape, dtype=torch.int32,
                        device=nonnull.device)
    planes = [torch.where(is_dict, dict_vals[j] if dict_vals else zeros,
                          plain_vals[j] if plain_vals else zeros)
              for j in range(n_planes)]
    return finish(planes, torch.where(is_dict, nonnull & dict_ok, nonnull))


def upload_fixed(arrays, plain_planes, dict_planes, bool_bits, device):
    """The inputs of `decode_fixed` as tensors on `device`: (core,
    plain_planes, dict_table, bool_bits).  Numpy arrays are copied there,
    tensors moved (a tensor already on `device` is taken as it is); the
    dictionary planes are stacked into one contiguous [P, DN] int32 table
    here, once, so a decode stacks nothing per call."""
    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        return torch.from_numpy(np.array(a, order="C")).to(device)

    core = {k: put(arrays[k]) for k in DECODE_ARRAYS if k in arrays}
    plain = [put(p) for p in plain_planes]
    if isinstance(dict_planes, torch.Tensor):
        table = dict_planes.to(device)
    elif len(dict_planes):
        table = torch.stack([put(p) for p in dict_planes]).contiguous()
    else:
        table = []
    return core, plain, table, None if bool_bits is None else put(bool_bits)


def decode_fixed_device(arrays, plain_planes, dict_planes, bool_bits, *,
                        max_def: int, out_len: int, nn_len: int, mode: str,
                        device):
    """`decode_fixed` on `device`; accepts numpy arrays or tensors (see
    `upload_fixed`, which a caller that decodes a batch repeatedly calls
    once itself).  On CUDA the dictionary lookup launches its kernel or
    raises."""
    core, plain, table, bits = upload_fixed(arrays, plain_planes,
                                            dict_planes, bool_bits, device)
    return decode_fixed(core, plain, table, bits, max_def=max_def,
                        out_len=out_len, nn_len=nn_len, mode=mode)
