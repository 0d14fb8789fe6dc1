"""Definition levels and dictionary indices of a page batch, on tensors.

Port of `duckdb_parquet_parser_tpu.ops.decode` (`decode_levels`,
`decode_dict_indices`, `DECODE_ARRAYS`) — the decode pieces the regex scan
runs for dictionary pages.  When the prescan materialized the value-space
planes (`def_levels`, `idx_vals`, its default) they are consumed directly;
run expansion (ops/expand.py) is the path for PS_RUNS_ONLY batches.
"""

from __future__ import annotations

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


def _fit(a: torch.Tensor, out_len: int, fill: int) -> torch.Tensor:
    """Columns [0, out_len) of `a`, padded with `fill` when it is
    narrower."""
    if a.shape[1] >= out_len:
        return a[:, :out_len]
    pad = torch.full((a.shape[0], out_len - a.shape[1]), fill,
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=1)


def decode_levels(arrays, max_def: int, out_len: int):
    """(nonnull [N, V] bool, nn_idx [N, V] int32) from the definition
    levels of each page."""
    num_values = arrays["page_num_values"]
    if max_def > 0 and "def_levels" in arrays:
        levels = _fit(arrays["def_levels"], out_len, 0).to(torch.int32)
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
        dict_idx = _fit(arrays["idx_vals"], nn_idx.shape[1], -1).to(
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
