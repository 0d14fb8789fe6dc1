"""Expansion of RLE/bit-packed hybrid run descriptors, and null bookkeeping.

Port of `duckdb_parquet_parser_tpu.ops.expand` (`expand_hybrid` by its
gather method, `nonnull_mask_and_index`, `take2d`; `nonnull_mask` is its
mask alone, without the rank).  The host prescan has
already turned each page's hybrid section into a run descriptor table; here
each value finds its run (scatter-add of run starts + prefix sum), gathers
the run's attributes, and reads literal (bit-packed) values from a 4-byte
little-endian window.  The reference's select-accumulation method and
`take2d_shift` avoid slow TPU gathers; on PyTorch a gather is the plain
operation and gives identical output.
"""

from __future__ import annotations

import torch


def take2d(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`a[r, idx[r, v]]` for in-range `idx` (already clipped)."""
    return torch.gather(a, 1, idx.long())


def expand_hybrid(run_kind, run_count, run_value, run_bitoff, run_vstart,
                  section, bw, out_len: int) -> torch.Tensor:
    """Expands hybrid runs to per-value integers: [N, out_len] int32.

    run_*: [N, R] int32 (kind 0 = repeated, 1 = literal; count 0 =
    padding); section: [N, S] u8 raw bytes; bw: [N] int32 bit widths (at
    most 24, so a value sits inside one 4-byte window)."""
    n_pages, n_runs = run_count.shape
    s_pad = section.shape[1]
    dev = run_count.device
    v_iota = torch.arange(out_len, dtype=torch.int32, device=dev)[None, :]
    active = run_count > 0

    rows = torch.arange(n_pages, device=dev)[:, None].expand(n_pages, n_runs)
    cols = torch.where(active, run_vstart.clamp(0, out_len - 1), 0).long()
    marks = torch.zeros((n_pages, out_len), dtype=torch.int32, device=dev)
    marks.index_put_((rows, cols), active.to(torch.int32), accumulate=True)
    run_id = (torch.cumsum(marks, dim=1, dtype=torch.int32) - 1).clamp(
        0, n_runs - 1)
    kind_v = take2d(run_kind, run_id)
    value_v = take2d(run_value, run_id)
    bitoff_v = take2d(run_bitoff, run_id)
    vstart_v = take2d(run_vstart, run_id)

    bitpos = bitoff_v + (v_iota - vstart_v) * bw[:, None]
    byte0 = bitpos >> 3
    shift = (bitpos & 7).long()
    in_range = (byte0 >= 0) & (byte0 <= s_pad - 4)
    b0 = byte0.clamp(0, s_pad - 4)
    sec = section.long()
    # the window in int64: the same bits as the reference's uint32 math
    w = take2d(sec, b0)
    for k in (1, 2, 3):
        w = w | (take2d(sec, b0 + k) << (8 * k))
    mask = (1 << bw[:, None].long()) - 1
    literal = ((w >> shift) & mask).to(torch.int32)
    literal = torch.where(in_range, literal, 0)
    return torch.where(kind_v == 1, literal, value_v)


def nonnull_mask(def_levels, num_values, max_def: int,
                 out_len: int) -> torch.Tensor:
    """nonnull [N, V] bool: def == max_def and v < num_values."""
    v_iota = torch.arange(out_len, dtype=torch.int32,
                          device=def_levels.device)[None, :]
    return (def_levels == max_def) & (v_iota < num_values[:, None])


def nonnull_mask_and_index(def_levels, num_values, max_def: int,
                           out_len: int):
    """(nonnull as `nonnull_mask` gives it, nn_idx [N, V] int32: the
    value's rank in the page's non-null stream, meaningful only where
    nonnull)."""
    nonnull = nonnull_mask(def_levels, num_values, max_def, out_len)
    nn_idx = torch.cumsum(nonnull.to(torch.int32), dim=1,
                          dtype=torch.int32) - 1
    return nonnull, nn_idx.clamp(min=0)
