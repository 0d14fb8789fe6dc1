"""Regex page-pruning scan over a page batch, on tensors.

Port of `duckdb_parquet_parser_tpu.ops.scan`.  The host helpers are copied
here because the reference module imports its JAX decode at import time:
`PageMatchResult`, `scan_steps`, `length_buckets`, `split_payload_pages`
and the numpy `dfa_match`.  The device step
(`_device_scan_step` / `_device_scan_multi_step` in the reference) is
`device_scan_step`; the resident column (models/scan.py) drives it, and
the one-shot `ScanEngine.scan` goes through a resident column too.

Per query: PLAIN pages walk their raw payload bytes through the stream
matcher (kernel K1 for register-machine patterns); dictionary pages decode
their levels and indices and map the per-entry accepts of the pattern
through the dictionary lookup (kernel K2).  `negate` inverts the per-value
match among participating values.  Pages with a zero match count are the
pruned ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from duckdb_parquet_parser_tpu.ops.regex import (
    UnsupportedPattern,
    compile_pattern,
    like_to_regex,
)

from ..host.batch import to_tensor
from . import decode as _decode
from . import strings
from .kernels import dict_lookup, stream_matcher

SPLIT_TRIGGER = 4096  # split when any page's payload exceeds this
SPLIT_TARGET = 2048   # aim per-segment payload bytes


def dfa_match(chars, lens, table, accept) -> np.ndarray:
    """Host DFA over L values: chars [L, P] u8 (zero-padded), lens [L];
    returns [L] bool accepts."""
    tflat = np.asarray(table, dtype=np.int32).reshape(-1)
    acc = np.asarray(accept)
    lens = np.asarray(lens, dtype=np.int32)
    state = np.zeros(chars.shape[0], np.int32)
    for j in range(chars.shape[1]):
        nxt = tflat[state * 256 + chars[:, j].astype(np.int32)]
        state = np.where(j < lens, nxt, state)
    return acc[state]


def scan_steps(plen, quantum: int = 128) -> int:
    """Step bound of the walk: the max payload length rounded up to
    `quantum`."""
    m = int(np.max(plen)) if len(plen) else 1
    return max(-(-m // quantum) * quantum, 1)


def length_buckets(plen: np.ndarray, max_buckets: int = 2,
                   min_bucket: int = 1024) -> list[tuple[np.ndarray, int]]:
    """Pages sorted by payload length and split where
    sum(bucket_size x bucket_max) is least, so each bucket walks only to
    its own longest page.  Returns [(page_indices, max_steps), ...];
    buckets under `min_bucket` pages merge."""
    n = len(plen)
    order = np.argsort(plen, kind="stable")
    sorted_len = np.asarray(plen)[order].astype(np.int64)
    if n < 2 * min_bucket or max_buckets < 2:
        return [(order, max(int(sorted_len[-1]), 1) if n else 1)]
    k = np.arange(1, n)
    cost = k * sorted_len[k - 1] + (n - k) * int(sorted_len[-1])
    best = int(k[np.argmin(cost)])
    if best < min_bucket or n - best < min_bucket:
        return [(order, max(int(sorted_len[-1]), 1))]
    return [
        (order[:best], max(int(sorted_len[best - 1]), 1)),
        (order[best:], max(int(sorted_len[-1]), 1)),
    ]


@dataclass
class PageMatchResult:
    """Per-page accept counts for one scanned column batch."""

    page_gid: np.ndarray        # [N] global data-page ids
    match_counts: np.ndarray    # [N] number of accepted (non-null) values
    value_counts: np.ndarray    # [N] number of participating values

    def pruned_pages(self) -> np.ndarray:
        """Global ids of pages with NO accepted values (the reported set)."""
        return self.page_gid[self.match_counts == 0]

    def surviving_pages(self) -> np.ndarray:
        return self.page_gid[self.match_counts > 0]


def split_payload_pages(arrays, trigger: int = SPLIT_TRIGGER,
                        target: int = SPLIT_TARGET):
    """Re-chunks big PLAIN pages at value boundaries (no matcher state
    crosses a value start, so segments walk independently and a per-page
    sum of their hits is exact).  Returns (seg_payload [M, pitch] u8,
    seg_len, seg_nn, seg_page) or None when no page exceeds `trigger` or
    nothing split."""
    plen = np.asarray(arrays["page_payload_len"])
    if plen.size == 0 or int(plen.max()) <= trigger:
        return None
    from duckdb_parquet_parser_tpu.host import bindings

    dims, segs = bindings.native_split_plan(
        np.asarray(arrays["payload"]), plen, np.asarray(arrays["page_nn"]),
        np.asarray(arrays["page_kind"]), target,
    )
    if int(dims.get("split_ok", 0)) != 1 or int(dims["n_segs"]) <= plen.size:
        return None
    return (segs["seg_payload"], segs["seg_len"], segs["seg_nn"],
            segs["seg_page"])


def dict_accepts(batch, dfas) -> np.ndarray:
    """[K, DN] bool: each pattern's accept of every dictionary entry
    (host DFA; DN is 1 with a False entry when the batch has no
    dictionary)."""
    arrays = batch.arrays
    if int(batch.dims.get("dict_n", 0)) > 0 and "dict_padded" in arrays:
        return np.stack([dfa_match(arrays["dict_padded"], arrays["dict_lens"],
                                   d.table, d.accept) for d in dfas])
    return np.zeros((len(dfas), 1), bool)


def map_dict_accepts(core, tables, dict_idx):
    """Per-row accept planes from global dict-entry accept tables
    ([DN] int32 each) through the dictionary lookup.  Cells outside
    ok & nonnull are arbitrary (callers AND them out).

    The reference localizes the tables per page first when the page
    dictionaries are small (a TPU select-cost choice); the outputs agree
    on every cell that survives the caller's mask."""
    dn = tables[0].shape[0]
    base = core["page_dict_base"][:, None]
    g = (base + dict_idx.clamp(min=0)).clamp(0, dn - 1).to(torch.int32)
    return dict_lookup.dict_lookup(tables, g.contiguous())


def resolve_matchers(patterns):
    """(irs, dfa) for a walk: K register-machine IRs (the K1 kernel), or
    for one pattern outside that family its table DFA."""
    irs = [strings.pattern_ir(p) for p in patterns]
    if all(ir is not None for ir in irs):
        return tuple(irs), None
    if len(patterns) != 1:
        raise ValueError("a pattern that needs the table DFA is scanned "
                         "alone")
    return (), compile_pattern(patterns[0])


def walk_hits(payload_t, plen, nn, irs, dfa, steps) -> torch.Tensor:
    """[K, n] int32 accept counts of the byte walk."""
    if irs:
        return stream_matcher.match_stream(payload_t, plen, nn, irs, steps)[0]
    hits, _seen = strings.match_payload_stream(
        payload_t, plen, nn, dfa.table, dfa.accept, steps)
    return hits[None]


def device_scan_step(core, payload_t, plen, dict_match, *, irs, dfa,
                     vmax: int, nn_cap: int, max_def: int, negate: bool,
                     steps: int, split=None):
    """Counts of one page bucket for K patterns.

    core: DECODE_ARRAYS tensors of the bucket's N pages; payload_t: the
    [P, lanes] u8 stream; plen: [lanes] int32; dict_match: [K, DN] bool.
    With `split=(sub_nn, seg_page)` the lanes are value-boundary segments
    of the pages and their hits sum back to pages.  Returns
    (counts [K, N] int64, values [N] int64)."""
    is_dict = core["page_kind"] == 1
    nn = core["page_nn"]
    k = len(irs) if irs else 1
    if split is None:
        hits = walk_hits(payload_t, torch.where(is_dict, 0, plen),
                         torch.where(is_dict, 0, nn), irs, dfa, steps)
    else:
        sub_nn, seg = split
        seg = seg.long()
        is_dict_sub = is_dict[seg]
        hits_sub = walk_hits(payload_t, torch.where(is_dict_sub, 0, plen),
                             torch.where(is_dict_sub, 0, sub_nn), irs, dfa,
                             steps)
        hits = torch.zeros((k, nn.shape[0]), dtype=torch.int32,
                           device=nn.device).index_add_(1, seg, hits_sub)
    plain_counts = (nn[None, :] - hits) if negate else hits

    nonnull, nn_idx = _decode.decode_levels(core, max_def, vmax)
    dict_idx, ok = _decode.decode_dict_indices(core, nn_idx, nn_cap,
                                               nonnull=nonnull)
    dms = map_dict_accepts(core, [dm.to(torch.int32) for dm in dict_match],
                           dict_idx)
    valid = ok & nonnull
    counts = torch.stack([
        torch.where(is_dict, (((dm != 0) ^ negate) & valid).sum(1),
                    plain_counts[j])
        for j, dm in enumerate(dms)])
    values = torch.where(is_dict, valid.sum(1), nn)
    return counts.long(), values.long()


def prepare_patterns(patterns, *, like: bool = False):
    """(regexes, dfas) for the patterns of one query; raises
    NotImplementedError for a pattern outside the DFA subset (the
    reference's host `re` fallback is not ported)."""
    pats = [like_to_regex(p) if like else p for p in patterns]
    dfas = []
    for p in pats:
        try:
            dfas.append(compile_pattern(p))
        except UnsupportedPattern as e:
            raise NotImplementedError(
                f"pattern {p!r} is outside the DFA subset; the host `re` "
                "fallback is not ported") from e
    return pats, dfas


def transposed_stream(payload: np.ndarray, steps: int, device,
                      rows=None) -> torch.Tensor:
    """The [steps, n] u8 byte stream of payload rows `rows` (default all),
    transposed on `device`."""
    a = np.asarray(payload)[:, :steps]
    return to_tensor(a, device, rows=rows).t().contiguous()
