"""Regex page-pruning scan over a page batch, on tensors.

Port of `duckdb_parquet_parser_tpu.ops.scan`.  The host helpers are copied
here because the reference module imports its JAX decode at import time:
`PageMatchResult`, `scan_steps`, `length_buckets`, `split_payload_pages`
and the numpy `dfa_match`.  The device step
(`_device_scan_step` / `_device_scan_multi_step` in the reference) is
`device_scan_step`; the resident column (models/scan.py) drives it, and
the one-shot `ScanEngine.scan` goes through a resident column too.

Per query: PLAIN pages walk their raw payload bytes through the stream
matcher (kernel K1 for register-machine patterns); dictionary pages count
the per-entry accepts of the pattern over their resident level and index
planes in the dictionary kernel (K2's fused count entry).  `negate` inverts the per-value
match among participating values.  Pages with a zero match count are the
pruned ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..host import bindings
from ..host.batch import to_tensor
from . import decode as _decode
from . import strings
from .kernels import dict_lookup, stream_matcher
from .regex import UnsupportedPattern, compile_pattern, like_to_regex

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


def accept_table(dict_match: np.ndarray, device) -> torch.Tensor:
    """The [K, DN] uint8 accept table of one query on `device`, from
    `dict_accepts`' bools."""
    return to_tensor(np.asarray(dict_match).view(np.uint8), device)


def dict_counts(core, table, *, vmax: int, nn_cap: int, max_def: int,
                negate: bool):
    """(counts [K, N] int32, values [N] int32) of the dictionary pages of
    a bucket (0 for its other pages), from the [K, DN] uint8 accept table.

    A batch with the materialized value-space planes goes through the
    fused count kernel (K2's `dict_count`) in one launch.  A PS_RUNS_ONLY
    batch expands its runs, ranks its non-null values, and maps the
    accepts through K2's gather entry.  The reference localizes the tables
    per page first when the page dictionaries are small (a select-cost
    choice of its machine); the counts agree."""
    if "idx_vals" in core and (max_def == 0 or "def_levels" in core):
        return dict_lookup.dict_count(
            core["idx_vals"], core.get("def_levels"), core["page_num_values"],
            core["page_kind"], core["page_dict_base"], core["page_dict_size"],
            table, vmax=vmax, max_def=max_def, negate=negate)
    nonnull, nn_idx = _decode.decode_levels(core, max_def, vmax)
    dict_idx, ok = _decode.decode_dict_indices(core, nn_idx, nn_cap,
                                               nonnull=nonnull)
    dn = table.shape[1]
    g = (core["page_dict_base"][:, None] + dict_idx.clamp(min=0)).clamp(
        0, dn - 1).to(torch.int32)
    accept = dict_lookup.dict_lookup(table.to(torch.int32),
                                     g.contiguous()) != 0
    valid = ok & nonnull & (core["page_kind"] == 1)[:, None]
    counts = ((accept ^ bool(negate)) & valid[None]).sum(2)
    return counts.to(torch.int32), valid.sum(1).to(torch.int32)


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


def walk_hits(stream, plen, nn, irs, dfa, steps) -> torch.Tensor:
    """[K, n] int32 accept counts of the byte walk over the resident
    stream (`resident_stream`'s chunked layout).  The table-DFA walk is
    plain PyTorch over the [steps, n] stream, which it unpacks here."""
    if irs:
        return stream_matcher.match_stream(stream, plen, nn, irs, steps)[0]
    hits, _seen = strings.match_payload_stream(
        stream_matcher.unchunk_stream(stream, steps), plen, nn, dfa.table,
        dfa.accept, steps)
    return hits[None]


def device_scan_step(core, stream, walk_plen, walk_nn, table, *, irs, dfa,
                     vmax: int, nn_cap: int, max_def: int, negate: bool,
                     steps: int, has_plain: bool = True,
                     has_dict: bool = True, seg=None):
    """Counts of one page bucket for K patterns.

    core: DECODE_ARRAYS tensors of the bucket's N pages; stream: the
    resident byte stream of its lanes (`resident_stream`); walk_plen,
    walk_nn: [lanes] int32 payload lengths and value counts, zero on the
    lanes of dictionary pages; table: the query's [K, DN] uint8 accept
    table.  `has_plain` / `has_dict` say which page kinds the bucket holds:
    the walk runs only over PLAIN pages and the dictionary kernel only
    over dictionary pages, and a kind the bucket lacks costs no launch.
    With `seg` ([lanes] int64) the lanes are value-boundary segments of
    the pages and their hits sum back to pages.  Returns (counts [K, N],
    values [N]), integer tensors."""
    nn = core["page_nn"]
    walk = has_plain or not has_dict
    if walk:
        hits = walk_hits(stream, walk_plen, walk_nn, irs, dfa, steps)
        if seg is not None:
            hits = torch.zeros((hits.shape[0], nn.shape[0]),
                               dtype=torch.int32,
                               device=nn.device).index_add_(1, seg, hits)
        plain_counts = (nn[None, :] - hits) if negate else hits
        if not has_dict:
            return plain_counts, nn
    counts, values = dict_counts(core, table, vmax=vmax, nn_cap=nn_cap,
                                 max_def=max_def, negate=negate)
    if not walk:
        return counts, values
    is_dict = core["page_kind"] == 1
    return (torch.where(is_dict, counts, plain_counts),
            torch.where(is_dict, values, nn))


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


def resident_stream(payload: np.ndarray, steps: int, device,
                    rows=None) -> torch.Tensor:
    """The first `steps` bytes of payload rows `rows` (default all) on
    `device`, in the stream matcher's layout: [ceil(steps / 16), n, 16] u8
    (`stream_matcher.chunk_stream` of the transposed [steps, n] stream).
    Made once at residency."""
    a = np.asarray(payload)[:, :steps]
    return stream_matcher.chunk_stream(to_tensor(a, device, rows=rows).t())
