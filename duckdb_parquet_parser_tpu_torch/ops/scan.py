"""Regex page-pruning scan over a page batch, on tensors.

Port of `duckdb_parquet_parser_tpu.ops.scan`: the host helpers
(`PageMatchResult`, `scan_steps`, `length_buckets`, `split_payload_pages`,
the numpy `dfa_match`), the per-value scan over a pad_strings batch
(`_value_accepts`, `scan_batch`, `match_rows`) and the host `re` fallback
for patterns outside the DFA subset (`scan_batch_fallback`,
`match_rows_fallback`: a route by pattern class, never taken because a
kernel failed).  The device step (`_device_scan_step` /
`_device_scan_multi_step` in the reference) is `device_scan_step`; the
resident column and the block scans (models/scan.py) drive it, and the
one-shot `ScanEngine.scan` goes through a resident column too.

Per query: PLAIN pages walk their raw payload bytes through the stream
matcher (kernel K1 for register-machine patterns, K3's page walk for a
table DFA); dictionary pages count the per-entry accepts of the pattern
over their resident level and index planes in the dictionary kernel (K2's
fused count entry).  `negate` inverts the per-value match among
participating values.  Pages with a zero match count are the
pruned ones.
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass

import numpy as np
import torch

from ..host import bindings
from ..host.batch import to_tensor
from ..utils.tracing import annotate, stage
from . import decode as _decode
from . import strings
from .kernels import dfa_walk, dict_lookup, stream_matcher
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
    # pages skipped via ColumnIndex min/max before any decode (cold path
    # only; 0 when stats pruning did not apply)
    stats_pruned_pages: int = 0
    dict_skipped_pages: int = 0  # all-miss dict short-circuits (cold scan)

    def pruned_pages(self) -> np.ndarray:
        """Global ids of pages with NO accepted values (the reported set)."""
        return self.page_gid[self.match_counts == 0]

    def surviving_pages(self) -> np.ndarray:
        return self.page_gid[self.match_counts > 0]


def _value_accepts(batch, dfa, *, negate: bool = False, device):
    """Per-value accept / participation matrices in VALUE space, computed
    on `device`.

    Returns (emit [N, vmax] bool, participating [N, vmax] bool) tensors —
    the single source of the scan semantics: PLAIN pages participate at
    their non-null slots, dictionary pages additionally require an
    in-range index; `negate` inverts the per-value match among
    participating values.  scan_batch's page counts and match_rows' row
    sets both reduce from these, so the two stay consistent by
    construction."""
    arrays = batch.arrays
    if batch.dims.get("nn_total", 0) > 0 and "str_padded" not in arrays:
        raise ValueError("batch was prescanned without pad_strings")

    core = batch.to_device(device, _decode.DECODE_ARRAYS)
    nonnull, nn_idx = _decode.decode_levels(core, batch.max_def, batch.vmax)
    is_dict = (core["page_kind"] == 1)[:, None]
    emit = torch.zeros_like(nonnull)
    part = torch.zeros_like(nonnull)
    any_dict = bool((arrays["page_kind"] == 1).any())
    any_plain = bool((arrays["page_kind"] != 1).any())

    has_plain = "str_padded" in arrays and arrays["str_padded"].shape[0] > 0
    if has_plain and any_plain:
        match = dfa_walk.value_walk(
            to_tensor(arrays["str_padded"], device),
            to_tensor(arrays["str_lens"], device, dtype=np.int32), dfa)
        start = to_tensor(arrays["str_nn_start"][:-1], device).long()
        entry = (start[:, None] + nn_idx).clamp(0, match.shape[0] - 1)
        plain_part = nonnull & ~is_dict
        emit |= (match[entry] ^ bool(negate)) & plain_part
        part |= plain_part

    has_dict = "dict_padded" in arrays and int(batch.dims.get("dict_n", 0)) > 0
    if has_dict and any_dict:
        dict_match = dfa_walk.value_walk(
            to_tensor(arrays["dict_padded"], device),
            to_tensor(arrays["dict_lens"], device, dtype=np.int32), dfa)
        dict_idx, ok = _decode.decode_dict_indices(core, nn_idx, batch.nn_cap,
                                                   nonnull=nonnull)
        g = (core["page_dict_base"][:, None] + dict_idx.clamp(min=0)).clamp(
            0, dict_match.shape[0] - 1).to(torch.int32).contiguous()
        hit = dict_lookup.dict_lookup(dict_match.to(torch.int32)[None],
                                      g)[0] != 0
        dict_part = ok & nonnull & is_dict
        emit |= (hit ^ bool(negate)) & dict_part
        part |= dict_part
    return emit, part


def scan_batch(batch, pattern: str, *, negate: bool = False,
               device) -> PageMatchResult:
    """Evaluates `pattern` over a BYTE_ARRAY batch (prescanned with
    pad_strings > 0) on `device` and counts accepted values per page; a
    pattern outside the DFA subset takes the host `re` fallback."""
    try:
        dfa = compile_pattern(pattern)
    except UnsupportedPattern:
        return scan_batch_fallback(batch, pattern, negate=negate)

    emit, part = _value_accepts(batch, dfa, negate=negate, device=device)
    return PageMatchResult(
        page_gid=batch.arrays["page_gid"].copy(),
        match_counts=emit.sum(dim=1).cpu().numpy().astype(np.int64),
        value_counts=part.sum(dim=1).cpu().numpy().astype(np.int64),
    )


def match_rows(batch, pattern: str, *, negate: bool = False,
               device) -> np.ndarray:
    """Global row ids of the NON-NULL values matching `pattern` — the
    row-level companion to the page-pruning scan (value participation and
    negate semantics are exactly scan_batch's, so `len(match_rows(...))`
    equals `scan_batch(...).match_counts.sum()`).  Rows are absolute file
    row indices; nulls never emit.  Requires a pad_strings prescan.
    Returns a sorted int64 array."""
    try:
        dfa = compile_pattern(pattern)
    except UnsupportedPattern:
        return match_rows_fallback(batch, pattern, negate=negate)

    emit, _part = _value_accepts(batch, dfa, negate=negate, device=device)
    rows = (to_tensor(batch.arrays["page_row_start"], device,
                      dtype=np.int64)[:, None]
            + torch.arange(batch.vmax, dtype=torch.int64,
                           device=emit.device)[None, :])
    return torch.sort(rows[emit]).values.cpu().numpy()


def match_rows_fallback(batch, pattern: str, *,
                        negate: bool = False) -> np.ndarray:
    """Host `re` fallback for patterns outside the DFA subset — identical
    row sets."""
    from ..host.reader import _string_stream  # late import to avoid cycle

    rx = _re.compile(pattern.encode("utf-8", "surrogateescape"))
    pos, lens, offs, chars = _string_stream(batch)
    keep = [
        int(p)
        for p, ln, off in zip(pos, lens, offs)
        if bool(rx.search(chars[off:off + ln].tobytes())) ^ negate
    ]
    return np.asarray(sorted(keep), np.int64)


def scan_batch_fallback(batch, pattern: str, *,
                        negate: bool = False) -> PageMatchResult:
    """Host fallback (full `re` semantics) producing identical survivor sets
    for patterns the DFA subset cannot express."""
    from ..host.reader import _string_stream  # late import to avoid cycle

    rx = _re.compile(pattern.encode("utf-8", "surrogateescape"))
    pos, lens, offs, chars = _string_stream(batch)
    # page of each emission: recover from row positions via page row ranges
    row_start = batch.arrays["page_row_start"]
    page_of = np.searchsorted(row_start, pos, side="right") - 1
    n = batch.n_pages
    counts = np.zeros(n, np.int64)
    participating = np.zeros(n, np.int64)
    for p, ln, off in zip(page_of, lens, offs):
        s = chars[off:off + ln].tobytes()
        m = (rx.search(s) is not None) ^ negate
        counts[p] += m
        participating[p] += 1
    return PageMatchResult(batch.arrays["page_gid"].copy(), counts,
                           participating)


def has_big_pages(plen, trigger: int = SPLIT_TRIGGER) -> bool:
    """Whether any page's payload exceeds `trigger` bytes: such pages walk
    as value-boundary segments (`split_payload_pages`), not one a lane."""
    plen = np.asarray(plen)
    return plen.size > 0 and int(plen.max()) > trigger


@annotate("dpq.split_plan")
def split_payload_pages(arrays, trigger: int = SPLIT_TRIGGER,
                        target: int = SPLIT_TARGET):
    """Re-chunks big PLAIN pages at value boundaries (no matcher state
    crosses a value start, so segments walk independently and a per-page
    sum of their hits is exact).  Returns (seg_payload [M, pitch] u8,
    seg_len, seg_nn, seg_page) or None when no page exceeds `trigger` or
    nothing split."""
    plen = np.asarray(arrays["page_payload_len"])
    if not has_big_pages(plen, trigger):
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


def dict_table(batch, dfas, device):
    """`accept_table(dict_accepts(batch, dfas), device)` where `batch`
    holds a dictionary page; None where it holds none."""
    if not (np.asarray(batch.arrays["page_kind"]) == 1).any():
        return None
    return accept_table(dict_accepts(batch, dfas), device)


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


def resolve_matchers(patterns, dfas):
    """(irs, dfa) for a walk: K register-machine IRs (the K1 kernel), or
    for one pattern outside that family its table DFA, `dfas[0]`: the
    patterns' compiled DFAs (`prepare_patterns`) are passed in, so a query
    compiles each pattern once."""
    irs = [strings.pattern_ir(p) for p in patterns]
    if all(ir is not None for ir in irs):
        return tuple(irs), None
    if len(patterns) != 1:
        raise ValueError("a pattern that needs the table DFA is scanned "
                         "alone")
    return (), dfas[0]


def walk_hits(stream, plen, nn, irs, dfa, steps) -> torch.Tensor:
    """[K, n] int32 accept counts of the byte walk over the resident
    stream (`resident_stream`'s chunked layout): K1 for register machines,
    K3's page walk for one table DFA."""
    if irs:
        return stream_matcher.match_stream(stream, plen, nn, irs, steps)[0]
    return dfa_walk.stream_walk(stream, plen, nn, dfa, steps)[0][None]


def device_scan_step(core, stream, walk_plen, walk_nn, table, *, irs, dfa,
                     vmax: int, nn_cap: int, max_def: int, negate: bool,
                     steps: int, has_plain: bool = True,
                     has_dict: bool = True, seg=None):
    """Counts of one page bucket for K patterns.

    core: DECODE_ARRAYS tensors of the bucket's N pages (only `page_nn`
    where it holds no dictionary page); stream: the byte stream of its
    lanes in the stream matcher's chunked layout (`resident_stream`);
    walk_plen, walk_nn: [lanes] int32 payload lengths and value counts,
    zero on the lanes of dictionary pages; table: the query's [K, DN]
    uint8 accept table.  `has_plain` / `has_dict` say which page kinds
    the bucket holds: the walk runs only over PLAIN pages and the
    dictionary kernel only over dictionary pages, and a kind the bucket
    lacks costs no launch.
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
    """(regexes, dfas) for the patterns of one byte-walk query; raises
    NotImplementedError for a pattern outside the DFA subset (the resident
    column and the batched scans refuse it, as the reference's do; the
    one-shot `ScanEngine.scan` takes the host `re` fallback)."""
    pats = [like_to_regex(p) if like else p for p in patterns]
    dfas = []
    for p in pats:
        try:
            dfas.append(compile_pattern(p))
        except UnsupportedPattern as e:
            raise NotImplementedError(
                f"pattern {p!r} is outside the DFA subset; use "
                "ScanEngine.scan, which takes the host `re` fallback") from e
    return pats, dfas


def resident_stream(payload: np.ndarray, steps: int, device,
                    rows=None) -> torch.Tensor:
    """The first `steps` bytes of payload rows `rows` (default all) on
    `device`, in the stream matcher's layout: [ceil(steps / 16), n, 16] u8
    (`stream_matcher.chunk_stream` of the transposed [steps, n] stream).
    Made once at residency."""
    a = np.asarray(payload)[:, :steps]
    return stream_matcher.chunk_stream(to_tensor(a, device, rows=rows).t())


def resident_buckets(batch, device):
    """The device-side layout of a PS_PAYLOAD page batch for repeated
    walks: (buckets, split).  Pages live in LENGTH BUCKETS
    (`length_buckets`): each bucket's walk stops at its own longest page.
    Big pages (over SPLIT_TRIGGER bytes) are instead kept as value-boundary
    segments whose hits sum back to pages (`split` is then True and there
    is one bucket).  Each bucket records which page kinds it holds, so a
    query launches the walk only over PLAIN pages and the dictionary
    kernel only over dictionary pages.  A PLAIN page without a value (the
    pad pages of a sharded batch) needs no walk: its counts are zero."""
    arrays = batch.arrays
    plen = np.asarray(arrays["page_payload_len"])
    is_dict = np.asarray(arrays["page_kind"]) == 1
    nn = np.asarray(arrays["page_nn"])
    dev = torch.device(device)
    sp = split_payload_pages(arrays)
    with stage("dpq.upload"):
        if sp is not None:
            sub_payload, sub_len, sub_nn, seg_page = sp
            steps = min(scan_steps(sub_len), sub_payload.shape[1])
            plain_lane = ~is_dict[seg_page] & (sub_nn > 0)
            return [dict(
                idx=slice(None), steps=steps,
                core=batch.to_device(dev, _decode.DECODE_ARRAYS),
                stream=resident_stream(sub_payload, steps, dev),
                walk_plen=to_tensor(np.where(plain_lane, sub_len, 0), dev,
                                    dtype=np.int32),
                walk_nn=to_tensor(np.where(plain_lane, sub_nn, 0), dev,
                                  dtype=np.int32),
                seg=to_tensor(seg_page, dev, dtype=np.int64),
                has_plain=bool(plain_lane.any()),
                has_dict=bool(is_dict.any()))], True
        buckets = []
        walk_plen = np.where(is_dict, 0, plen)
        walk_nn = np.where(is_dict, 0, nn)
        for idx, steps in length_buckets(walk_plen):
            buckets.append(dict(
                idx=idx, steps=steps,
                core=batch.to_device(dev, _decode.DECODE_ARRAYS, rows=idx),
                stream=resident_stream(arrays["payload"], steps, dev,
                                       rows=idx),
                walk_plen=to_tensor(walk_plen, dev, rows=idx,
                                    dtype=np.int32),
                walk_nn=to_tensor(walk_nn, dev, rows=idx, dtype=np.int32),
                seg=None,
                has_plain=bool((walk_nn[idx] > 0).any()),
                has_dict=bool(is_dict[idx].any())))
        return buckets, False


@annotate("dpq.step")
def scan_buckets(batch, buckets, irs, dfa, dfas, negate: bool, device):
    """[K, N] match counts and [K, N] value counts (int64, on the host) of
    one walk over every bucket of `resident_buckets(batch, device)`: `irs`
    / `dfa` from `resolve_matchers`, `dfas` the K compiled patterns, whose
    accepts of the dictionary entries are computed on the host."""
    table = accept_table(dict_accepts(batch, dfas), device)
    k = len(dfas)
    counts = np.zeros((k, batch.n_pages), np.int64)
    values = np.zeros((k, batch.n_pages), np.int64)
    for bk in buckets:
        c, v = device_scan_step(
            bk["core"], bk["stream"], bk["walk_plen"], bk["walk_nn"],
            table, irs=irs, dfa=dfa, vmax=batch.vmax, nn_cap=batch.nn_cap,
            max_def=batch.max_def, negate=bool(negate), steps=bk["steps"],
            has_plain=bk["has_plain"], has_dict=bk["has_dict"],
            seg=bk["seg"])
        counts[:, bk["idx"]] = c.cpu().numpy()
        values[:, bk["idx"]] = v.cpu().numpy()[None, :]
    return counts, values
