"""ScanEngine and ResidentColumn — the port's front door for regex page
pruning over a BYTE_ARRAY column.

Port of `duckdb_parquet_parser_tpu.models.scan` (`ScanEngine.__init__ /
resident / scan / cold_scan`, `ResidentColumn`).  The flow: prescan the
column on the host, upload the raw page payloads once (byte streams in
the stream matcher's chunked layout, in length buckets — or, for big
pages, as value-boundary segments), then per query walk the PLAIN bytes
through the stream matcher (kernel K1), count the accepted values of
dictionary pages in the dictionary kernel (K2), and report matches per
page.  Pages with zero matches
are pruned.  `cold_scan` is the native host scan, with no device.

Every device entry point takes an explicit `device`.  On CUDA the kernels
run or the call raises; there is no fallback.  Patterns outside the DFA
subset raise NotImplementedError (the reference's host `re` fallback is
not ported).
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import bindings
from ..host.batch import to_tensor
from ..host.reader import ParquetReader
from ..host.schema import ParquetType
from ..ops import decode as _decode
from ..ops import scan as _scan
from ..ops import strings as _strings
from ..ops.regex import anchored_prune_range, like_to_regex, substring_chain
from ..ops.scan import PageMatchResult


def _check_byte_array(reader: ParquetReader, column: str) -> None:
    info = reader.column(column)
    if info.type != ParquetType.BYTE_ARRAY:
        raise TypeError(
            f"regex scan requires a BYTE_ARRAY column; '{column}' is "
            f"{info.type_name()}")


class ScanEngine:
    """Regex page pruning over one Parquet file on one torch device."""

    def __init__(self, path: str):
        self.reader = ParquetReader(path)

    def scan(self, column: str, pattern: str, *, negate: bool = False,
             like: bool = False, device) -> PageMatchResult:
        """One-shot scan: uploads the column to `device` and runs one
        query."""
        return self.resident(column, device).scan(pattern, negate=negate,
                                                  like=like)

    def cold_scan(self, column: str, pattern: str, *, negate: bool = False,
                  like: bool = False, exact_counts: bool = False,
                  stats_prune: bool = True) -> PageMatchResult:
        """One-shot scan on the native host path (no device): the answer
        streams off the file mapping.  Same surviving / pruned page sets
        as the device scan; `exact_counts=True` also reproduces its
        `match_counts` (else 0/1 survivor indicators).  `stats_prune` lets
        an anchored pattern skip pages by their ColumnIndex [min, max]
        range (never under `negate`); with `exact_counts=True,
        stats_prune=False` the result is an independent reference for the
        device scan's per-page counts."""
        _check_byte_array(self.reader, column)
        pat = like_to_regex(pattern) if like else pattern
        prange = (anchored_prune_range(pat)
                  if stats_prune and not negate else None)
        chain = substring_chain(pat)
        if chain:
            kw = dict(needles=chain)
        else:
            _pats, (dfa,) = _scan.prepare_patterns([pat])
            kw = dict(table=dfa.table, accept=dfa.accept.astype(np.uint8))
        try:
            dims, arrays = bindings.native_cold_scan(
                self.reader.handle, self.reader.find_column(column), 0, -1,
                negate=negate, exact=exact_counts, prune_range=prange, **kw)
        except bindings.NativeError as e:
            if "unsupported value encoding" in str(e):
                raise NotImplementedError(
                    f"{column}: delta-coded string pages are not supported "
                    "by the native scan; use resident()") from e
            raise
        res = PageMatchResult(page_gid=arrays["page_gid"].copy(),
                              match_counts=arrays["match_counts"].copy(),
                              value_counts=arrays["value_counts"].copy())
        res.stats_pruned_pages = int(dims.get("stats_pruned_pages", 0))
        return res

    def resident(self, column: str, device) -> "ResidentColumn":
        """Uploads the column's page buffers to `device` once for repeated
        queries."""
        return ResidentColumn(self.reader, column, device=device)


class ResidentColumn:
    """A BYTE_ARRAY column resident on a device, serving repeated regex
    scans (only the raw page buffers are kept; decode and match re-run per
    query).

    Pages live in LENGTH BUCKETS (ops/scan.length_buckets): each bucket's
    walk stops at its own longest page.  Big pages (over SPLIT_TRIGGER
    bytes) are instead kept as value-boundary segments whose hits sum back
    to pages; that layout runs one walk per pattern in `scan_many`.  Each
    bucket records which page kinds it holds, so a query launches the walk
    only over PLAIN pages and the dictionary kernel only over dictionary
    pages."""

    def __init__(self, reader: ParquetReader, column: str, *, device):
        _check_byte_array(reader, column)
        self.device = torch.device(device)
        self._batch = reader.prescan(column, pad_strings=8,
                                     flags=bindings.PS_PAYLOAD)
        arrays = self._batch.arrays
        plen = np.asarray(arrays["page_payload_len"])
        is_dict = np.asarray(arrays["page_kind"]) == 1
        dev = self.device

        nn = np.asarray(arrays["page_nn"])
        self._buckets = []
        sp = _scan.split_payload_pages(arrays)
        if sp is not None:
            sub_payload, sub_len, sub_nn, seg_page = sp
            steps = min(_scan.scan_steps(sub_len), sub_payload.shape[1])
            plain_lane = ~is_dict[seg_page]
            self._buckets.append(dict(
                idx=slice(None), steps=steps,
                core=self._batch.to_device(dev, _decode.DECODE_ARRAYS),
                stream=_scan.resident_stream(sub_payload, steps, dev),
                walk_plen=to_tensor(np.where(plain_lane, sub_len, 0), dev,
                                    dtype=np.int32),
                walk_nn=to_tensor(np.where(plain_lane, sub_nn, 0), dev,
                                  dtype=np.int32),
                seg=to_tensor(seg_page, dev, dtype=np.int64),
                has_plain=bool(plain_lane.any()),
                has_dict=bool(is_dict.any())))
        else:
            walk_plen = np.where(is_dict, 0, plen)
            walk_nn = np.where(is_dict, 0, nn)
            for idx, steps in _scan.length_buckets(walk_plen):
                self._buckets.append(dict(
                    idx=idx, steps=steps,
                    core=self._batch.to_device(dev, _decode.DECODE_ARRAYS,
                                               rows=idx),
                    stream=_scan.resident_stream(arrays["payload"], steps,
                                                 dev, rows=idx),
                    walk_plen=to_tensor(walk_plen, dev, rows=idx,
                                        dtype=np.int32),
                    walk_nn=to_tensor(walk_nn, dev, rows=idx,
                                      dtype=np.int32),
                    seg=None,
                    has_plain=bool((~is_dict[idx]).any()),
                    has_dict=bool(is_dict[idx].any())))
        self.split = sp is not None
        self._gid = arrays["page_gid"].copy()

    @property
    def n_pages(self) -> int:
        return self._batch.n_pages

    def _run(self, pats, dfas, negate: bool):
        """[K, N] match counts and [K, N] value counts of one walk over
        every bucket (K patterns fused)."""
        irs, dfa = _scan.resolve_matchers(pats)
        table = _scan.accept_table(_scan.dict_accepts(self._batch, dfas),
                                   self.device)
        b = self._batch
        k = len(pats)
        counts = np.zeros((k, self.n_pages), np.int64)
        values = np.zeros((k, self.n_pages), np.int64)
        for bk in self._buckets:
            c, v = _scan.device_scan_step(
                bk["core"], bk["stream"], bk["walk_plen"], bk["walk_nn"],
                table, irs=irs, dfa=dfa, vmax=b.vmax, nn_cap=b.nn_cap,
                max_def=b.max_def, negate=bool(negate), steps=bk["steps"],
                has_plain=bk["has_plain"], has_dict=bk["has_dict"],
                seg=bk["seg"])
            counts[:, bk["idx"]] = c.cpu().numpy()
            values[:, bk["idx"]] = v.cpu().numpy()[None, :]
        return counts, values

    def scan(self, pattern: str, *, negate: bool = False,
             like: bool = False) -> PageMatchResult:
        pats, dfas = _scan.prepare_patterns([pattern], like=like)
        c, v = self._run(pats, dfas, negate)
        return PageMatchResult(page_gid=self._gid.copy(),
                               match_counts=c[0].copy(),
                               value_counts=v[0].copy())

    def scan_many(self, patterns: list[str], *, negate: bool = False,
                  like: bool = False) -> list[PageMatchResult]:
        """K patterns in ONE walk over the resident byte stream; a pattern
        that needs the table DFA is scanned alone, and the split layout
        runs one walk per pattern.  Results come back in input order."""
        if self.split:
            return [self.scan(p, negate=negate, like=like) for p in patterns]
        pats, dfas = _scan.prepare_patterns(patterns, like=like)
        fused = [j for j, p in enumerate(pats)
                 if _strings.pattern_ir(p) is not None]
        results: list = [None] * len(pats)
        for j in range(len(pats)):
            if j not in fused:
                results[j] = self.scan(pats[j], negate=negate)
        if fused:
            c, v = self._run([pats[j] for j in fused],
                             [dfas[j] for j in fused], negate)
            for r, j in enumerate(fused):
                results[j] = PageMatchResult(page_gid=self._gid.copy(),
                                             match_counts=c[r].copy(),
                                             value_counts=v[r].copy())
        return results

