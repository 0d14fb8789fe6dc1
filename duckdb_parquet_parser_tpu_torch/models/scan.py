"""ScanEngine and ResidentColumn — the port's front door for regex page
pruning over a BYTE_ARRAY column.

Port of `duckdb_parquet_parser_tpu.models.scan` (`ScanEngine.__init__ /
resident / scan / matching_rows / cold_scan / scan_batched /
scan_streaming / build_index`, `IndexBuildResult`, `ResidentColumn`,
`build_example_batch`, `single_chip_forward`, `make_engine`).  With a
`PagesMesh` (parallel/mesh.py) the scan and the index build shard their
pages over its ranks.  The resident flow: prescan the column on the
host, upload the raw page payloads once (byte streams in the stream
matcher's chunked layout, in length buckets — or, for big pages, as
value-boundary segments), then per query walk the PLAIN bytes through the
stream matcher (kernel K1, or K3's table-DFA walk for a pattern outside the
register-machine family), count the accepted values of dictionary pages
in the dictionary kernel (K2), and report matches per page.  Pages with
zero matches are pruned.  `scan_batched` and `scan_streaming` are the
one-shot device scans of a big or cold file: pages go to the device in
blocks, through pinned host memory on a side stream, so a block's copy
overlaps the walk of the one before it (and, streaming, the host prescan of
the next row group).  `cold_scan` is the native host scan, with no device.

Every device entry point takes an explicit `device`.  On CUDA the kernels
run or the call raises; there is no fallback from a kernel.  A pattern
outside the DFA subset is a different route by pattern class: `ScanEngine.
scan`, `cold_scan` and `matching_rows` answer it with the host `re`
fallback (ops/scan.py), as the reference does, and the resident column and
the block scans refuse it, as the reference's do.
"""

from __future__ import annotations

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..host import bindings
from ..host.batch import to_tensor
from ..host.reader import ParquetReader
from ..host.schema import ParquetType
from ..host.writer import ColumnSpec, ParquetWriter
from ..ops import decode as _decode
from ..ops import scan as _scan
from ..ops import strings as _strings
from ..ops.kernels import dfa_walk, dict_lookup, stream_matcher
from ..ops.regex import (
    UnsupportedPattern,
    anchored_prune_range,
    compile_pattern,
    like_to_regex,
    substring_chain,
)
from ..ops.index import ChunkedIndex, build_index
from ..ops.scan import PageMatchResult
from ..parallel.mesh import make_mesh
from ..parallel.partition import (
    assign_balanced_equal,
    pad_pages,
    reorder_pages,
)
from ..parallel.pipeline import DistributedScanResult, distributed_scan
from ..utils import checkpoints
from ..utils.config import get_config
from ..utils.metrics import get_metrics
from ..utils.tracing import count, front_door, stage, trace_session


def _check_byte_array(reader: ParquetReader, column: str) -> None:
    info = reader.column(column)
    if info.type != ParquetType.BYTE_ARRAY:
        raise TypeError(
            f"regex scan requires a BYTE_ARRAY column; '{column}' is "
            f"{info.type_name()}")


class _BlockWalker:
    """Ships page blocks to a device and counts them there with
    `ops/scan.device_scan_step`: on CUDA a block's payload rows go through
    one of two pinned host buffers and a side stream, so the copy of block
    i + 1 overlaps the step of block i on the current stream; the device
    lays the rows out in the stream matcher's chunked layout.  Counts stay
    on the device until `collect`; `host_seconds` sums the host's copies
    into the block buffers."""

    def __init__(self, device, irs, dfa):
        self.device = torch.device(device)
        self.irs, self.dfa = irs, dfa
        self.cuda = self.device.type == "cuda"
        self.pending: list[torch.Tensor] = []
        self.host_seconds = 0.0
        if self.cuda:
            if irs:
                stream_matcher.prepare([irs])
            if dfa is not None:
                dfa_walk.prepare()
            self.copy_stream = torch.cuda.Stream(self.device)
            self.slots = [{"buf": None, "free": None} for _ in range(2)]
            self.turn = 0

    def _pinned(self, nbytes: int) -> dict:
        """The next pinned slot, free again (its last copy has ended) and
        at least `nbytes` long."""
        slot = self.slots[self.turn]
        self.turn ^= 1
        if slot["free"] is not None:
            slot["free"].synchronize()
        if slot["buf"] is None or slot["buf"].numel() < nbytes:
            slot["buf"] = torch.empty(nbytes, dtype=torch.uint8,
                                      pin_memory=True)
        return slot

    def _ship(self, payload: np.ndarray, plen: np.ndarray, nn: np.ndarray):
        """(stream, plen, nn, steps) of one block's walk on the device, from
        payload [n, pitch] u8 rows and plen / nn [n] (zero on lanes that
        must not walk)."""
        steps = _scan.scan_steps(plen)
        rows = payload[:, :steps]                # the bytes the walk reads
        meta = np.stack([plen, nn]).astype(np.int32)
        count("h2d_bytes", rows.nbytes + meta.nbytes)
        t0 = time.perf_counter()
        if self.cuda:
            slot = self._pinned(rows.size)
            host = slot["buf"][:rows.size].view(rows.shape)
            np.copyto(host.numpy(), rows)
            self.host_seconds += time.perf_counter() - t0
            with torch.cuda.stream(self.copy_stream):
                raw = host.to(self.device, non_blocking=True)
                meta_d = torch.from_numpy(meta).to(self.device)
                slot["free"] = torch.cuda.Event()
                slot["free"].record()
            torch.cuda.current_stream().wait_stream(self.copy_stream)
            raw.record_stream(torch.cuda.current_stream())
            meta_d.record_stream(torch.cuda.current_stream())
        else:
            raw = torch.from_numpy(np.array(rows, order="C"))
            self.host_seconds += time.perf_counter() - t0
            meta_d = torch.from_numpy(meta)
        # the stream matcher's chunked layout, made on the device as the
        # resident column makes it
        stream = stream_matcher.chunk_stream(raw.t())
        return stream, meta_d[0], meta_d[1], steps

    def step(self, batch, lo: int, hi: int, table, negate: bool) -> None:
        """Queues the [K, hi - lo] counts of pages [lo, hi) of `batch`: the
        walk over its PLAIN pages, the dictionary kernel over its dictionary
        pages under the batch's accept `table`.  A block without PLAIN pages
        is not walked and ships no bytes; only a block with dictionary pages
        uploads its decode arrays."""
        arrays = batch.arrays
        is_dict = np.asarray(arrays["page_kind"][lo:hi]) == 1
        has_plain, has_dict = not is_dict.all(), bool(is_dict.any())
        stream = plen = nn = None
        steps = 0
        if has_plain:
            stream, plen, nn, steps = self._ship(
                arrays["payload"][lo:hi],
                np.where(is_dict, 0, arrays["page_payload_len"][lo:hi]),
                np.where(is_dict, 0, arrays["page_nn"][lo:hi]))
        core = (batch.to_device(self.device, _decode.DECODE_ARRAYS,
                                rows=np.arange(lo, hi))
                if has_dict else {"page_nn": nn})
        counts, _values = _scan.device_scan_step(
            core, stream, plen, nn, table, irs=self.irs, dfa=self.dfa,
            vmax=batch.vmax, nn_cap=batch.nn_cap, max_def=batch.max_def,
            negate=bool(negate), steps=steps, has_plain=has_plain,
            has_dict=has_dict)
        self.pending.append(counts)

    def collect(self) -> np.ndarray:
        """The queued blocks' [K, pages] counts, in order, on the host."""
        out = [c.cpu().numpy() for c in self.pending]
        self.pending = []
        return (np.concatenate(out, axis=1) if out
                else np.zeros((max(len(self.irs), 1), 0), np.int32))


def _walk_batch(walker: _BlockWalker, batch, block_pages: int, dfas,
                negate: bool) -> None:
    """Queues the counts of `batch` on `walker`, `block_pages` pages a
    block.  The accept table of the dictionary entries is made once for
    the batch (each row group has its own dictionary)."""
    table = _scan.dict_table(batch, dfas, walker.device)
    for lo in range(0, batch.n_pages, block_pages):
        with stage("dpq.upload"):
            walker.step(batch, lo, min(lo + block_pages, batch.n_pages),
                        table, negate)


@dataclass
class IndexBuildResult:
    index: ChunkedIndex
    chunk_owners: np.ndarray | None = None  # rank owning each chunk (mesh runs)


class ScanEngine:
    """End-to-end scan engine over one Parquet file.

    mesh=None       -> one torch device, named per call
    mesh=PagesMesh  -> pages sharded over the mesh's ranks, collectives for
                       totals and the index entry exchange; every rank
                       makes the same calls
    """

    def __init__(self, path: str, mesh=None):
        self.reader = ParquetReader(path)
        self.mesh = mesh

    @front_door
    def scan(self, column: str, pattern: str, *, negate: bool = False,
             like: bool = False, engine: str | None = None, fleet=None,
             fault_hook=None,
             device=None) -> PageMatchResult | DistributedScanResult:
        """One-shot scan.  A pattern outside the DFA subset is answered on
        the host with `re` (ops/scan.scan_batch_fallback).  With a mesh the
        pages shard over its ranks, byte-balanced (`fleet` / `fault_hook`:
        the elastic route, parallel/elastic.py).  Else `engine` (default:
        the configuration's `scan_engine`) chooses: "native" is the fused
        host scan (`cold_scan`), "torch" uploads the column to `device`,
        which the caller must then name, and runs one query there."""
        _check_byte_array(self.reader, column)
        cfg = get_config()
        if engine is None:
            engine = cfg.scan_engine
        pat = like_to_regex(pattern) if like else pattern
        try:
            dfa = compile_pattern(pat)
        except UnsupportedPattern:
            batch = self.reader.prescan(column, pad_strings=8)
            return _scan.scan_batch_fallback(batch, pat, negate=negate)

        if self.mesh is not None:
            batch = self.reader.prescan(
                column, pad_strings=8,
                flags=bindings.PS_HOST_STRINGS | bindings.PS_PAYLOAD)
            n_dev = self.mesh.size
            with stage("dpq.shard_plan"):
                padded = pad_pages(
                    batch, n_dev * max(cfg.pages_per_shard_multiple, 1))
                # byte-balanced shards: heaviest pages spread across ranks
                # under the equal-count constraint (pad pages weigh 0)
                weights = padded.arrays["page_payload_len"].astype(
                    np.int64) + 16
                weights = np.where(padded.arrays["page_num_values"] > 0,
                                   weights, 0)
                with stage("dpq.shard_plan.assign"):
                    asg = assign_balanced_equal(weights, n_dev)
                with stage("dpq.shard_plan.reorder"):
                    padded = reorder_pages(padded, asg.order)
            if fault_hook is not None or fleet is not None:
                # elastic path: detect failed ranks, re-run orphaned shards
                # on the survivors, merge (parallel/elastic.py)
                from ..parallel.elastic import elastic_distributed_scan

                res, report = elastic_distributed_scan(
                    self.mesh, padded, dfa, negate=negate, fleet=fleet,
                    fault_hook=fault_hook)
                res.elastic_report = report
                return res
            return distributed_scan(self.mesh, padded, dfa, negate=negate)

        if engine == "native":
            return self.cold_scan(column, pat, negate=negate)
        if engine != "torch":
            raise ValueError(f"unknown scan engine: {engine!r}")
        if device is None:
            raise ValueError('the "torch" scan engine needs a device')
        return self.resident(column, device)._scan_compiled(
            [pat], [dfa], negate)[0]

    def matching_rows(self, column: str, pattern: str, *,
                      negate: bool = False, like: bool = False,
                      device) -> np.ndarray:
        """Absolute row ids of the non-null values matching `pattern` — the
        row-level result the page scan prunes toward ('WHERE col ~
        pattern'), computed on `device`.  Same participation / negate
        semantics as scan(); combine with read_rows() for point decodes of
        the hits."""
        _check_byte_array(self.reader, column)
        pat = like_to_regex(pattern) if like else pattern
        batch = self.reader.prescan(column, pad_strings=8)
        return _scan.match_rows(batch, pat, negate=negate, device=device)

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
        return cold_scan(self.reader, column, pattern, negate=negate,
                         like=like, exact_counts=exact_counts,
                         stats_prune=stats_prune)

    @front_door
    def scan_batched(self, column: str, pattern: str, *,
                     negate: bool = False, batch_pages: int = 16384,
                     device) -> PageMatchResult:
        """Large-file scan with overlap: one prescan of the column, then
        its pages go to `device` in blocks of `batch_pages`; block i + 1 is
        copied while block i walks (`_BlockWalker`).  The
        reference pads every block to one compiled shape; nothing is
        compiled per shape here, so the tail block goes as it is."""
        _check_byte_array(self.reader, column)
        pats, dfas = _scan.prepare_patterns([pattern])
        irs, dfa = _scan.resolve_matchers(pats, dfas)
        with trace_session(get_config().profile_dir):
            with get_metrics().timed("prescan", column=column) as box:
                batch = self.reader.prescan(column, pad_strings=8,
                                            flags=bindings.PS_PAYLOAD)
                box["pages"] = batch.n_pages
            arrays = batch.arrays
            n = batch.n_pages
            if _scan.has_big_pages(arrays["page_payload_len"]):
                # big pages: blocks would walk one mega-page per lane —
                # the value-boundary split layout instead
                return ResidentColumn(self.reader, column, device=device,
                                      batch=batch)._scan_compiled(
                    pats, dfas, negate)[0]
            bp = min(batch_pages, max(n, 1))
            walker = _BlockWalker(device, irs, dfa)
            with get_metrics().timed("scan_dispatch",
                                     batches=-(-n // bp)) as box, \
                    stage("dpq.scan_dispatch"):
                _walk_batch(walker, batch, bp, dfas, negate)
                box["host_copy_seconds"] = walker.host_seconds
            with stage("dpq.collect"):
                counts = walker.collect()[0]
        return PageMatchResult(
            page_gid=arrays["page_gid"].copy(),
            match_counts=counts.astype(np.int64),
            value_counts=arrays["page_nn"].astype(np.int64))

    @front_door
    def scan_streaming(self, column: str, pattern: str, *,
                       negate: bool = False, block_pages: int | None = None,
                       device) -> PageMatchResult:
        """Pipelined COLD device scan: prescan -> copy -> walk overlap.

        Per-row-group prescans run on a host worker thread and stream into
        page blocks (`block_pages` pages, default a whole row group); each
        block's copy and walk are asynchronous, so the host prescan of row
        group i + 1 overlaps the transfer and walk of row group i's blocks.
        The pattern's matchers come from `_streaming_matchers`, compiled
        once for repeated calls as the reference's cached jit step is, and
        its kernel is built before the first block
        (`stream_matcher.prepare`).  The reference's `payload_bucket`
        pinned one compiled shape and has no counterpart here.  This is the device-side answer to a
        one-shot scan on a cold file (cold_scan() is the host-side one;
        resident() serves repeated queries)."""
        _check_byte_array(self.reader, column)
        pats, dfas, irs, dfa = _streaming_matchers(pattern)
        walker = _BlockWalker(device, irs, dfa)
        col_idx = self.reader.find_column(column)
        n_rg = self.reader.num_row_groups()

        def prescan_rg(rg):
            return self.reader.prescan(col_idx, rg, rg + 1, pad_strings=8,
                                       flags=bindings.PS_PAYLOAD)

        first = prescan_rg(0)
        if _scan.has_big_pages(first.arrays["page_payload_len"]):
            # big pages: the value-boundary split layout instead
            return ResidentColumn(self.reader, column,
                                  device=device)._scan_compiled(
                pats, dfas, negate)[0]

        batches = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            futures = [pool.submit(prescan_rg, rg) for rg in range(1, n_rg)]
            for rg in range(n_rg):
                # rg i + 1 prescans while rg i ships and walks
                batch = first if rg == 0 else futures[rg - 1].result()
                _walk_batch(walker, batch,
                            block_pages or max(batch.n_pages, 1), dfas,
                            negate)
                batches.append(batch)
        return PageMatchResult(
            page_gid=np.concatenate([b.arrays["page_gid"] for b in batches]),
            match_counts=walker.collect()[0].astype(np.int64),
            value_counts=np.concatenate(
                [b.arrays["page_nn"] for b in batches]).astype(np.int64))

    def resident(self, column: str, device) -> "ResidentColumn":
        """Uploads the column's page buffers to `device` once for repeated
        queries."""
        return ResidentColumn(self.reader, column, device=device)

    # ── chunked inverted index ──────────────────────────────────────────────

    def build_index(self, column: str, chunk_size: int | None = None,
                    checkpoint_dir: str | None = None) -> IndexBuildResult:
        if chunk_size is None:
            chunk_size = get_config().index_chunk_size

        if checkpoint_dir:
            cached = checkpoints.load_index(
                checkpoint_dir, self.reader._path, column, chunk_size
            )
            if cached is not None:
                return IndexBuildResult(index=cached)

        if self.mesh is not None:
            from ..parallel.index_build import distributed_index_build

            res = distributed_index_build(self.mesh, self.reader, column, chunk_size)
            out = IndexBuildResult(index=res.index, chunk_owners=res.chunk_owners)
        elif checkpoint_dir:
            # PARTIAL resume: the emission stream checkpoints per row group
            # (a build killed at 90% recomputes only the missing blocks —
            # the boundary plan over the concatenated stream is cheap)
            from ..ops.index import emissions_for_rg

            pos_parts, len_parts = [], []
            for rg in range(self.reader.num_row_groups()):
                blk = checkpoints.load_block(
                    checkpoint_dir, self.reader._path, column, rg)
                if blk is None:
                    blk = emissions_for_rg(self.reader, column, rg)
                    checkpoints.save_block(
                        checkpoint_dir, self.reader._path, column, rg, *blk)
                pos_parts.append(blk[0])
                len_parts.append(blk[1])
            pos = np.concatenate(pos_parts) if pos_parts else np.zeros(0, np.int64)
            lens = np.concatenate(len_parts) if len_parts else np.zeros(0, np.int64)
            out = IndexBuildResult(
                index=build_index(pos, lens, self.reader.num_rows(), chunk_size)
            )
        else:
            from ..ops.index import build_index_for_column

            out = IndexBuildResult(
                index=build_index_for_column(self.reader, column, chunk_size)
            )
        if checkpoint_dir:
            checkpoints.save_index(checkpoint_dir, self.reader._path, column, out.index)
        return out


def cold_scan(reader: ParquetReader, column: str, pattern: str, *,
              negate: bool = False, like: bool = False,
              exact_counts: bool = False,
              stats_prune: bool = True) -> PageMatchResult:
    """Free-function form of ScanEngine.cold_scan over an open reader.  A
    pattern outside the DFA subset takes the host `re` fallback, and
    delta-coded string pages, which the native scan does not read, re-run
    through the prescan path (`scan_batch` on the CPU)."""
    _check_byte_array(reader, column)
    pat = like_to_regex(pattern) if like else pattern
    prange = (anchored_prune_range(pat)
              if stats_prune and not negate else None)
    chain = substring_chain(pat)
    if chain:
        kw = dict(needles=chain)
    else:
        try:
            dfa = compile_pattern(pat)
        except UnsupportedPattern:
            batch = reader.prescan(column, pad_strings=8)
            return _scan.scan_batch_fallback(batch, pat, negate=negate)
        kw = dict(table=dfa.table, accept=dfa.accept.astype(np.uint8))
    try:
        dims, arrays = bindings.native_cold_scan(
            reader._h, reader.find_column(column), 0, -1, negate=negate,
            exact=exact_counts, prune_range=prange, **kw)
    except bindings.NativeError as e:
        if "unsupported value encoding" not in str(e):
            raise
        batch = reader.prescan(column, pad_strings=8)
        return _scan.scan_batch(batch, pat, negate=negate, device="cpu")
    return PageMatchResult(
        page_gid=arrays["page_gid"].copy(),
        match_counts=arrays["match_counts"].copy(),
        value_counts=arrays["value_counts"].copy(),
        stats_pruned_pages=int(dims.get("stats_pruned_pages", 0)),
        dict_skipped_pages=int(dims.get("dict_skipped_pages", 0)))


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

    def __init__(self, reader: ParquetReader, column: str, *, device,
                 batch=None):
        """`batch`: the column's PS_PAYLOAD prescan when the caller already
        has it (prescanned here otherwise)."""
        _check_byte_array(reader, column)
        self.device = torch.device(device)
        self._batch = batch if batch is not None else reader.prescan(
            column, pad_strings=8, flags=bindings.PS_PAYLOAD)
        self._buckets, self.split = _scan.resident_buckets(self._batch,
                                                           self.device)
        self._gid = self._batch.arrays["page_gid"].copy()

    @property
    def n_pages(self) -> int:
        return self._batch.n_pages

    def _scan_compiled(self, pats, dfas, negate: bool
                      ) -> list[PageMatchResult]:
        """The results of one walk over every bucket for K regexes and
        their compiled `dfas` (`ops/scan.prepare_patterns`): K register
        machines fused, or one table DFA.  Compiles nothing."""
        irs, dfa = _scan.resolve_matchers(pats, dfas)
        c, v = _scan.scan_buckets(self._batch, self._buckets, irs, dfa, dfas,
                                  negate, self.device)
        return [PageMatchResult(page_gid=self._gid.copy(),
                                match_counts=c[r].copy(),
                                value_counts=v[r].copy())
                for r in range(len(pats))]

    @front_door
    def scan(self, pattern: str, *, negate: bool = False,
             like: bool = False) -> PageMatchResult:
        pats, dfas = _scan.prepare_patterns([pattern], like=like)
        return self._scan_compiled(pats, dfas, negate)[0]

    @front_door
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
                results[j] = self._scan_compiled([pats[j]], [dfas[j]],
                                                 negate)[0]
        if fused:
            for j, res in zip(fused, self._scan_compiled(
                    [pats[j] for j in fused], [dfas[j] for j in fused],
                    negate)):
                results[j] = res
        return results


@functools.lru_cache(maxsize=32)
def _streaming_matchers(pattern: str):
    """(pats, dfas, irs, dfa) of `scan_streaming`, cached per pattern: the
    counterpart of the reference's `_streaming_step` cache, so a repeated
    cold scan compiles nothing.  The reference keys on (pattern, negate)
    because its jit step folds `negate` in; here `negate` applies after the
    walk.  A pattern outside the DFA subset raises, and a raise is not
    cached.  The shared DFAs' arrays are made read-only: no route writes
    them, and a writer would fail rather than change the next query."""
    pats, dfas = _scan.prepare_patterns([pattern])
    for d in dfas:
        d.table.setflags(write=False)
        d.accept.setflags(write=False)
    return (pats, dfas) + _scan.resolve_matchers(pats, dfas)


# ── a self-contained example: one fused forward step on a small batch ───────


def build_example_batch(tmpdir: str, *, rows: int = 400):
    """Writes a small two-row-group string fixture (a dictionary-encoded
    row group and a PLAIN one, 10% nulls) and prescans it.  Returns
    (reader, batch)."""
    rng = np.random.default_rng(0)
    path = os.path.join(tmpdir, "graft_example.parquet")
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)

    def strings(n, uniq):
        if uniq:
            pool = [f"word_{i}_{'x' * (i % 5)}".encode() for i in range(uniq)]
            return [pool[int(rng.integers(uniq))] for _ in range(n)]
        return [bytes(rng.choice(letters, int(rng.integers(3, 25))))
                for _ in range(n)]

    w = ParquetWriter(
        path, [ColumnSpec("s", ParquetType.BYTE_ARRAY, optional=True)],
        key_value={"pad": "x" * 512},
    )
    vals = strings(rows, 8) + strings(rows, None)
    w.write_row_group({"s": [None if rng.random() < 0.1 else v
                             for v in vals[:rows]]})
    w.write_row_group({"s": [None if rng.random() < 0.1 else v
                             for v in vals[rows:]]})
    w.close()
    reader = ParquetReader(path)
    return reader, reader.prescan(
        "s", pad_strings=8,
        flags=bindings.PS_HOST_STRINGS | bindings.PS_PAYLOAD)


def single_chip_forward(batch, pattern: str, *, device):
    """Returns (fn, example_args): one fused decode + match + count step on
    a page batch on `device` — the raw-payload byte walk for PLAIN pages
    (kernel K1 for a register-machine pattern, K3 for a table DFA), the
    dictionary path for the rest: levels, index planes, and the per-entry
    accepts looked up through the dictionary kernel's gather entry (K2).  `fn(*example_args)` gives
    the [N] per-page match counts.  (The reference takes a compiled DFA
    for its one-hot table walk; the kernel's register machine is traced
    from the pattern, so this takes the pattern.)"""
    pats, dfas = _scan.prepare_patterns([pattern])
    irs, dfa = _scan.resolve_matchers(pats, dfas)
    arrays = batch.arrays
    core = batch.to_device(device, _decode.DECODE_ARRAYS)
    dict_match = _scan.accept_table(_scan.dict_accepts(batch, dfas),
                                    device)[0]
    vmax, nn_cap, max_def = batch.vmax, batch.nn_cap, batch.max_def
    steps = min(_scan.scan_steps(arrays["page_payload_len"]),
                arrays["payload"].shape[1])

    def forward(core, stream, plen, dict_match):
        is_dict = core["page_kind"] == 1
        nn = core["page_nn"]
        hits = _scan.walk_hits(stream, torch.where(is_dict, 0, plen),
                               torch.where(is_dict, 0, nn), irs, dfa,
                               steps)[0]
        nonnull, nn_idx = _decode.decode_levels(core, max_def, vmax)
        dict_idx, ok = _decode.decode_dict_indices(core, nn_idx, nn_cap,
                                                   nonnull=nonnull)
        g = (core["page_dict_base"][:, None] + dict_idx.clamp(min=0)).clamp(
            0, dict_match.shape[0] - 1).to(torch.int32).contiguous()
        dm = dict_lookup.dict_lookup(dict_match.to(torch.int32)[None],
                                     g)[0] != 0
        dict_counts = (dm & ok & nonnull).sum(dim=1).to(torch.int32)
        return torch.where(is_dict, dict_counts, hits)

    example_args = (
        core, _scan.resident_stream(arrays["payload"], steps, device),
        to_tensor(arrays["page_payload_len"], device, dtype=np.int32),
        dict_match)
    return forward, example_args


def make_engine(path: str, mesh=None) -> ScanEngine:
    """A `ScanEngine` over `path`; sharded over `mesh`
    (`parallel.mesh.make_mesh(device, backend)`) where one is given."""
    return ScanEngine(path, mesh=mesh)
