"""The port's block scans (`ScanEngine.scan_batched`, `scan_streaming`) and
its fused single step (`single_chip_forward` over `build_example_batch`)
against the JAX package's on the same files, against the numpy golden
`scan_batch(xp=np)` and against the native `cold_scan`.  PLAIN, dictionary
and mixed files, negate, blocks that cut row groups, blocks of one page
(each holds dictionary pages only or PLAIN pages only) with the bytes they
upload, the big-page reroute, the profiler trace and the stage metrics of
`scan_batched`.  Tolerance 0:
per-page integer counts.  The `cuda`-marked case holds the block scans and
the row-level matches on the card against the native scan and needs only the
port (the reference is imported inside the tests that use it)."""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from duckdb_parquet_parser_tpu_torch.host import bindings
from duckdb_parquet_parser_tpu_torch.host.schema import ParquetType
from duckdb_parquet_parser_tpu_torch.host.writer import ColumnSpec, ParquetWriter
from duckdb_parquet_parser_tpu_torch.models import scan as port_models
from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from duckdb_parquet_parser_tpu_torch.ops import scan as port_scan
from duckdb_parquet_parser_tpu_torch.ops.decode import DECODE_ARRAYS
from duckdb_parquet_parser_tpu_torch.utils import config, metrics, tracing

KINDS = ["plain", "dict", "mixed"]
# a register-machine pattern, a substring chain, and one that needs the
# table DFA (the plain PyTorch walk)
PATTERNS = ["alpha.*bravo", "charlie", "(al|br)*avo"]
WORDS = [b"alpha", b"bravo", b"charlie", b"delta", b"echo", b"foxtrot",
         b"golf", b"hotel"]


def _strings(rng, n, n_unique=None, null_p=0.1):
    """`n` values of three words each (few distinct ones with `n_unique`:
    the writer then dictionary-encodes them), some NULL."""
    def value():
        return b" ".join(WORDS[int(k)] for k in rng.integers(0, len(WORDS), 3))

    if n_unique:
        pool = [value() + b"-%d" % i for i in range(n_unique)]
        vals = [pool[int(rng.integers(n_unique))] for _ in range(n)]
    else:
        vals = [value() for _ in range(n)]
    return [None if rng.random() < null_p else v for v in vals]


def _write(path, row_groups) -> str:
    w = ParquetWriter(str(path), [ColumnSpec("s", ParquetType.BYTE_ARRAY,
                                             optional=True)],
                      key_value={"pad": "x" * 512})
    for vals in row_groups:
        w.write_row_group({"s": vals})
    w.close()
    return str(path)


@pytest.fixture(scope="module", params=KINDS)
def scan_file(request, tmp_path_factory):
    kind = request.param
    rng = np.random.default_rng({"plain": 31, "dict": 32, "mixed": 33}[kind])
    d = tmp_path_factory.mktemp("torch_streaming")
    if kind == "mixed":
        return _write(d / "m.parquet", [
            _strings(rng, 800, n_unique=8), _strings(rng, 800),
            _strings(rng, 300, n_unique=5, null_p=0.3)])
    uniq = 11 if kind == "dict" else None
    return _write(d / f"{kind}.parquet",
                  [_strings(rng, 1500, uniq, 0.15) for _ in range(3)])


def _reference():
    """(models.scan, ops.scan, compile_pattern, ParquetReader) of the JAX
    package."""
    from duckdb_parquet_parser_tpu.host.reader import ParquetReader
    from duckdb_parquet_parser_tpu.models import scan as models
    from duckdb_parquet_parser_tpu.ops import scan as ops
    from duckdb_parquet_parser_tpu.ops.regex import compile_pattern

    return models, ops, compile_pattern, ParquetReader


def _same(a, b, msg=""):
    np.testing.assert_array_equal(a.page_gid, b.page_gid, err_msg=msg)
    np.testing.assert_array_equal(a.match_counts, b.match_counts, err_msg=msg)
    np.testing.assert_array_equal(a.value_counts, b.value_counts, err_msg=msg)


def _golden(path, pattern, negate):
    _models, ref_scan, _compile, ref_reader = _reference()
    batch = ref_reader(path).prescan("s", pad_strings=8)
    return ref_scan.scan_batch(batch, pattern, negate=negate, xp=np)


def _no_walk(stream, plen, nn, irs, dfa, steps):
    """A stand-in for the byte walk: zero hits (the plain CPU walk records
    too many profiler events to run under one)."""
    return torch.zeros((max(len(irs), 1), plen.shape[0]), dtype=torch.int32)


def _uploaded(fn) -> int:
    """The bytes that `fn()` counts as `h2d_bytes`, run under a CPU
    profiler with the byte walk stood in for."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_scan, "walk_hits", _no_walk)
        before = tracing.counters().get("h2d_bytes", 0)
        with profile(activities=[ProfilerActivity.CPU]):
            fn()
        return tracing.counters()["h2d_bytes"] - before


def _blockwise_uploads(batch, pattern, block_pages: int) -> int:
    """The bytes a block scan uploaded for `batch` in blocks of
    `block_pages` pages before the blocks counted through
    `ops/scan.device_scan_step`: the walked payload rows and the [2, n]
    int32 walk lengths of each block with a PLAIN page; for a batch with
    dictionary pages, every page's decode arrays and the accept table."""
    arrays = batch.arrays
    is_dict = np.asarray(arrays["page_kind"]) == 1
    plen = np.where(is_dict, 0, arrays["page_payload_len"])
    total = 0
    for lo in range(0, batch.n_pages, block_pages):
        hi = min(lo + block_pages, batch.n_pages)
        if not is_dict[lo:hi].all():
            steps = port_scan.scan_steps(plen[lo:hi])
            total += arrays["payload"][lo:hi, :steps].nbytes + 8 * (hi - lo)
    if is_dict.any():
        _pats, dfas = port_scan.prepare_patterns([pattern])
        total += sum(arrays[k].nbytes for k in DECODE_ARRAYS if k in arrays)
        total += port_scan.dict_accepts(batch, dfas).nbytes
    return total


def _block_sizes(scan_file, sizes):
    """`sizes`, and one page a block on the mixed file: each block then
    holds dictionary pages only or PLAIN pages only."""
    return sizes + ((1,) if os.path.basename(scan_file) == "m.parquet"
                    else ())


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_scan_batched_matches_golden_and_cold(scan_file, pattern, negate):
    eng = ScanEngine(scan_file)
    want = _golden(scan_file, pattern, negate)
    for batch_pages in _block_sizes(scan_file, (16384, 7)):
        def scan(bp=batch_pages):
            return eng.scan_batched("s", pattern, negate=negate,
                                    batch_pages=bp, device="cpu")

        got = scan()
        _same(got, want, f"batch_pages={batch_pages}")
    cold = eng.cold_scan("s", pattern, negate=negate, exact_counts=True,
                         stats_prune=False)
    _same(got, cold, "cold_scan")
    if batch_pages == 1:
        _same(got, eng.resident("s", device="cpu").scan(pattern,
                                                         negate=negate))
        batch = eng.reader.prescan("s", pad_strings=8,
                                   flags=bindings.PS_PAYLOAD)
        assert 0 < _uploaded(scan) <= _blockwise_uploads(batch, pattern, 1)


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_scan_streaming_matches_golden_and_cold(scan_file, pattern, negate):
    eng = ScanEngine(scan_file)
    want = _golden(scan_file, pattern, negate)
    for block_pages in _block_sizes(scan_file, (None, 8)):
        def scan(bp=block_pages):
            return eng.scan_streaming("s", pattern, negate=negate,
                                      block_pages=bp, device="cpu")

        got = scan()
        _same(got, want, f"block_pages={block_pages}")
    cold = eng.cold_scan("s", pattern, negate=negate, exact_counts=True,
                         stats_prune=False)
    _same(got, cold, "cold_scan")
    if block_pages == 1:
        _same(got, eng.resident("s", device="cpu").scan(pattern,
                                                         negate=negate))
        col = eng.reader.find_column("s")
        parent = sum(_blockwise_uploads(eng.reader.prescan(
            col, rg, rg + 1, pad_strings=8, flags=bindings.PS_PAYLOAD),
            pattern, 1) for rg in range(eng.reader.num_row_groups()))
        assert 0 < _uploaded(scan) <= parent


@pytest.mark.parametrize("negate", [False, True])
def test_block_scans_match_the_jax_engine(scan_file, negate):
    """The reference's own `scan_batched` and `scan_streaming` (JAX on the
    CPU) give the same pages and counts; one pattern, since the reference
    compiles a program per pattern and shape."""
    ref = _reference()[0].ScanEngine(scan_file)
    eng = ScanEngine(scan_file)
    pattern = PATTERNS[0]
    _same(eng.scan_batched("s", pattern, negate=negate, batch_pages=16,
                           device="cpu"),
          ref.scan_batched("s", pattern, negate=negate, batch_pages=16))
    _same(eng.scan_streaming("s", pattern, negate=negate, block_pages=8,
                             device="cpu"),
          ref.scan_streaming("s", pattern, negate=negate, block_pages=8))


def test_block_scans_reroute_big_pages(tmp_path):
    """Files with pages over the split trigger go through the resident
    column's value-boundary split layout."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(4)
    words = [b"carefully", b"quickly", b"special", b"requests"]
    vals = [b" ".join(rng.choice(words, 4)) for _ in range(3000)]
    f = str(tmp_path / "big.parquet")
    pq.write_table(pa.table({"s": vals}), f, compression="none",
                   use_dictionary=False)
    want = sum(1 for v in vals if re.search(b"special.*requests", v))
    eng = ScanEngine(f)
    ref = _reference()[0].ScanEngine(f)
    r1 = eng.scan_batched("s", "special.*requests", device="cpu")
    r2 = eng.scan_streaming("s", "special.*requests", device="cpu")
    assert int(r1.match_counts.sum()) == int(r2.match_counts.sum()) == want
    _same(r1, ref.scan_batched("s", "special.*requests"))
    _same(r2, r1)
    assert eng.resident("s", device="cpu").split


def test_blocks_without_plain_pages_are_not_walked(tmp_path, monkeypatch):
    """A block of dictionary pages only costs no byte walk: its counts come
    from the dictionary kernel alone."""
    rng = np.random.default_rng(51)
    path = _write(tmp_path / "d.parquet",
                  [_strings(rng, 1200, n_unique=7) for _ in range(2)])
    walks = []
    real = port_scan.walk_hits
    monkeypatch.setattr(port_scan, "walk_hits",
                        lambda *a, **k: walks.append(1) or real(*a, **k))
    eng = ScanEngine(path)
    want = eng.cold_scan("s", "charlie", exact_counts=True, stats_prune=False)
    _same(eng.scan_streaming("s", "charlie", block_pages=2, device="cpu"),
          want)
    _same(eng.scan_batched("s", "charlie", batch_pages=2, device="cpu"),
          want)
    assert not walks and int(want.match_counts.sum()) > 0


def test_scan_batched_writes_trace_and_metrics(scan_file, tmp_path):
    """`scan_batched` runs under `trace_session` and records its stages."""
    trace_dir = tmp_path / "prof"
    before = config.get_config()
    config.set_config(config.EngineConfig(profile_dir=str(trace_dir)))
    records = metrics.get_metrics().records
    del records[:]
    try:
        ScanEngine(scan_file).scan_batched("s", "alpha", batch_pages=32,
                                           device="cpu")
    finally:
        config.set_config(before)
    files = [os.path.join(r, f) for r, _d, fs in os.walk(trace_dir)
             for f in fs]
    assert files, "no profiler trace written under profile_dir"
    summary = metrics.get_metrics().summary()
    assert {"prescan", "scan_dispatch"} <= set(summary), summary
    assert summary["prescan"][0]["pages"] > 0
    assert summary["scan_dispatch"][0]["batches"] >= 1
    assert summary["scan_dispatch"][0]["host_copy_seconds"] >= 0


def test_cold_scan_reports_dict_skipped_pages(tmp_path):
    """A pattern no dictionary entry matches lets the native scan skip
    every dictionary page without reading its indices; the count of such
    pages is part of the result, as in the reference."""
    rng = np.random.default_rng(41)
    path = _write(tmp_path / "d.parquet",
                  [_strings(rng, 1500, n_unique=8) for _ in range(2)])
    got = ScanEngine(path).cold_scan("s", "zzzzqq")
    want = _reference()[0].ScanEngine(path).cold_scan("s", "zzzzqq")
    assert want.dict_skipped_pages > 0
    assert got.dict_skipped_pages == want.dict_skipped_pages
    assert got.stats_pruned_pages == want.stats_pruned_pages
    _same(got, want)


@pytest.mark.parametrize("pattern", ["word_[0-3]_", "a.*e", "(wo|rd)*_1"])
def test_single_chip_forward_matches_reference(tmp_path, pattern):
    """The fused decode + match + count step on `build_example_batch`'s
    file (one dictionary row group, one PLAIN) equals the reference's step
    under JAX on the CPU, the resident scan and the native exact scan."""
    ref_models, _ops, compile_pattern, _reader = _reference()
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    reader, batch = port_models.build_example_batch(str(tmp_path / "port"),
                                                    rows=200)
    ref_reader, ref_batch = ref_models.build_example_batch(
        str(tmp_path / "ref"), rows=200)
    assert reader.num_rows() == ref_reader.num_rows() == 400
    for k in ref_batch.arrays:
        np.testing.assert_array_equal(batch.arrays[k], ref_batch.arrays[k],
                                      err_msg=k)
    fn, args = port_models.single_chip_forward(batch, pattern, device="cpu")
    got = fn(*args)
    assert got.device.type == "cpu" and got.shape == (batch.n_pages,)
    ref_fn, ref_args = ref_models.single_chip_forward(
        ref_batch, compile_pattern(pattern))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_fn(*ref_args)))
    col = port_models.ResidentColumn(reader, "s", device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  col.scan(pattern).match_counts)
    cold = port_models.cold_scan(reader, "s", pattern, exact_counts=True,
                                 stats_prune=False)
    np.testing.assert_array_equal(got.numpy(), cold.match_counts)


def test_example_batch_builder(tmp_path):
    reader, batch = port_models.build_example_batch(str(tmp_path), rows=50)
    assert reader.num_rows() == 100
    assert batch.n_pages > 0
    assert "payload" in batch.arrays and "str_padded" in batch.arrays
    kinds = set(np.asarray(batch.arrays["page_kind"]).tolist())
    assert kinds == {0, 1}, kinds


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", PATTERNS)
def test_block_scans_on_the_card(scan_file, pattern):
    """On the card the blocks go through pinned buffers and a side stream;
    the results equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eng = ScanEngine(scan_file)
    for negate in (False, True):
        want = eng.cold_scan("s", pattern, negate=negate, exact_counts=True,
                             stats_prune=False)
        _same(eng.scan_batched("s", pattern, negate=negate, batch_pages=7,
                               device="cuda"), want)
        _same(eng.scan_streaming("s", pattern, negate=negate, block_pages=8,
                                 device="cuda"), want)
        rows = eng.matching_rows("s", pattern, negate=negate, device="cuda")
        np.testing.assert_array_equal(
            rows, eng.matching_rows("s", pattern, negate=negate,
                                    device="cpu"))
        assert len(rows) == int(want.match_counts.sum())
    fn, args = port_models.single_chip_forward(
        eng.reader.prescan("s", pad_strings=8,
                           flags=bindings.PS_HOST_STRINGS
                           | bindings.PS_PAYLOAD), pattern, device="cuda")
    np.testing.assert_array_equal(
        fn(*args).cpu().numpy(),
        eng.cold_scan("s", pattern, exact_counts=True,
                      stats_prune=False).match_counts)
