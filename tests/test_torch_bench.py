"""The port's benchmark program (`duckdb_parquet_parser_tpu_torch/bench.py`)
on the CPU, with the kernels' plain versions.

One run of the program at 20,000 rows and 1 rep, in an interpreter that
refuses to import jax, jaxlib, pyarrow and the JAX package: its last line
is the reference benchmark's contract, its detail carries every key of the
reference's detail (or names it among the routes left out), and its
recorded answers equal the JAX package's on the same fixtures.  A wrong
answer makes a route raise.  The new fixtures of `utils/fixtures.py` are
held against the reference benchmark's generators (byte for byte where
they write files with the same writer; value for value against pyarrow's
files otherwise)."""

from __future__ import annotations

import ast
import inspect
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as ref_bench
from duckdb_parquet_parser_tpu.host.reader import ParquetReader as JaxReader
from duckdb_parquet_parser_tpu.models.scan import ScanEngine as JaxEngine
from duckdb_parquet_parser_tpu.ops import delta as jd
from duckdb_parquet_parser_tpu.ops.index import (
    build_index_for_column as jax_index,
)
from duckdb_parquet_parser_tpu_torch import bench
from duckdb_parquet_parser_tpu_torch.host import bindings
from duckdb_parquet_parser_tpu_torch.ops import delta as td
from duckdb_parquet_parser_tpu_torch.ops import scan as _scan
from duckdb_parquet_parser_tpu_torch.utils import fixtures
from tests.oracle import build_oracle
from tests.test_torch_imports import BLOCK, ROOT

ROWS = 20_000

# fewer rounds and mesh sizes than a measurement takes: this run tests the
# program's routes, answers and output, not a device
RUN = BLOCK + textwrap.dedent("""
    from duckdb_parquet_parser_tpu_torch import bench

    bench.ROUNDS = 2
    bench.SCALING_RANKS = (1, 2)
    code = bench.main(["--rows", "{rows}", "--reps", "1", "--device", "cpu"])
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    sys.exit(code)
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(fixture directory, stdout lines, detail) of one run."""
    cache = tmp_path_factory.mktemp("bench")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["DPQ_BENCH_DIR"] = str(cache)
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), rows=ROWS)],
        capture_output=True, text=True, env=env, cwd=str(cache), timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    details = [json.loads(ln)["detail"] for ln in proc.stderr.splitlines()
               if ln.startswith('{"detail"')]
    assert len(details) == 1, proc.stderr[-4000:]
    return cache, proc.stdout.strip().splitlines(), details[0]


def test_last_line_is_the_reference_contract(run):
    _cache, lines, _detail = run
    line = json.loads(lines[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "decode_regex_scan_rows_per_s"
    assert line["unit"] == "rows/s"
    if not (build_oracle.REF / "include").is_dir():
        assert line["vs_baseline"] is None
    assert line["value"] > 0


def test_reference_binary_is_built_under_the_fixture_dir(tmp_path,
                                                         monkeypatch):
    """With the reference sources present, the reference binary is
    compiled once into the fixture directory, keyed by their digest;
    without them there is none."""
    monkeypatch.setenv("DPQ_BENCH_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("DPQ_REFERENCE", str(tmp_path / "absent"))
    assert bench.reference_binary() is None
    ref = tmp_path / "reference"
    (ref / "include").mkdir(parents=True)
    for src in build_oracle._REF_SOURCES:
        (ref / src).parent.mkdir(parents=True, exist_ok=True)
        (ref / src).write_text(src)
    monkeypatch.setenv("DPQ_REFERENCE", str(ref))
    cmds = []

    def compile_(cmd, **kw):
        cmds.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_text("")

    monkeypatch.setattr(bench.subprocess, "run", compile_)
    exe = bench.reference_binary()
    assert exe.parent == tmp_path / "cache" / "oracle" and exe.exists()
    assert bench.reference_binary() == exe and len(cmds) == 1
    assert str(ref / build_oracle._REF_SOURCES[0]) in cmds[0]


def _reference_keys():
    """(detail keys, band keys, {decomposition key: its keys}) that the
    reference benchmark's `bench_engine` writes."""
    tree = ast.parse(inspect.getsource(ref_bench.bench_engine))
    nested = {k.value for n in ast.walk(tree) if isinstance(n, ast.Dict)
              for k in n.keys if isinstance(k, ast.Constant)}
    consts = {n.value for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    keys = {c for c in consts - nested if re.fullmatch(
        r"rows|n_pages|pruned_pages|index_chunks"
        r"|[a-z0-9_]+_(rows_per_s|gb_per_s|decomp)", c)}
    bands = {n.args[1].value for n in ast.walk(tree)
             if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) in ("_band", "_host_band")
             and isinstance(n.args[1], ast.Constant)}
    bands |= {k.removesuffix("_rows_per_s") for k in keys
              if k.startswith("read_column_")}
    decomps = {}
    for n in ast.walk(tree):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and isinstance(n.targets[0], ast.Subscript)):
            decomps[n.targets[0].slice.value] = [k.value for k in n.value.keys]
    return keys | {"scaling", "scaling_note"}, bands, decomps


def test_detail_has_every_reference_key(run):
    _cache, _lines, detail = run
    keys, bands, decomps = _reference_keys()
    assert len(keys) > 25 and len(bands) > 15 and len(decomps) == 3
    missing = sorted(k for k in keys if k not in detail
                     and k not in bench.LEFT_OUT)
    assert not missing, missing
    missing = sorted(k for k in bands if k not in detail["bands"]
                     and k not in bench.LEFT_OUT)
    assert not missing, missing
    for key, want in decomps.items():
        renamed = ["upload_mb_per_s" if k == "relay_upload_mb_per_s" else k
                   for k in want]
        assert list(detail[key]) == renamed, key
    for name, b in detail["bands"].items():
        assert set(b) == {"min", "med", "spread", "n"}, name
        assert b["min"] <= b["med"] and b["spread"] >= 1.0, name
    for key in keys - set(bench.LEFT_OUT):
        if key.endswith(("_rows_per_s", "_gb_per_s")):
            assert detail[key] > 0, key


def test_launches_recorded_for_every_device_route(run):
    """Each device route's launches of one call are recorded; on the CPU
    every kernel wrapper takes its plain version, so none is counted."""
    _cache, _lines, detail = run
    routes = {"scan_pallas_stream", "scan_bucketed", "scan_general",
              "scan_alternation", "scan_wide", "scan_interior_run",
              "scan_multi3", "scan_bigpage", "scan_cold_device",
              "decode_f64opt", "decode_dict", "scan_dict_strings",
              "decode_delta_i64"}
    assert set(detail["launches"]) == routes
    for n in detail["launches"].values():
        assert n == {"stream_matcher": 0, "dict_lookup": 0, "dfa_walk": 0}
    assert detail["device"] == "cpu"


def test_scaling_table(run):
    _cache, _lines, detail = run
    sc = detail["scaling"]
    assert sc["metric"] == "scan_scaling" and sc["platform"] == "cpu"
    assert [r["devices"] for r in sc["table"]] == [1, 2]
    assert all(r["rows_per_s"] > 0 for r in sc["table"])


def _jax_answer(cache, name):
    if name in ("pruned_pages", "n_pages"):
        res = JaxEngine(str(cache / f"lineitem_{ROWS}.parquet")).cold_scan(
            "l_comment", bench.PATTERN, exact_counts=True)
        return {"pruned_pages": int(len(res.pruned_pages())),
                "n_pages": int(len(res.page_gid))}[name]
    if name == "index_chunks":
        reader = JaxReader(str(cache / f"lineitem_{ROWS}.parquet"))
        return jax_index(reader, "l_comment").num_chunks
    if name == "stats_pruned_pages":
        return JaxEngine(str(cache / f"sortedkeys_{ROWS}.parquet")).cold_scan(
            "s_key", bench.PRUNE_PATTERN, exact_counts=True).stats_pruned_pages
    return JaxEngine(str(cache / f"dictstrings_{ROWS}.parquet")).cold_scan(
        "city", bench.SELECTIVE_PATTERN).dict_skipped_pages


@pytest.mark.parametrize("name", ["pruned_pages", "n_pages", "index_chunks",
                                  "stats_pruned_pages", "dict_skipped_pages"])
def test_answers_equal_the_jax_package(run, name):
    cache, _lines, detail = run
    got = {"stats_pruned_pages":
               detail["scan_stats_prune_decomp"]["pages_skipped"],
           "dict_skipped_pages":
               detail["scan_dict_selective_decomp"]["pages_skipped"]}.get(
                   name, detail.get(name))
    want = _jax_answer(cache, name)
    assert got == want
    assert want > 0


# ── a wrong answer makes its route raise ───────────────────────────────────


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A 3,000-row lineitem file and its read_column answers."""
    path = fixtures.lineitem(tmp_path_factory.mktemp("small") / "l.parquet",
                             3000)
    return path


def _off_by_one(real):
    def wrong(*a, **kw):
        out = real(*a, **kw)
        if isinstance(out, torch.Tensor):
            return out + 1
        return [p + 1 for p in out]
    return wrong


@pytest.mark.parametrize("route", ["scan", "whole_stream", "bigpage",
                                   "decode", "delta"])
def test_a_wrong_answer_raises(route, small, monkeypatch):
    b = bench.Bench("cpu", 1)
    if route == "scan":
        monkeypatch.setattr(_scan, "walk_hits", _off_by_one(_scan.walk_hits))
        call = lambda: bench.scan_routes(b, small)  # noqa: E731
    elif route == "whole_stream":
        # the first query is right; the whole-stream route's own walk is not
        real = _scan.resident_stream

        def shifted(payload, steps, device, rows=None):
            out = real(payload, steps, device, rows)
            return out if rows is not None else out.roll(1, dims=1)

        monkeypatch.setattr(_scan, "resident_stream", shifted)
        call = lambda: bench.scan_routes(b, small)  # noqa: E731
    elif route == "bigpage":
        monkeypatch.setattr(_scan, "walk_hits", _off_by_one(_scan.walk_hits))
        call = lambda: bench.bigpage_route(b, 3000)  # noqa: E731
    elif route == "decode":
        real = bench._decode.decode_fixed_device

        def wrong(*a, **kw):
            planes, valid = real(*a, **kw)
            return [p ^ 1 for p in planes], valid

        monkeypatch.setattr(bench._decode, "decode_fixed_device", wrong)
        ref = bench.ParquetReader(str(small)).read_column("l_tax")
        call = lambda: bench.decode_route(  # noqa: E731
            b, small, "l_tax", ref, "decode_f64opt")
    else:
        monkeypatch.setattr(td, "decode_delta_planes",
                            _off_by_one(td.decode_delta_planes))
        call = lambda: bench.delta_route(b, 3000)  # noqa: E731
    with pytest.raises(bench.BenchMismatch):
        call()
    assert not b.bands  # nothing was timed


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--rows", "100", "--device", "cuda"])


# ── the fixtures against the reference benchmark's generators ──────────────


@pytest.mark.parametrize("port,ref,name", [
    (fixtures.sorted_keys, "gen_sorted_fixture", "sortedkeys"),
    (fixtures.dict_cities, "gen_dict_strings_fixture", "dictstrings")])
def test_fixture_files_match_bench(port, ref, name, tmp_path, monkeypatch):
    monkeypatch.setattr(ref_bench, "CACHE", tmp_path / "ref")
    monkeypatch.setenv("DPQ_BENCH_DIR", str(tmp_path / "port"))
    want = getattr(ref_bench, ref)(3000)
    got = port(bench.bench_dir() / f"{name}_3000.parquet", 3000)
    assert got.parent == tmp_path / "port"
    assert got.read_bytes() == want.read_bytes()


def test_bigpage_values_equal_pyarrow_file(tmp_path, monkeypatch):
    pq = pytest.importorskip("pyarrow.parquet")
    monkeypatch.setattr(ref_bench, "CACHE", tmp_path)
    path = ref_bench.gen_bigpage_fixture(30_000)
    file_batch = JaxReader(str(path)).prescan("l_comment",
                                              flags=bindings.PS_PAYLOAD)
    ours = fixtures.bigpage_arrays(30_000)
    flat = [v for page in bench.payload_values(ours) for v in page]
    assert flat == [v for page in bench.payload_values(file_batch)
                    for v in page]
    assert flat == pq.read_table(path).column("l_comment").to_pylist()
    plen = ours.arrays["page_payload_len"]
    assert (plen <= fixtures.BIGPAGE_BYTES).all() and plen.max() > 4096
    assert ours.arrays["page_num_values"].sum() == 30_000
    np.testing.assert_array_equal(ours.arrays["page_row_start"],
                                  np.concatenate([[0], np.cumsum(
                                      ours.arrays["page_num_values"])[:-1]]))


def test_bigpage_walk_equals_jax_scan_of_file(tmp_path, monkeypatch):
    pytest.importorskip("pyarrow")
    monkeypatch.setattr(ref_bench, "CACHE", tmp_path)
    path = ref_bench.gen_bigpage_fixture(30_000)
    want = JaxEngine(str(path)).cold_scan("l_comment", bench.PATTERN,
                                          exact_counts=True)
    batch = fixtures.bigpage_arrays(30_000)
    buckets, split = _scan.resident_buckets(batch, "cpu")
    assert split
    step, answer = bench.bucket_step(batch, buckets, [bench.PATTERN], "cpu")
    counts, values = answer(step())
    assert int(counts.sum()) == int(want.match_counts.sum()) > 0
    assert int(values.sum()) == int(want.value_counts.sum()) == 30_000


def test_delta_planes_decode_to_pyarrow_file(tmp_path, monkeypatch):
    pq = pytest.importorskip("pyarrow.parquet")
    monkeypatch.setattr(ref_bench, "CACHE", tmp_path)
    path = ref_bench.gen_delta_fixture(60_000)
    want = np.array([v for v in pq.read_table(path).column("x").to_pylist()
                     if v is not None], np.int64)
    dims, arrays, values, nn = fixtures.delta_column_planes(60_000)
    keep = np.arange(dims["nn_cap"])[None, :] < nn[:, None]
    np.testing.assert_array_equal(values[keep], want)
    # the file's miniblock geometry
    file_dims = JaxReader(str(path)).prescan(
        "x", flags=bindings.PS_DELTA_RAW).dims
    assert dims["delta_mb_values"] == int(file_dims["delta_mb_values"])
    assert dims["delta_pitch"] == int(file_dims["delta_pitch"])
    assert len(nn) > 1 and jd.delta_bws(arrays)[-1] > 32
    ref_planes = jd.decode_delta_planes(np, arrays, dims, jd.delta_bws(arrays),
                                        dims["nn_cap"], 2)
    port_planes = td.decode_delta_planes(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in arrays.items()}, dims, dims["nn_cap"], 2)
    for planes in (ref_planes, [p.numpy() for p in port_planes]):
        lo, hi = planes
        got = (hi.astype(np.int64) << 32) | (lo.astype(np.int64) & 0xFFFFFFFF)
        np.testing.assert_array_equal(got[keep], want)
