"""The port's chunked inverted index (duckdb_parquet_parser_tpu_torch/ops/
index.py), its checkpoints (utils/checkpoints.py) and
`ScanEngine.build_index` against the JAX package's, on the same files made
from a seed with numpy.  Tolerance 0: every array of an index is equal, and
a checkpoint written by one package loads in the other."""

from __future__ import annotations

import numpy as np
import pytest

from duckdb_parquet_parser_tpu.host.reader import ParquetReader as RefReader
from duckdb_parquet_parser_tpu.models.scan import ScanEngine as RefEngine
from duckdb_parquet_parser_tpu.ops import index as ref_index
from duckdb_parquet_parser_tpu.utils import checkpoints as ref_ckpt
from duckdb_parquet_parser_tpu_torch.host.reader import (
    ParquetReader,
    _string_stream,
)
from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from duckdb_parquet_parser_tpu_torch.ops import index
from duckdb_parquet_parser_tpu_torch.utils import checkpoints as ckpt
from tests import fixtures

FIELDS = ("positions", "lens", "chunk_of_entry", "tuple_to_chunk",
          "chunk_starts")
LAYOUTS = {"plain": dict(n=3000, null_p=0.3),
           "dict": dict(n=3000, null_p=0.05, n_unique=7),
           "row_groups": dict(n=400, null_p=0.2, rgs=6)}


def same_index(a, b):
    assert (a.num_rows, a.chunk_size, a.num_chunks) == (
        b.num_rows, b.chunk_size, b.num_chunks)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_index")
    return {name: fixtures.strings_file(d / f"{name}.parquet",
                                        np.random.default_rng(40 + i), **kw)
            for i, (name, kw) in enumerate(LAYOUTS.items())}


def test_entry_sizes_equal():
    lens = np.array([0, 1, 9, 10, 99, 100, 999, 1000, 12345, 10**9])
    np.testing.assert_array_equal(index.entry_sizes(lens),
                                  ref_index.entry_sizes(lens))
    np.testing.assert_array_equal(index.entry_sizes(lens),
                                  [len(str(x)) + x for x in lens])


@pytest.mark.parametrize("chunk_size", [64, 1000, 4096])
def test_chunk_boundaries_and_build_index_equal(chunk_size):
    rng = np.random.default_rng(chunk_size)
    lens = rng.integers(0, 60, 5000)
    np.testing.assert_array_equal(
        index.chunk_boundaries(index.entry_sizes(lens), chunk_size),
        ref_index.chunk_boundaries(ref_index.entry_sizes(lens), chunk_size))
    pos = np.sort(rng.choice(8000, 5000, replace=False))
    same_index(index.build_index(pos, lens, 8000, chunk_size),
               ref_index.build_index(pos, lens, 8000, chunk_size))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("engine", ["native", "emission", "numpy"])
def test_build_index_for_column_engines_equal(files, layout, engine):
    r, ref = ParquetReader(files[layout]), RefReader(files[layout])
    for cs in (700, 4096):
        got = index.build_index_for_column(r, "s", cs, engine=engine)
        same_index(got, ref_index.build_index_for_column(ref, "s", cs,
                                                         engine=engine))
        same_index(got, index.build_index_for_column(r, "s", cs,
                                                     engine="numpy"))


def test_emissions_for_rg_equal(files):
    r, ref = ParquetReader(files["row_groups"]), RefReader(files["row_groups"])
    for rg in range(r.num_row_groups()):
        got = index.emissions_for_rg(r, "s", rg)
        want = ref_index.emissions_for_rg(ref, "s", rg)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_materialize_chunk_and_nulls_keep_zero(files):
    r = ParquetReader(files["plain"])
    pos, lens, offs, chars = _string_stream(r.prescan("s"))
    idx = index.build_index(pos, lens, r.num_rows(), 512)
    decoded = r.read_column("s")
    blob = idx.materialize_chunk(1, chars, offs)
    lo, hi = int(idx.chunk_starts[1]), int(idx.chunk_starts[2])
    want = b"".join(str(len(decoded.values[int(p)])).encode()
                    + decoded.values[int(p)] for p in pos[lo:hi])
    assert blob == want
    ref = RefReader(files["plain"])
    from duckdb_parquet_parser_tpu.host.reader import _string_stream as rss

    rpos, rlens, roffs, rchars = rss(ref.prescan("s"))
    assert blob == ref_index.build_index(
        rpos, rlens, ref.num_rows(), 512).materialize_chunk(1, rchars, roffs)
    full = index.build_index_for_column(r, "s")
    assert np.all(full.tuple_to_chunk[~decoded.valid] == 0)


@pytest.mark.parametrize("writer,loader", [("port", "ref"), ("ref", "port")])
def test_checkpoints_round_trip_and_cross_load(files, tmp_path, writer,
                                               loader):
    path = files["row_groups"]
    mods = {"port": (ckpt, index, ParquetReader),
            "ref": (ref_ckpt, ref_index, RefReader)}
    w_ckpt, w_index, w_reader = mods[writer]
    l_ckpt, _l_index, _l_reader = mods[loader]
    idx = w_index.build_index_for_column(w_reader(path), "s", 800)
    saved = w_ckpt.save_index(str(tmp_path), path, "s", idx)
    assert saved == l_ckpt.checkpoint_path(str(tmp_path), path, "s", 800)
    same_index(l_ckpt.load_index(str(tmp_path), path, "s", 800), idx)
    same_index(w_ckpt.load_index(str(tmp_path), path, "s", 800), idx)
    assert l_ckpt.load_index(str(tmp_path), path, "s", 801) is None
    pos, lens = w_index.emissions_for_rg(w_reader(path), "s", 2)
    assert (w_ckpt.save_block(str(tmp_path), path, "s", 2, pos, lens)
            == l_ckpt.block_path(str(tmp_path), path, "s", 2))
    got = l_ckpt.load_block(str(tmp_path), path, "s", 2)
    np.testing.assert_array_equal(got[0], pos)
    np.testing.assert_array_equal(got[1], lens)
    assert l_ckpt.load_block(str(tmp_path), path, "s", 3) is None


def test_engine_build_index_routes_equal_reference(files, tmp_path):
    path = files["row_groups"]
    eng, ref = ScanEngine(path), RefEngine(path)
    plain = eng.build_index("s", 800)
    assert plain.chunk_owners is None
    same_index(plain.index, ref.build_index("s", 800).index)
    same_index(eng.build_index("s").index, ref.build_index("s").index)
    # the reference's checkpoint serves the port's cached route
    ref.build_index("s", 800, checkpoint_dir=str(tmp_path / "a"))
    same_index(eng.build_index("s", 800,
                               checkpoint_dir=str(tmp_path / "a")).index,
               plain.index)
    first = eng.build_index("s", 800, checkpoint_dir=str(tmp_path / "b"))
    again = eng.build_index("s", 800, checkpoint_dir=str(tmp_path / "b"))
    same_index(first.index, plain.index)
    same_index(again.index, plain.index)


def test_engine_build_index_partial_resume(files, tmp_path, monkeypatch):
    """A build killed after 3 of 6 row groups resumes computing only the
    missing ones; the blocks it resumes from were written by the JAX
    package."""
    path = files["row_groups"]
    eng = ScanEngine(path)
    full = eng.build_index("s", chunk_size=800).index
    ck = tmp_path / "ckpt"
    ref = RefReader(path)
    for rg in range(3):
        pos, lens = ref_index.emissions_for_rg(ref, "s", rg)
        ref_ckpt.save_block(str(ck), path, "s", rg, pos, lens)
    calls = []
    orig = index.emissions_for_rg

    def spy(reader, column, rg):
        calls.append(rg)
        return orig(reader, column, rg)

    monkeypatch.setattr(index, "emissions_for_rg", spy)
    resumed = eng.build_index("s", chunk_size=800,
                              checkpoint_dir=str(ck)).index
    assert calls == [3, 4, 5], calls
    same_index(resumed, full)
    same_index(resumed, RefEngine(path).build_index("s", 800).index)
