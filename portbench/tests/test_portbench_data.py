"""The data maker and the plain reference against the program's own CPU
paths, on a tiny file of each configuration, and the reference's LIKE
against Python's `re`."""

import re

import numpy as np
import pytest

from duckdb_parquet_parser_tpu_torch.host.reader import ParquetReader
from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from portbench import datagen, reference, traffic

CELLS = ["orders_q13_resident", "part_type_resident", "orders_q13_cold"]


def _values(table):
    if table.encoding == "PLAIN":
        return [table.chars[s:e].tobytes()
                for s, e in zip(table.starts, table.ends)]
    off = table.dom_offsets
    dom = [table.dom_chars[off[d]:off[d + 1]].tobytes()
           for d in range(off.size - 1)]
    return [dom[c] for c in table.codes]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    from portbench.tests.conftest import tiny_cell
    out = {}
    for name in CELLS:
        cell, cfg, mix = tiny_cell(name)
        if cfg["name"] not in out:
            path = tmp_path_factory.mktemp(cfg["name"]) / "t.parquet"
            out[cfg["name"]] = (cfg, datagen.make(cfg, 2**31 + 11, path))
    return out


@pytest.mark.parametrize("config", ["tpch_sf10_orders", "tpch_sf10_part"])
def test_the_file_holds_the_values_and_pages_the_maker_recorded(tables, config):
    cfg, table = next(v for k, v in tables.items() if k.startswith(config))
    reader = ParquetReader(str(table.path))
    col = reader.read_column(cfg["column"])
    got = [bytes(v) if not isinstance(v, str) else v.encode()
           for v in col.to_pylist()]
    assert got == _values(table)
    batch = reader.prescan(cfg["column"])
    a = batch.arrays
    assert reader.num_row_groups() == -(-cfg["rows"] // cfg["row_group_rows"])
    np.testing.assert_array_equal(a["page_gid"], np.arange(table.n_pages))
    np.testing.assert_array_equal(a["page_row_start"], table.page_rows[:-1])
    np.testing.assert_array_equal(a["page_nn"], table.rows_per_page)
    assert (a["page_kind"] == (table.encoding != "PLAIN")).all()


def test_the_same_seed_makes_the_same_table():
    from portbench.tests.conftest import tiny_cell
    _cell, cfg, _mix = tiny_cell("orders_q13_resident")
    a, b = datagen.make(cfg, 5), datagen.make(cfg, 5)
    c = datagen.make(cfg, 6)
    assert (a.chars == b.chars).all() and (a.page_rows == b.page_rows).all()
    assert a.chars.size != c.chars.size or (a.chars != c.chars).any()


@pytest.mark.parametrize("name", ["orders_q13_resident", "part_type_resident"])
def test_every_seed_makes_a_table_of_the_same_size(name):
    """Lengths and dictionary values are balanced: each taken equally often,
    only their order drawn from the seed."""
    from portbench.tests.conftest import tiny_cell
    _cell, cfg, _mix = tiny_cell(name)
    sizes = set()
    for seed in (1, 2**31 + 7, 12345678901):
        t = datagen.make(cfg, seed)
        if t.encoding == "PLAIN":
            lens = t.ends - t.starts
            counts = np.bincount(lens, minlength=cfg["values"]["max_len"] + 1)
            used = counts[cfg["values"]["min_len"]:]
            sizes.add(int(t.chars.size))
        else:
            used = np.bincount(t.codes, minlength=t.dom_offsets.size - 1)
            sizes.add(int(t.page_bytes.sum()))
        assert used.max() - used.min() <= 1
    assert len(sizes) == 1


def test_plain_pages_cut_after_the_row_that_reaches_the_page_bytes(tables):
    cfg, table = next(v for k, v in tables.items()
                      if k.startswith("tpch_sf10_orders"))
    lens = table.ends - table.starts + 4
    rg_ends = set(range(cfg["row_group_rows"], cfg["rows"] + 1,
                        cfg["row_group_rows"])) | {cfg["rows"]}
    for a, b in zip(table.page_rows[:-1], table.page_rows[1:]):
        assert lens[a:b - 1].sum() < cfg["page_bytes"]
        assert lens[a:b].sum() >= cfg["page_bytes"] or b in rg_ends


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_native_host_scan(tables, name):
    from portbench.tests.conftest import tiny_cell
    _cell, cfg, mix = tiny_cell(name)
    _, table = tables[cfg["name"]]
    engine = ScanEngine(str(table.path))
    found = {}
    for q in traffic.pool(mix):
        want = reference.page_answer(
            table, reference.row_matches(table, q.like, found), q.negate)
        got = engine.cold_scan(cfg["column"], q.like, like=True,
                               negate=q.negate, exact_counts=True,
                               stats_prune=False)
        for g, w in zip((got.page_gid, got.match_counts, got.value_counts),
                        want):
            np.testing.assert_array_equal(g, w, err_msg=q.like)


@pytest.mark.parametrize("name", ["orders_q13_resident", "part_type_resident"])
def test_reference_agrees_with_the_resident_column_on_the_cpu(tables, name):
    from portbench.tests.conftest import tiny_cell
    _cell, cfg, mix = tiny_cell(name)
    _, table = tables[cfg["name"]]
    col = ScanEngine(str(table.path)).resident(cfg["column"], "cpu")
    for q in traffic.pool(mix)[:3]:
        want = reference.page_answer(table, reference.row_matches(table, q.like),
                                     q.negate)
        got = col.scan(q.like, like=True, negate=q.negate)
        for g, w in zip((got.page_gid, got.match_counts, got.value_counts),
                        want):
            np.testing.assert_array_equal(g, w, err_msg=q.like)


def test_streaming_scan_on_the_cpu_agrees_with_the_reference(tables):
    from portbench.tests.conftest import tiny_cell
    _cell, cfg, mix = tiny_cell("orders_q13_cold")
    _, table = tables[cfg["name"]]
    q = traffic.pool(mix)[5]
    got = ScanEngine(str(table.path)).scan_streaming(
        cfg["column"], q.regex, negate=q.negate, device="cpu")
    want = reference.page_answer(table, reference.row_matches(table, q.like),
                                 q.negate)
    for g, w in zip((got.page_gid, got.match_counts, got.value_counts), want):
        np.testing.assert_array_equal(g, w)


def _like_re(like: str) -> re.Pattern:
    return re.compile(b"".join(
        b".*" if c == ord("%") else b"." if c == ord("_")
        else re.escape(bytes([c])) for c in like.encode()), re.S)


@pytest.mark.parametrize("seed", range(6))
def test_like_matches_python_re(seed):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abca ", np.uint8)
    lens = rng.integers(0, 12, 400)
    ends = np.cumsum(lens + 3)
    starts = ends - lens
    chars = rng.choice(alphabet, int(ends[-1]) + 2)
    vals = [chars[s:e].tobytes() for s, e in zip(starts, ends)]
    for _ in range(40):
        like = "".join(rng.choice(list("abc %_%"), int(rng.integers(0, 7))))
        rx = _like_re(like)
        want = np.array([rx.fullmatch(v) is not None for v in vals])
        got = reference.like_matches(starts, ends, chars, like, {})
        np.testing.assert_array_equal(got, want, err_msg=like)
