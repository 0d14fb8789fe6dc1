"""The port's own copies of the JAX-free layers (duckdb_parquet_parser_tpu_torch/
ops/regex.py, ops/bitprog.py, ops/strings.make_bitap_transition, host/
bindings.py, host/writer.py, host/schema.py, host/assembly.py, host/reader.py,
utils/config.py, utils/metrics.py, utils/checkpoints.py, ops/index.py,
parallel/partition.py, the host half of parallel/shuffle.py, `FleetState` of
parallel/elastic.py, the `dict_ints` fixture and the native library built
from host/native/) against the reference modules they were
copied from, over the pattern corpus the port's tests use.  Tolerance 0:
tables, programs, traced transitions, prescan arrays, file bytes and the
copied sources are equal."""

from __future__ import annotations

import ast
import enum
import inspect
import json
from pathlib import Path

import numpy as np
import pytest

from duckdb_parquet_parser_tpu.host import bindings as ref_bindings
from duckdb_parquet_parser_tpu.host import schema as ref_schema
from duckdb_parquet_parser_tpu.host import writer as ref_writer
from duckdb_parquet_parser_tpu.ops import bitprog as ref_bitprog
from duckdb_parquet_parser_tpu.ops import regex as ref_regex
from duckdb_parquet_parser_tpu.ops import strings as ref_strings
from duckdb_parquet_parser_tpu.utils import config as ref_config
from duckdb_parquet_parser_tpu_torch.host import bindings, build, schema, writer
from duckdb_parquet_parser_tpu_torch.ops import bitprog, regex, strings
from duckdb_parquet_parser_tpu_torch.utils import config
from portbench.traffic import pool
from tests import fixtures
from tests.test_bitprog import SUPPORTED, UNSUPPORTED

STREAM = ["a.*z", "ab|cde|fg", "^ab", "q[ax]+x", "a?", "a{40}",
          "gr[ae]y|colou?r", "bc$", "[abq]{9}", "[a-gq-z]{9,12}x",
          "[abx ]{10}$"]
BENCH = ["special.*requests", "spe[cs]ial.*requ[ea]sts",
         "carefully|quickly|special", "[a-z ]{30,45}requests",
         "carefully[a-z ]{32,}requests", "furiously.*deposits"]
DICT = ["san.*-1[0-9]", "new (york|orleans)-2", "^bo", "ttle-3[0-9]*$"]
CORPUS = list(dict.fromkeys(list(SUPPORTED) + list(UNSUPPORTED) + STREAM
                            + BENCH + DICT + ["([a-m])\\1*o", "a(b"]))
LIKES = ["%al_ha%", "city_1%", "abc", "%", "_x%y_", "50\\%%", "a.b%"]
CHAINS = [(b"ab",), (b"ab", b"q"), (b"abc", b"x", b"yz"), (b"qq", b"q")]
# the benchmark's LIKEs (TPC-H Q13 on o_comment, Q2 / Q14 / Q16 on p_type) as
# the resident route compiles them, two patterns whose subset construction
# makes hundreds of states before minimization, and characters past U+00FF
# on edges the subset construction reaches or not
TRAFFIC = Path(__file__).resolve().parent.parent / "portbench" / "traffic"
BENCH_LIKES = [regex.like_to_regex(q.like)
               for mix in ("q13_notlike", "ptype_like")
               for q in pool(json.loads((TRAFFIC / f"{mix}.json").read_text()))]
COMPILED = list(dict.fromkeys(CORPUS + BENCH_LIKES
                              + ["(a|b)*a(a|b){8}", "[a-z]*q[a-z]{8}",
                                 "x\u20ac{0}", "(a|\u20ac){0}b", "a\u20ac",
                                 "[a-\u20ac]", "\u00e9+"]))
# states of the subset construction before minimization (the least
# max_states that compiles)
SUBSET_STATES = {"^.*special.*requests.*$": 41, "^STANDARD\\ ANODIZED.*$": 20,
                 "a{40}": 81, "(ly )+requests": 23, "gr[ae]y|colou?r": 20}


def _outcome(fn, *args):
    """(value, None) or (None, exception class name): both packages must
    refuse the same inputs."""
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return None, type(e).__name__


@pytest.mark.parametrize("pattern", COMPILED)
def test_compile_pattern_tables_and_accepts_equal(pattern):
    got, got_err = _outcome(regex.compile_pattern, pattern)
    want, want_err = _outcome(ref_regex.compile_pattern, pattern)
    assert got_err == want_err
    if want is None:
        return
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.accept, want.accept)
    assert got.table.dtype == want.table.dtype


@pytest.mark.parametrize("offset", [-2, -1, 0, 1])
@pytest.mark.parametrize("pattern", list(SUBSET_STATES))
def test_compile_pattern_state_budget_equal(pattern, offset):
    """Both packages give up on the same state budget, and below it, and
    give equal tables above it."""
    m = SUBSET_STATES[pattern] + offset
    got, got_err = _outcome(regex.compile_pattern, pattern, m)
    want, want_err = _outcome(ref_regex.compile_pattern, pattern, m)
    assert want_err == (None if offset >= 0 else "UnsupportedPattern")
    assert got_err == want_err
    if want is not None:
        np.testing.assert_array_equal(got.table, want.table)
        np.testing.assert_array_equal(got.accept, want.accept)


def _hand_dfa(case: str) -> tuple[np.ndarray, np.ndarray]:
    """[S, 256] tables and accepts made by hand for minimize_dfa."""
    rng = np.random.default_rng(17)
    if case == "single":
        return np.zeros((1, 256), np.int32), np.array([True])
    if case == "equivalent":
        # 0 -a-> 1 | 2 (equal rows), 1, 2 -b-> 3 (accepting, absorbing);
        # 4 and 5 are unreachable copies of 1 and 3
        table = np.zeros((6, 256), np.int32)
        table[0, ord("a")], table[0, ord("c")] = 1, 2
        table[[1, 2, 4], ord("b")] = 3
        table[[3, 5], :] = [[3], [5]]
        return table, np.array([False, False, False, True, False, True])
    if case == "distinct_columns":  # 256 byte classes
        s = 37
        table = (np.arange(s)[:, None] * 7 + np.arange(256)[None, :]) % s
        return table.astype(np.int32), np.arange(s) % 5 == 0
    s = {"all_accepting": 12, "none_accepting": 12, "random": 60}[case]
    cols = rng.integers(0, s, (s, 6)).astype(np.int32)  # 6 byte classes
    table = cols[:, rng.integers(0, 6, 256)]
    accept = {"all_accepting": np.ones(s, bool),
              "none_accepting": np.zeros(s, bool),
              "random": rng.random(s) < 0.2}[case]
    return table, accept


@pytest.mark.parametrize("case", ["single", "equivalent", "distinct_columns",
                                  "all_accepting", "none_accepting",
                                  "random"])
def test_minimize_dfa_equal(case):
    table, accept = _hand_dfa(case)
    got = regex.minimize_dfa(regex.DFA(table, accept, case))
    want = ref_regex.minimize_dfa(ref_regex.DFA(table, accept, case))
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.accept, want.accept)
    assert got.table.dtype == want.table.dtype
    assert got.accept.dtype == want.accept.dtype
    assert got.pattern == want.pattern


@pytest.mark.parametrize("pattern", CORPUS)
def test_compile_bitprog_programs_and_transitions_equal(pattern):
    got, got_err = _outcome(bitprog.compile_bitprog, pattern)
    want, want_err = _outcome(ref_bitprog.compile_bitprog, pattern)
    assert got_err == want_err
    if want is None:
        return
    assert repr(got) == repr(want)
    assert got.fingerprint == want.fingerprint
    a = bitprog.trace_transition(bitprog.make_bitprog_transition, got)
    b = bitprog.trace_transition(ref_bitprog.make_bitprog_transition, want)
    assert a.nodes == b.nodes and a.out_state == b.out_state
    assert (a.n_regs, a.out_accept, a.accept_empty) == (
        b.n_regs, b.out_accept, b.accept_empty)


@pytest.mark.parametrize("pattern", CORPUS)
def test_regex_helpers_equal(pattern):
    for name in ("substring_chain", "anchored_prune_range",
                 "anchored_literal_prefix", "exact_literal"):
        assert _outcome(getattr(regex, name), pattern) == _outcome(
            getattr(ref_regex, name), pattern), name


@pytest.mark.parametrize("like", LIKES)
def test_like_to_regex_equal(like):
    assert regex.like_to_regex(like) == ref_regex.like_to_regex(like)


@pytest.mark.parametrize("chain", CHAINS)
def test_bitap_transition_equal(chain):
    a = bitprog.trace_transition(strings.make_bitap_transition, list(chain))
    b = bitprog.trace_transition(ref_strings.make_bitap_transition,
                                 list(chain))
    assert a.nodes == b.nodes and a.out_state == b.out_state
    assert (a.n_regs, a.out_accept, a.accept_empty) == (
        b.n_regs, b.out_accept, b.accept_empty)


def test_schema_enums_and_config_defaults_equal():
    for name, ref_cls in vars(ref_schema).items():
        if isinstance(ref_cls, type) and issubclass(ref_cls, enum.Enum):
            got = {m.name: m.value for m in getattr(schema, name)}
            assert got == {m.name: m.value for m in ref_cls}, name
    ref_cfg = ref_config.EngineConfig()
    cfg = config.EngineConfig()
    shared = set(vars(cfg)) & set(vars(ref_cfg))
    assert shared == {"index_chunk_size", "batch_align", "scan_engine",
                      "max_dfa_states", "pages_per_shard_multiple",
                      "exchange_capacity_slack", "exchange_mode",
                      "profile_dir"}
    # the one deliberate difference: `scan_engine` names the port's own
    # engines ("torch" | "native" for the reference's "jax" | "numpy")
    for field in shared - {"scan_engine"}:
        assert getattr(cfg, field) == getattr(ref_cfg, field), field
        assert type(getattr(cfg, field)) is type(getattr(ref_cfg, field))
    assert (cfg.scan_engine, ref_cfg.scan_engine) == ("torch", "jax")
    for name in dir(ref_bindings):
        if name.startswith("PS_"):
            assert getattr(bindings, name) == getattr(ref_bindings, name)


def test_config_from_env_parses_each_type(monkeypatch):
    monkeypatch.setenv("DPQ_EXCHANGE_CAPACITY_SLACK", "1.5")
    monkeypatch.setenv("DPQ_INDEX_CHUNK_SIZE", "512")
    monkeypatch.setenv("DPQ_EXCHANGE_MODE", "padded")
    monkeypatch.setenv("DPQ_SCAN_ENGINE", "native")
    cfg, ref_cfg = (config.EngineConfig.from_env(),
                    ref_config.EngineConfig.from_env())
    for field in ("exchange_capacity_slack", "index_chunk_size",
                  "exchange_mode", "scan_engine"):
        assert getattr(cfg, field) == getattr(ref_cfg, field), field
    assert cfg.exchange_capacity_slack == 1.5 and cfg.index_chunk_size == 512


def test_port_builds_its_own_native_library():
    from duckdb_parquet_parser_tpu.host import build as ref_build

    lib, ref_lib = build.build_library(), ref_build.build_library()
    assert lib.name.startswith("libdpqhost_torch-")
    assert lib != ref_lib and lib.name != ref_lib.name
    assert build._NATIVE_DIR != ref_build._NATIVE_DIR
    assert "duckdb_parquet_parser_tpu_torch" in str(build._NATIVE_DIR)
    assert bindings.lib() is not ref_bindings.lib()


def _write(mod_writer, mod_schema, path, seed):
    rng = np.random.default_rng(seed)
    w = mod_writer.ParquetWriter(
        str(path),
        [mod_writer.ColumnSpec("s", mod_schema.ParquetType.BYTE_ARRAY,
                               optional=True),
         mod_writer.ColumnSpec("d", mod_schema.ParquetType.BYTE_ARRAY,
                               optional=True),
         mod_writer.ColumnSpec("i", mod_schema.ParquetType.INT64)],
        key_value={"made": "by test"})
    for _rg in range(2):
        w.write_row_group({
            "s": fixtures.random_strings(rng, 700, null_p=0.1),
            "d": fixtures.random_strings(rng, 700, n_unique=9, null_p=0.2),
            "i": rng.integers(0, 1000, 700).astype(np.int64)})
    w.close()
    return str(path)


def test_writers_give_identical_files_and_prescans(tmp_path):
    a = _write(writer, schema, tmp_path / "port.parquet", 5)
    b = _write(ref_writer, ref_schema, tmp_path / "ref.parquet", 5)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    h, rh = bindings.native_open(a), ref_bindings.native_open(a)
    assert bindings.native_meta(h) == ref_bindings.native_meta(rh)
    for col in (0, 1, 2):
        for flags in (bindings.PS_PAYLOAD,
                      bindings.PS_PAYLOAD | bindings.PS_RUNS_ONLY):
            dims, arrays = bindings.native_prescan(h, col, 0, -1, 128, 8,
                                                   flags, 0)
            rdims, rarrays = ref_bindings.native_prescan(rh, col, 0, -1, 128,
                                                         8, flags, 0)
            assert dims == rdims
            assert sorted(arrays) == sorted(rarrays)
            for k in arrays:
                assert arrays[k].dtype == rarrays[k].dtype, k
                np.testing.assert_array_equal(arrays[k], rarrays[k], err_msg=k)
    bindings.lib().dpq_close(h)
    ref_bindings.lib().dpq_close(rh)


def _is_span(decorator) -> bool:
    """Whether a decorator is the port's span, `utils/tracing.annotate`."""
    return (isinstance(decorator, ast.Call)
            and isinstance(decorator.func, ast.Name)
            and decorator.func.id == "annotate")


def _functions(module) -> dict:
    """{qualified name: source dump without docstrings} of every function
    and method a module defines; the port's span decorators
    (`utils/tracing.annotate`), which name a call in profiler timelines
    and change nothing it does, are left out."""
    tree = ast.parse(inspect.getsource(module))
    out = {}

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.ClassDef)):
                name = prefix + child.name
                if isinstance(child, ast.FunctionDef):
                    child.decorator_list = [d for d in child.decorator_list
                                            if not _is_span(d)]
                    body = child.body
                    if (body and isinstance(body[0], ast.Expr)
                            and isinstance(body[0].value, ast.Constant)
                            and isinstance(body[0].value.value, str)):
                        child.body = body[1:] or [ast.Pass()]
                    out[name] = ast.dump(child)
                visit(child, name + ".")

    visit(tree, "")
    return out


def test_assembly_and_metrics_are_verbatim_copies():
    from duckdb_parquet_parser_tpu.host import assembly as ref_assembly
    from duckdb_parquet_parser_tpu.utils import metrics as ref_metrics
    from duckdb_parquet_parser_tpu_torch.host import assembly
    from duckdb_parquet_parser_tpu_torch.utils import metrics

    for mod, ref in ((assembly, ref_assembly), (metrics, ref_metrics)):
        got, want = _functions(mod), _functions(ref)
        assert got == want, mod.__name__
        assert len(want) >= 5


def test_index_checkpoints_and_partition_are_verbatim_copies():
    from duckdb_parquet_parser_tpu.ops import index as ref_index
    from duckdb_parquet_parser_tpu.parallel import partition as ref_partition
    from duckdb_parquet_parser_tpu.utils import checkpoints as ref_ckpt
    from duckdb_parquet_parser_tpu_torch.ops import index
    from duckdb_parquet_parser_tpu_torch.parallel import partition
    from duckdb_parquet_parser_tpu_torch.utils import checkpoints

    for mod, ref, least in ((index, ref_index, 7), (checkpoints, ref_ckpt, 7),
                            (partition, ref_partition, 9)):
        got, want = _functions(mod), _functions(ref)
        assert got == want, mod.__name__
        assert len(want) >= least


# the exchange's device half: `all_to_all_single` in the port, where the
# reference calls its compiler's collectives (and emulates the exact-size
# one on backends that lack it, which the port never needs)
SHUFFLE_PORTED = {"all_to_all_exchange", "ragged_exchange",
                  # one gather for the cold chunks, a visit per salted one
                  "SaltedOwnership.entry_destinations"}
SHUFFLE_DROPPED = {"ragged_exchange_emulated"}
SHUFFLE_ADDED = {"PendingExchange.wait", "_to_exchange"}


def test_shuffle_host_half_and_fleet_state_are_verbatim_copies():
    from duckdb_parquet_parser_tpu.parallel import elastic as ref_elastic
    from duckdb_parquet_parser_tpu.parallel import shuffle as ref_shuffle
    from duckdb_parquet_parser_tpu_torch.parallel import elastic, shuffle

    got, want = _functions(shuffle), _functions(ref_shuffle)
    assert set(want) - set(got) == SHUFFLE_DROPPED
    assert set(got) - set(want) == SHUFFLE_ADDED
    differing = {name for name in set(want) & set(got)
                 if got[name] != want[name]}
    assert differing == SHUFFLE_PORTED, differing
    assert len(set(want) & set(got)) - len(differing) >= 8

    got, want = _functions(elastic), _functions(ref_elastic)
    assert set(got) == set(want)
    differing = {name for name in want if got[name] != want[name]}
    assert differing == {"elastic_distributed_scan"}, differing
    assert sum(name.startswith("FleetState.") for name in want) >= 4


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_salted_entry_destinations_equal(n_devices):
    from duckdb_parquet_parser_tpu.parallel import shuffle as ref_shuffle
    from duckdb_parquet_parser_tpu_torch.parallel import shuffle

    # chunk 0 entry-hot, chunk 1 byte-hot, the rest cold
    chunk_bytes = np.array([4000, 60000] + [500] * 30, np.int64)
    chunk_entries = np.array([4000, 10] + [12] * 30, np.int64)
    chunk_of_entry = np.repeat(np.arange(len(chunk_bytes)), chunk_entries)
    got = shuffle.salted_chunk_owners(chunk_bytes, n_devices, 2.0,
                                      chunk_entries=chunk_entries)
    want = ref_shuffle.salted_chunk_owners(chunk_bytes, n_devices, 2.0,
                                           chunk_entries=chunk_entries)
    np.testing.assert_array_equal(got.primary, want.primary)
    assert (n_devices == 1) or any(len(d) > 1 for d in got.owners)
    a = got.entry_destinations(chunk_of_entry)
    b = want.entry_destinations(chunk_of_entry)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype
    empty = shuffle.salted_chunk_owners(np.zeros(0, np.int64), n_devices)
    assert empty.entry_destinations(np.zeros(0, np.int64)).shape == (0,)


# the reader's functions that differ by design: they call the port's tensor
# decode where the reference calls its xp-generic decode with numpy
READER_PORTED = {"_materialize_fixed", "_string_positions",
                 "ParquetReader.read_pages", "ParquetReader._decode_leaf"}
# and the one helper the port adds: the flatten step that the fixed-width
# and the delta materialization share
READER_ADDED = {"_flatten_decoded"}


def test_reader_copy_differs_only_where_the_decode_is_called():
    from duckdb_parquet_parser_tpu.host import reader as ref_reader
    from duckdb_parquet_parser_tpu_torch.host import reader

    got, want = _functions(reader), _functions(ref_reader)
    assert set(got) - set(want) == READER_ADDED
    assert set(want) <= set(got)
    differing = {name for name in want if got[name] != want[name]}
    assert differing == READER_PORTED, differing
    sig = inspect.signature
    for name in ("read_column", "read_column_by_idx", "read_rows",
                 "read_pages", "read_table", "prescan", "page_stats",
                 "column_iterator", "page_iterator"):
        assert (sig(getattr(reader.ParquetReader, name))
                == sig(getattr(ref_reader.ParquetReader, name))), name


def test_dict_ints_matches_bench(tmp_path, monkeypatch):
    import bench
    from duckdb_parquet_parser_tpu_torch.utils import fixtures as fx

    monkeypatch.setattr(bench, "CACHE", tmp_path / "bench")
    want = bench.gen_dict_fixture(3000)
    got = fx.dict_ints(tmp_path / "port.parquet", 3000)
    assert got.read_bytes() == want.read_bytes()
