"""The port's own copies of the JAX-free layers (duckdb_parquet_parser_tpu_torch/
ops/regex.py, ops/bitprog.py, ops/strings.make_bitap_transition, host/
bindings.py, host/writer.py, host/schema.py, utils/config.py and the native
library built from host/native/) against the reference modules they were
copied from, over the pattern corpus the port's tests use.  Tolerance 0:
tables, programs, traced transitions, prescan arrays and file bytes are
equal."""

from __future__ import annotations

import enum

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


def _outcome(fn, *args):
    """(value, None) or (None, exception class name): both packages must
    refuse the same inputs."""
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return None, type(e).__name__


@pytest.mark.parametrize("pattern", CORPUS)
def test_compile_pattern_tables_and_accepts_equal(pattern):
    got, got_err = _outcome(regex.compile_pattern, pattern)
    want, want_err = _outcome(ref_regex.compile_pattern, pattern)
    assert got_err == want_err
    if want is None:
        return
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.accept, want.accept)
    assert got.table.dtype == want.table.dtype


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
    for field in ("batch_align", "max_dfa_states"):
        assert getattr(cfg, field) == getattr(ref_cfg, field)
    for name in dir(ref_bindings):
        if name.startswith("PS_"):
            assert getattr(bindings, name) == getattr(ref_bindings, name)


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
