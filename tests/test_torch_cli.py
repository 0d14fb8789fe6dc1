"""The port's command line (duckdb_parquet_parser_tpu_torch/cli.py) against
the JAX package's: for the same file and arguments `main(argv)` returns the
same code and writes the same bytes to stdout, in every mode.  The
reference's `--engine numpy` and `--engine jax` are the port's `--engine
torch --device cpu`."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest

from duckdb_parquet_parser_tpu import cli as ref_cli
from duckdb_parquet_parser_tpu_torch import cli
from tests import fixtures


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    return {
        "plain": fixtures.strings_file(d / "s.parquet",
                                       np.random.default_rng(77), n=2000,
                                       null_p=0.15),
        "dict": fixtures.strings_file(d / "d.parquet",
                                      np.random.default_rng(78), n=1500,
                                      null_p=0.1, n_unique=11),
        "mixed": fixtures.mixed_file(d / "m.parquet",
                                     np.random.default_rng(79)),
    }


def run(mod, argv, capsys):
    capsys.readouterr()
    try:
        rc = mod.main(list(argv))
    except SystemExit as e:  # argparse refuses the arguments
        rc = e.code
    return rc, capsys.readouterr().out


SCAN = ["--regex-column", "{col}", "--regex"]
# (file, port arguments, reference arguments or None for the same)
CASES = {
    "info-plain": ("plain", [], None),
    "info-mixed": ("mixed", [], None),
    "scan-native": ("plain", SCAN + ["o[a-z]t"], None),
    "scan-native-neg-rows": (
        "plain", SCAN + ["zz", "--neg-regex", "--rows", "--device", "cpu"],
        SCAN + ["zz", "--neg-regex", "--rows"]),
    "scan-native-like": ("dict", SCAN + ["%al_ha%", "--like"], None),
    "scan-native-dict": ("dict", SCAN + ["alpha"], None),
    "scan-torch-cpu": (
        "plain", SCAN + ["o[a-z]t", "--engine", "torch", "--device", "cpu"],
        SCAN + ["o[a-z]t", "--engine", "jax"]),
    "scan-torch-cpu-golden": (
        "plain", SCAN + ["ab|q", "--rows", "--engine", "torch", "--device",
                         "cpu"],
        SCAN + ["ab|q", "--rows", "--engine", "numpy"]),
    "scan-torch-cpu-dict-neg": (
        "dict", SCAN + ["alpha.*_1", "--neg-regex", "--rows", "--engine",
                        "torch", "--device", "cpu"],
        SCAN + ["alpha.*_1", "--neg-regex", "--rows", "--engine", "numpy"]),
    "scan-torch-cpu-mixed-city": (
        "mixed", ["--regex-column", "city", "--regex", "kilo", "--engine",
                  "torch", "--device", "cpu"],
        ["--regex-column", "city", "--regex", "kilo", "--engine", "numpy"]),
    "scan-torch-cpu-re-fallback": (
        "plain", SCAN + ["([a-m])\\1", "--rows", "--engine", "torch",
                         "--device", "cpu"],
        SCAN + ["([a-m])\\1", "--rows", "--engine", "jax"]),
    "scan-not-byte-array": ("mixed", ["--regex-column", "i64", "--regex",
                                      "1"], None),
    "scan-half-arguments": ("plain", ["--regex-column", "s"], None),
    "index": ("plain", ["index", "{file}", "s"], None),
    "index-chunk-size": ("dict", ["index", "{file}", "s", "--chunk-size",
                                  "700"], None),
    "column-strings": ("plain", ["column", "{file}", "s"], None),
    "column-row-group": ("mixed", ["column", "{file}", "f64", "--row-group",
                                   "1"], None),
    "column-bool": ("mixed", ["column", "{file}", "flag"], None),
    "table": ("mixed", ["table", "{file}"], None),
    "table-columns-limit": ("mixed", ["table", "{file}", "i32", "city",
                                      "--limit", "4"], None),
    "stats": ("mixed", ["stats", "{file}", "i64"], None),
    "stats-prune": ("mixed", ["stats", "{file}", "code", "--prune-op",
                              "between", "--value", "8", "--hi", "12"],
                    None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_prints_the_reference_bytes(files, capsys, case):
    name, argv, ref_argv = CASES[case]
    path = str(files[name])

    def fill(args):
        args = [a.format(file=path, col="s") for a in args]
        return args if "{file}" in "".join(argv) else [path] + args

    got = run(cli, fill(argv), capsys)
    want = run(ref_cli, fill(argv if ref_argv is None else ref_argv), capsys)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert want[0] in (0, 2)
    if want[0] == 0:
        assert want[1]


@pytest.mark.parametrize("argv", [[], ["index"], ["column"], ["table"],
                                  ["stats"]])
def test_cli_cannot_open_returns_1(tmp_path, capsys, argv):
    missing = str(tmp_path / "missing.parquet")
    args = argv + [missing] + (["s"] if argv and argv[0] != "table" else [])
    assert run(cli, args, capsys) == run(ref_cli, args, capsys) == (1, "")


def test_cli_device_engine_defaults_to_the_card(files, capsys):
    """`--engine torch` runs on the card unless the caller asks for the
    CPU: without a card it raises and does not fall back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main([str(files["plain"]), "--regex-column", "s", "--regex", "ab",
                  "--engine", "torch"])
    capsys.readouterr()


def test_cli_runs_as_a_module(files):
    r = subprocess.run(
        [sys.executable, "-m", "duckdb_parquet_parser_tpu_torch.cli", "index",
         str(files["plain"]), "s"], capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("Total tuples: 4000\nTotal chunks: ")
