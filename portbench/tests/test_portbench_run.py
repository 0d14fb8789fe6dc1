"""The harness as a whole: it refuses to run without a card or without the
program, loads nothing of JAX or the JAX package, holds the control and
every fault of the timed path to `correct` false, and a sound run to true."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import control, run, traffic

ROOT = Path(__file__).resolve().parents[2]


def _harness(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "orders_q13_resident",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = _harness(ROOT)
    assert p.returncode == run.EXIT_NO_DEVICE
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_a_run_beside_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _harness(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _sound(cell, cfg, mix, **kw):
    return run.run_cell(cell, cfg, mix, seed=2**31 + 3, seconds=0.3,
                        trace=False, device="cpu", t_start=0.0,
                        metrics=run.cell_metrics(run.spec(), cell, False),
                        **kw)


def test_the_harness_loads_nothing_of_jax(tmp_path):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench.tests.conftest import tiny_cell\n"
        "from portbench import run\n"
        "cell, cfg, mix = tiny_cell('part_type_resident')\n"
        "out = run.run_cell(cell, cfg, mix, seed=7, seconds=0.2, trace=True,\n"
        "    device='cpu', t_start=0.0, metrics=run.cell_metrics(run.spec(), cell, True))\n"
        "print(json.dumps(sorted(run.forbidden_modules())))\n"
        "print(json.dumps(out['correct']))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    found, correct = p.stdout.strip().splitlines()[-2:]
    assert json.loads(found) == [] and json.loads(correct) is True
    assert run.FORBIDDEN >= {"jax", "duckdb_parquet_parser_tpu"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "duckdb_parquet_parser_tpu_torch_x", sys)
    assert run.forbidden_modules() == set()
    monkeypatch.setitem(sys.modules, "duckdb_parquet_parser_tpu.ops", sys)
    assert run.forbidden_modules() == {"duckdb_parquet_parser_tpu"}


@pytest.mark.parametrize("name", ["orders_q13_resident", "part_type_resident",
                                  "orders_q13_cold"])
@pytest.mark.parametrize("seed", [1, 2**31 + 9, 40])
def test_the_control_is_not_correct(tiny, name, seed):
    _cell, cfg, mix = tiny(name)
    numbers = control.control_numbers(cfg, mix, seed, 50)
    assert numbers["answers_checked"] > 0
    assert numbers["wrong_pages"] > 0 and not control.check.verdict(numbers)


def _stale(route_op):
    last = {}

    def op(self, q):
        ans = route_op(self, q)
        out = last.get("ans", ans)
        last["ans"] = ans
        return out
    return op


def _half(route_op):
    def op(self, q):
        ans = route_op(self, q)
        ans.match_counts = ans.match_counts.copy()
        ans.match_counts[ans.match_counts.size // 2:] = 0
        return ans
    return op


def _altered(route_op):
    def op(self, q):
        ans = route_op(self, q)
        ans.match_counts = ans.match_counts.copy()
        ans.match_counts[-1] += 1
        return ans
    return op


FAULTS = {"stale answer": _stale, "half the pages left out": _half,
          "an answer altered": _altered, None: None}


@pytest.mark.parametrize("name", ["orders_q13_resident", "part_type_resident",
                                  "orders_q13_cold"])
@pytest.mark.parametrize("fault", list(FAULTS), ids=str)
def test_faults_of_the_timed_path_are_not_correct(tiny, monkeypatch, name,
                                                  fault):
    cell, cfg, mix = tiny(name)
    if fault is not None:
        route = run_route(mix)
        monkeypatch.setattr(route, "op", FAULTS[fault](route.op))
    out = _sound(cell, cfg, mix)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
    assert all(isinstance(c["value"], int) and isinstance(c["limit"], int)
               for c in out["checks"].values())
    assert out["correct"] is all(c["value"] <= c["limit"]
                                 for c in out["checks"].values())


def run_route(mix):
    from portbench import routes
    return routes.ROUTES[mix["route"]]


@pytest.mark.parametrize("name", ["orders_q13_resident", "part_type_resident"])
def test_the_rotation_is_balanced(name):
    """Each template's queries come in rounds that hold each query once; the
    templates alternate; the seed changes only the order within a round."""
    mix = run.cell_parts(run.spec(), name)[2]
    groups = traffic.templates(mix)
    orders = []
    for seed in (1, 2**31 + 1, 12345678901, -3):
        gen = traffic.draw(mix, seed)
        drawn = [next(gen) for _ in range(len(groups) * 3 * 30)]
        for t, group in enumerate(groups):
            mine = drawn[t::len(groups)]
            assert all(q.template == group[0].template for q in mine)
            for r in range(0, len(mine) - len(group) + 1, len(group)):
                assert sorted(map(str, mine[r:r + len(group)])) \
                    == sorted(map(str, group))
        orders.append(drawn)
    assert orders[0] != orders[1]
    gen = traffic.draw(mix, 1)
    assert [next(gen) for _ in range(len(orders[0]))] == orders[0]
