"""Runs of the route `sharded_scan` on the CPU: rank 0 and one child rank
over gloo, through the whole runner at a test's size.  A sound run reads `correct`
true; each fault of the timed path, planted on rank 0 or on the child where
its shard is made, reads false; a child that raises ends the run with no
result and no process left."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import ranks, run, traffic
from portbench.tests.sharded_run import (CHILD, ENDS_THE_RUN, FAULTS, SEED,
                                         tiny_sharded)

ROOT = Path(__file__).resolve().parents[2]


def _run(tmp_path, fault, *extra):
    """Rank 0's process for `fault` (None: a sound run): (returncode, the
    result line's object or None, stderr)."""
    site = tmp_path / "site"
    site.mkdir()
    if fault in CHILD:
        (site / "sitecustomize.py").write_text(
            "import sys\n"
            "if '--rank' in sys.orig_argv:\n"
            "    from portbench.tests.sharded_run import plant_child\n"
            f"    plant_child({fault!r})\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), str(ROOT)]))
    p = subprocess.run(
        [sys.executable, "-m", "portbench.tests.sharded_run",
         fault or "none", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return p.returncode, json.loads(lines[-1]) if lines else None, p.stderr


def test_a_sound_run_is_correct(tmp_path):
    code, out, err = _run(tmp_path, None)
    assert code == 0, err[-3000:]
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["device"]["count"] == 2
    # the CPU has no device peak to read
    assert set(out["metrics"]) == {"scan_rows_per_s.cold", "setup_s"}
    assert list(out)[-1] == "checks"
    assert "rank 0: device peak" in err and "rank 1: device peak" in err


def test_a_traced_run_reads_rank_0s_layers_and_every_ranks_busy_time(tmp_path):
    cell = tiny_sharded()[0]
    try:
        code, out, err = _run(tmp_path, None, "trace")
    finally:
        # the CPU's profiles of the two ranks, ~0.2 GB each, are not kept
        for path in (run.CACHE / "trace").glob(f"{cell['name']}*.json"):
            path.unlink()
    assert code == 0, err[-3000:]
    assert out["correct"] is True, out["checks"]
    # on the CPU no operation runs on a device: the spans' metrics are
    # there, the device's are not
    assert set(out["metrics"]) == {"prescan_span_ms", "split_plan_ms",
                                   "upload_span_ms", "h2d_gb_per_scan"}
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert "rank 1: device peak 0 bytes, busy 0.0 s" in err


def test_the_windows_first_query_is_not_the_one_set_up_ends_with():
    _cell, _cfg, mix = tiny_sharded()
    assert next(traffic.draw(mix, SEED)) != traffic.pool(mix)[0]


@pytest.mark.parametrize("fault", [f for f in FAULTS if f not in ENDS_THE_RUN])
def test_faults_of_the_sharded_path_are_not_correct(tmp_path, fault):
    code, out, err = _run(tmp_path, fault)
    assert code == 0, err[-3000:]
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("fault, says", [
    ("a child raises", "a planted fault of the child rank"),
    ("a child loads jax", "rank 1 loaded ['jax']")])
def test_a_child_that_fails_ends_the_run_with_no_result(tmp_path, fault, says):
    code, out, err = _run(tmp_path, fault)
    assert code == ranks.EXIT_RANK, err[-3000:]
    assert out is None
    assert says in err
    pids = [int(ln.split()[-1]) for ln in err.splitlines()
            if ln.startswith("rank 1: pid ")]
    assert len(pids) == 1
    assert not Path(f"/proc/{pids[0]}").exists()
