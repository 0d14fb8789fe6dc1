"""Tiny copies of the cells for CPU tests: the configurations' layout and
values, at a few thousand rows."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402

TINY = {"tpch_sf10_orders": dict(rows=2600, row_group_rows=1024),
        "tpch_sf10_part": dict(rows=5000, row_group_rows=2048)}


def tiny_cell(name: str):
    """(cell, configuration, traffic) of cell `name`, its table cut to a few
    thousand rows and named apart from the full-size one (and from another
    test process's: a data directory keeps one file)."""
    cell, cfg, mix = run.cell_parts(run.spec(), name)
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    cfg = dict(cfg, name=f"{cfg['name']}.tiny.{worker}", **TINY[cfg["name"]])
    if "pool_words" in cfg["values"]:
        cfg["values"] = dict(cfg["values"], pool_words=8192)
    return cell, cfg, mix


@pytest.fixture
def tiny():
    return tiny_cell
