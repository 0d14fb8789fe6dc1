"""BENCHMARK.json against the contract's form, and every file it names found
by name."""

import json
import re
from pathlib import Path

import pytest

from portbench import routes, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


def test_names_unique_and_entries_keyed_as_the_contract():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_end_to_end_metrics_are_the_five_and_each_cell_decides_by_one():
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "queries_per_s", "query_p95_ms", "device_peak_gb", "setup_s"]
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(BENCH, w, False)}
        layers = {m["name"] for m in run.cell_metrics(BENCH, w, True)}
        # the cold cell's rate spreads too widely for a bound: it is read
        # as a layer's metric there (PERF.md §2)
        assert e2e & {"queries_per_s", "query_p95_ms"} \
            or "scan_rows_per_s.cold" in layers


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        cell = {"name": w["name"]}
        e2e = {m["name"] for m in run.cell_metrics(BENCH, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(BENCH, cell, True)
    for m in BENCH["per_layer"]:
        for name in m["workloads"]:
            cell = {"name": name}
            assert m["moves"] in {e["name"] for e in run.cell_metrics(BENCH, cell, False)}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell, cfg, mix = run.cell_parts(BENCH, w["name"])
    entry = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert cfg["name"] == w["config"]
    assert entry["file"].startswith("portbench/") and entry["source"] == cfg["source"]
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert (routes.HERE / f"{mix['route']}.py").is_file()


ROUTE_FILES = sorted(p.stem for p in routes.HERE.glob("*.py")
                     if p.stem != "__init__")


@pytest.mark.parametrize("name", ROUTE_FILES)
def test_each_route_is_found_by_its_file(name):
    route = routes.find(name)
    assert route.__module__ == f"portbench_route_{name}"
    assert all(callable(getattr(route, m)) for m in ("setup", "op", "close"))


def test_the_routes_are_files_and_an_unknown_route_is_refused():
    assert {"resident_scan", "streaming_scan", "sharded_scan"} <= set(ROUTE_FILES)
    with pytest.raises(SystemExit, match="no route"):
        routes.find("no_such_route")


def test_no_harness_module_holds_a_route_name():
    """A route is added by its file alone: no other module of the harness
    (its tests aside) names one."""
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for name in ROUTE_FILES:
            if path.stem != name:
                assert name not in text, (path.relative_to(ROOT), name)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    mod = run.metric_reader(m["name"])
    assert callable(mod.read) and mod.UNIT == m["unit"]
    if "layer" in m:
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
    if m["unit"] == "%" and "roofline" in m["name"]:
        assert m["name"].split(".")[0].endswith("_roofline")


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)


def test_harness_holds_no_cell_configuration_or_pattern_name():
    names = {w["name"] for w in BENCH["workloads"]} \
        | {c["name"] for c in BENCH["configs"]} \
        | {w["traffic"] for w in BENCH["workloads"]} \
        | {"special", "PROMO", "o_comment", "p_type"}
    for path in (ROOT / "portbench").glob("*.py"):
        text = path.read_text()
        for name in names:
            assert name not in text, (path.name, name)


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel
