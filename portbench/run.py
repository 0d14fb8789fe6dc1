"""Runs one cell of BENCHMARK.json once and prints one JSON line.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program
(`duckdb_parquet_parser_tpu_torch`), on a machine with as many CUDA cards as
the cell asks for.  Without them it exits with code 2 and prints no result.

A run: make the cell's table from the seed, write it and flush it to disk
(datagen.py, on a thread while PyTorch loads); load it into the route the
traffic names and warm up every query of the pool (routes/<route>.py).
That is `setup_s`, from the process's start.  A cell of more than one card
runs one process a card (ranks.py): this process is rank 0, and starting
the others and forming their group is set-up too.
Then a closed loop of one client sends the traffic's queries in the seed's
order for `--seconds`, the last query ending the window.  With `--trace 1`
the window runs under the profiler and the span wrappers (trace.py), and the
cell's per-layer metrics are read (metrics/<name>.py) in place of the
end-to-end ones; where a cell has more than one card, every rank runs the
profiler, the metrics and the breakdown are rank 0's, and `busy_s` is the
cards' mean.  Once the window has closed and the device's peak memory is
read, the program's state is freed and the kept answers are held against the
plain reference (check.py).  What the host did over the window goes to
standard error, then the numbers compared, each beside its limit.

The harness holds no name of a cell, configuration, mix, route or metric:
each is found by its name in BENCHMARK.json or in the mix, as
configs/<config>.json, traffic/<traffic>.json, routes/<route>.py and
metrics/<metric>.py.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import host

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "duckdb_parquet_parser_tpu"}
EXIT_NO_DEVICE, EXIT_FORBIDDEN = 2, 3


def set_cache_env() -> None:
    """Every build the program makes goes to a fixed directory of the
    checkout.  The native host library is built with g++: the GPU machine's
    default compiler links it so that it fails."""
    os.environ["CXX"] = "g++"
    os.environ["DPQ_BUILD_CACHE"] = str(CACHE / "native")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_parts(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the cell named `workload`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end ones, or with
    `trace` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in names]


def metric_reader(name: str):
    """The `read(run)` function of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


class Window:
    """What the measured window did, for the metric readers."""

    def __init__(self):
        self.latencies: list[float] = []
        self.ends: list[float] = []
        self.attempted = 0
        self.failed = 0
        self.seconds = 0.0
        self.table = None
        self.device_kind = ""
        self.spans = None
        self.trace = None
        self.launches: dict[str, int] = {}
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.busy_s = 0.0

    @property
    def ops(self) -> int:
        return self.attempted - self.failed

    def slices(self, width: float) -> list[int]:
        """How many queries ended in each `width` seconds of the window."""
        out = [0] * (int(self.seconds // width) + 1)
        for t in self.ends:
            out[int(t // width)] += 1
        return out

    def span_seconds(self, name: str) -> float:
        return self.spans.seconds.get(name, 0.0) if self.spans else 0.0


def launch_counts() -> dict[str, int]:
    """The program's kernel launch counters (one a launch on the card)."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import (
        dfa_walk, dict_lookup, stream_matcher)
    return {"stream_matcher": stream_matcher.launches,
            "dict_lookup": dict_lookup.launches,
            "dfa_walk": dfa_walk.launches}


def make_table(cfg: dict, seed: int):
    """The cell's table for `seed`, written to its file."""
    from . import datagen
    return datagen.make(cfg, seed, datagen.data_path(cfg, seed))


def run_cell(cell: dict, cfg: dict, traffic: dict, *, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             metrics: list[dict], marks: list | None = None,
             table=None) -> dict:
    """One run of the cell on `device`; returns the result line's object.
    `t_start` is the process's start on the `time.perf_counter` clock;
    `marks` the (name, time) of set-up's steps so far; `table` a future of
    `make_table(cfg, seed)` already started (made here otherwise).  Where
    the cell's `chips` is over 1 this process is rank 0 of that many, one a
    card from `device` on (ranks.py), meeting at the file named after the
    cell under build/portbench/group/."""
    import torch

    from . import check, routes
    from . import traffic as traffic_gen

    route_cls = routes.find(traffic["route"])
    marks = list(marks or [])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    ranks = int(cell["chips"])
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with contextlib.ExitStack() as stack:
        group = rank = None
        if ranks > 1:
            from .ranks import Group
            group = stack.enter_context(Group(
                ranks, dev, CACHE / "group" / cell["name"],
                ["--workload", cell["name"], "--seed", str(seed),
                 "--seconds", str(seconds), "--trace", str(int(trace))],
                seconds))
        marks.append(("device", time.perf_counter()))
        table = make_table(cfg, seed) if table is None else table.result()
        marks.append(("data", time.perf_counter()))
        pool = traffic_gen.pool(traffic)
        if group is None:
            route = route_cls(cfg, table, seed, dev)
        else:
            rank = group.join()
            route = route_cls(cfg, table, seed, dev, mesh=rank.mesh)
            if hasattr(route, "prepare"):
                route.prepare(pool)
            # the others open the file and find the kernels once rank 0
            # has made them
            rank.share({"cfg": cfg, "traffic": traffic, "seed": seed,
                        "table": str(table.path),
                        "trace": str(CACHE / "trace" / f"{cell['name']}.json")})
            marks.append(("group", time.perf_counter()))
        route.setup(pool)
        if cuda:
            torch.cuda.synchronize(dev)
        if rank is not None:
            rank.barrier()
        marks.append(("warm", time.perf_counter()))
        win = Window()
        win.setup_s = time.perf_counter() - t_start
        win.table = table
        win.device_kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
        print("set-up: " + ", ".join(
            f"{name} {t - prev:.3f} s" for (name, t), prev in
            zip(marks, [t_start] + [t for _n, t in marks])), file=sys.stderr)

        sampler = check.Sampler(seed)
        kept = []
        queries = traffic_gen.draw(traffic, seed)
        agree = rank.agree if rank is not None else bool
        prof = None
        if trace:
            from . import trace as tracing
            win.spans = tracing.Spans()
            prof = tracing.profiler()
            prof.start()
        before = launch_counts()
        reading = host.Reading()
        t0 = time.perf_counter()
        go = True
        # every rank makes the same calls: rank 0 says go or stop before
        # each query
        while agree(go):
            q = next(queries)
            ts = time.perf_counter()
            try:
                with (torch.profiler.record_function("query") if trace
                      else contextlib.nullcontext()):
                    ans = route.op(q)
            except Exception as e:  # an answer that never comes
                print(f"query {q.like!r} raised {type(e).__name__}: {e}",
                      file=sys.stderr)
                if rank is not None:
                    raise  # the other ranks cannot leave the collective
                ans = None
                win.failed += 1
            te = time.perf_counter()
            win.attempted += 1
            win.ends.append(te - t0)
            if ans is not None:
                win.latencies.append(te - ts)
                if sampler.keep(q):
                    kept.append((q, ans))
            go = te - t0 < seconds
        win.seconds = te - t0
        host_line = reading.close()
        after = launch_counts()
        win.launches = {k: after[k] - before[k] for k in after}
        if trace:
            prof.stop()
            win.spans.close()
            win.trace = tracing.read_profile(
                prof, CACHE / "trace" / f"{cell['name']}.json")
            del prof
            win.busy_s = win.trace.busy_seconds()
        if cuda:
            win.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
        if group is not None:
            # the fullest card's peak; the cards' mean busy time
            ends = rank.gather(win.peak_bytes, win.busy_s)
            for r, (peak, busy) in enumerate(ends):
                print(f"rank {r}: device peak {peak} bytes"
                      + (f", busy {busy} s" if trace else ""), file=sys.stderr)
            win.peak_bytes = max(peak for peak, _busy in ends)
            win.busy_s = sum(busy for _peak, busy in ends) / len(ends)
            group.close()

    values = {}
    for m in metrics:
        v = metric_reader(m["name"]).read(win)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": win.device_kind, "count": int(cell["chips"]),
                   "memory_peak_bytes": win.peak_bytes}
    breakdown = None
    if trace:
        device_info["busy_s"] = win.busy_s
        device_info["window_s"] = win.seconds
        breakdown = win.trace.breakdown()

    t_ref = time.perf_counter()
    if hasattr(route, "answer"):
        kept = [(q, route.answer(a)) for q, a in kept]
    # the program's state goes before the reference runs
    route.close()
    del route, ans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.compare(table, kept, win.failed)
    print(f"setup {win.setup_s:.3f} s, window {win.seconds:.3f} s, "
          f"reference {time.perf_counter() - t_ref:.3f} s, "
          f"{win.attempted} queries, {numbers['answers_checked']} answers "
          f"of {numbers['patterns_checked']} patterns checked; queries ended "
          f"in each 5 s of the window: {win.slices(5.0)}", file=sys.stderr)
    print(f"host over the window: {host_line}", file=sys.stderr)
    out = {"correct": check.verdict(numbers), "attempted": win.attempted,
           "failed": win.failed, "metrics": values, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = check.report(numbers)
    return out


def forbidden_modules() -> set[str]:
    return {m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN


def main(argv=None) -> int:
    t_start = host.process_start()
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a child rank of a cell of more than one card (ranks.py)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--ranks", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", help=argparse.SUPPRESS)
    ap.add_argument("--device", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        host.die_with_parent()
        set_cache_env()
        from . import ranks
        return ranks.child(args)
    marks = [("interpreter", time.perf_counter())]
    set_cache_env()
    bench = spec()
    cell, cfg, traffic = cell_parts(bench, args.workload)

    with ThreadPoolExecutor(max_workers=1) as maker:
        # numpy makes the table while PyTorch loads, where a card can be
        table = maker.submit(make_table, cfg, args.seed) \
            if host.card_present() else None
        import torch
        marks.append(("torch", time.perf_counter()))
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return EXIT_NO_DEVICE
        out = run_cell(cell, cfg, traffic, seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace),
                       device="cuda:0", t_start=t_start,
                       metrics=cell_metrics(bench, cell, bool(args.trace)),
                       marks=marks, table=table)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {sorted(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
