"""The control of `correct`: the comparison has to fail it.

The configurations state no precision; they state a guarantee, an exact
match count for every data page.  The control breaks it the way a tempting
shortcut would: it is the reference put in the program's place, answering
each page with a 0 / 1 survivor indicator (does any value of the page
count?) in place of the count, as the program's own native host scan does
with `exact_counts=False`.  It answers the queries a window would send for
the seed, and the window's sampler picks the answers compared.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--queries N]

prints, for each seed, the numbers compared and whether the run would be
correct.  It needs no card: the control runs on the host at the cell's own
size.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import numpy as np

from . import check, datagen, reference, run, traffic


@dataclass
class Answer:
    page_gid: np.ndarray
    match_counts: np.ndarray
    value_counts: np.ndarray


def control_answers(table, queries, seed: int, found: dict) -> list:
    """The kept (query, control answer) pairs of a window of `queries`."""
    sampler = check.Sampler(seed)
    matches: dict[str, np.ndarray] = {}
    kept = []
    for q in queries:
        if not sampler.keep(q):
            continue
        if q.like not in matches:
            matches[q.like] = reference.row_matches(table, q.like, found)
        gid, counts, values = reference.page_answer(table, matches[q.like],
                                                    q.negate)
        kept.append((q, Answer(gid, np.minimum(counts, 1), values)))
    return kept


def control_numbers(cfg: dict, mix: dict, seed: int, n_queries: int) -> dict:
    table = datagen.make(cfg, seed)
    gen = traffic.draw(mix, seed)
    queries = [next(gen) for _ in range(n_queries)]
    return check.compare(table, control_answers(table, queries, seed, {}), 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--queries", type=int, default=200)
    args = ap.parse_args(argv)
    _cell, cfg, mix = run.cell_parts(run.spec(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = control_numbers(cfg, mix, seed, args.queries)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": check.verdict(numbers),
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
