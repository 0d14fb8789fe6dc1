"""How `correct` is decided: the answers the window produced, held against the
plain reference once the window has closed.

The window keeps the first answer of each query of the pool, and of the
others a share drawn from the seed (at most `MAX_DRAWN`).  The reference
answers each distinct kept pattern once; each kept answer's page ids, match
counts and value counts are compared with it page for page, exactly, and so
are the pages it prunes (those with no match): the configuration's
guarantee is an exact count for every data page.  The numbers compared,
each with its limit:

- `wrong_pages`: pages, over the kept answers, whose id, match count or
  value count differs from the reference's (an answer of the wrong length
  counts all its pages), limit 0;
- `wrong_pruned`: pages, over the kept answers, pruned by one side and not
  by the other (an answer of the wrong length counts all its pages),
  limit 0;
- `wrong_answers`: kept answers with a wrong page, limit 0;
- `failed_ops`: queries of the window that raised, so never answered,
  limit 0.

A window that answers no query fails `failed_ops`: its first query raised.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import reference
from .datagen import Table, rng_for

DRAW_SHARE = 1 / 16
MAX_DRAWN = 64
LIMITS = {"wrong_pages": 0, "wrong_pruned": 0, "wrong_answers": 0,
          "failed_ops": 0}


class Sampler:
    """Which answers of the window are kept for the comparison."""

    def __init__(self, seed: int):
        self.seen: set = set()
        self.drawn = 0
        self.rng = rng_for(seed, 2)

    def keep(self, q) -> bool:
        first = q not in self.seen
        self.seen.add(q)
        draw = self.rng.random() < DRAW_SHARE
        if first:
            return True
        if draw and self.drawn < MAX_DRAWN:
            self.drawn += 1
            return True
        return False


def compare(table: Table, kept, failed_ops: int) -> dict:
    """The numbers compared, for the kept (query, answer) pairs."""
    keys = sorted({(q.like, q.negate) for q, _ans in kept})
    found: dict = {}
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        reference.prepare(table, [like for like, _neg in keys], found, pool)
        want = dict(zip(keys, pool.map(lambda k: reference.page_answer(
            table, reference.row_matches(table, k[0], found), k[1]), keys)))
    wrong_pages = wrong_pruned = wrong_answers = 0
    for q, ans in kept:
        ref = want[q.like, q.negate]
        got = [np.asarray(ans.page_gid), np.asarray(ans.match_counts),
               np.asarray(ans.value_counts)]
        if any(g.shape != w.shape for g, w in zip(got, ref)):
            bad = pruned = table.n_pages
        else:
            bad = int(np.any([g != w for g, w in zip(got, ref)],
                             axis=0).sum())
            pruned = int(((got[1] == 0) != (ref[1] == 0)).sum())
        wrong_pages += bad
        wrong_pruned += pruned
        wrong_answers += bad > 0 or pruned > 0
    return {"wrong_pages": wrong_pages, "wrong_pruned": wrong_pruned,
            "wrong_answers": wrong_answers, "failed_ops": int(failed_ops),
            "answers_checked": len(kept), "patterns_checked": len(want)}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())


def report(numbers: dict) -> dict:
    """The numbers compared, each with its limit, for the result line."""
    return {k: {"value": numbers[k], "limit": lim} for k, lim in LIMITS.items()}
