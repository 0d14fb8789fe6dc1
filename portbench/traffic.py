"""The one general traffic generator: reads a traffic mix (traffic/<name>.json)
and yields its queries in a balanced rotation drawn from the seed.

A mix names its `route` (routes/<route>.py), a closed loop of one client,
and its templates.  Each template has `negate`, a LIKE string and the
regular expression of the same predicate (for routes that take one), with
{PARAM} slots and the values each slot takes; each combination of slot
values is one query.  The templates alternate in the order the mix lists them, and
each template sends its queries in rounds: every round holds each of its
queries once, in an order the seed permutes anew each round.  So every
seed sends the same queries equally often (the uniform marginal of TPC-H's
qgen) and every window holds the same mix; the seed changes only the order
within a round.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

from .datagen import rng_for


@dataclass(frozen=True)
class Query:
    template: str
    like: str
    regex: str
    negate: bool


def _fill(text: str, values: dict) -> str:
    for k, v in values.items():
        text = text.replace("{" + k + "}", v)
    return text


def templates(spec: dict) -> list[list[Query]]:
    """Each template's queries, one per combination of its slot values."""
    out = []
    for t in spec["templates"]:
        keys = list(t["params"])
        combos = itertools.product(*(t["params"][k] for k in keys))
        out.append([Query(t["name"], _fill(t["like"], dict(zip(keys, c))),
                          _fill(t["regex"], dict(zip(keys, c))),
                          bool(t["negate"])) for c in combos])
    return out


def pool(spec: dict) -> list[Query]:
    """Every query the mix can send, in a fixed order."""
    return [q for group in templates(spec) for q in group]


def _rounds(group: list[Query], rng):
    """`group`'s queries without end, each round a fresh permutation."""
    while True:
        for i in rng.permutation(len(group)):
            yield group[int(i)]


def draw(spec: dict, seed: int):
    """The mix's queries in the order of `seed`, without end: the templates
    in turn, each template's queries in rounds."""
    rng = rng_for(seed, 1)
    streams = [_rounds(group, rng) for group in templates(spec)]
    for stream in itertools.cycle(streams):
        yield next(stream)
