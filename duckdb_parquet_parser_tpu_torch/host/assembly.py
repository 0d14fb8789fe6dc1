"""Generic Dremel record assembly over arbitrary schema trees (the port's own
copy of `duckdb_parquet_parser_tpu/host/assembly.py`).

Reconstructs ANY nested shape — list<struct>, structs in lists, maps with
nested values, random trees — from the per-leaf (rep, def, value) slot
streams, matching pyarrow's ``to_pylist`` shapes (LIST → python lists,
STRUCT → dicts, MAP → lists of (key, value) tuples, NULL → None).

The reference cannot read nested files at all (docs/reference_bugs.md #5);
the schema walk this generalizes is the def/rep accounting of
reference src/reader/parquet_reader.cpp:495-557.

Two phases:

1. **Per-leaf marked assembly** (`_assemble_leaf_marked`): each leaf's slot
   stream becomes, per file row, nested python lists along its REPEATED
   ancestors; terminals are ``_Term(d, v)`` carrying the slot's raw def
   level — interpretation (null-at-which-ancestor vs empty-deeper-list) is
   deferred to the merge, which knows the whole tree.
2. **Tree merge** (`merge_rows`): a recursive walk of the schema tree zips
   all leaves positionally.  Every leaf under a defined repeated node holds
   exactly one entry per element (Dremel slot accounting), so the zip is
   index-aligned by construction.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
_CONV_MAP, _CONV_MAP_KV, _CONV_LIST = 1, 2, 3


@dataclass
class _Term:
    """A terminal slot: raw def level + the leaf value (None when the slot
    carries no defined leaf value)."""

    __slots__ = ("d", "v")
    d: int
    v: object


@dataclass
class SchemaNode:
    """One node of the schema tree with Dremel levels precomputed.

    ``def_th``/``rep_th`` are the def/rep levels including this node's own
    contribution (OPTIONAL adds def, REPEATED adds both) — the same
    accounting as the native walk (dpq_reader.hpp::walk_schema)."""

    name: str
    repetition: int  # REQUIRED / OPTIONAL / REPEATED
    converted: int | None
    def_th: int
    rep_th: int
    leaf_idx: int | None = None  # index into meta["columns"] for leaves
    children: list["SchemaNode"] = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> list[int]:
        if self.is_leaf:
            return [self.leaf_idx]
        out: list[int] = []
        for c in self.children:
            out.extend(c.leaves())
        return out


def build_tree(schema: list[dict]) -> SchemaNode:
    """Build the schema tree from the flattened depth-first element list
    (meta["schema"]).  Leaf indices are assigned in walk order — identical
    to the native leaf numbering (dpq_reader.hpp::build_leaves)."""
    counter = [0]
    pos = [0]

    def build(parent_def: int, parent_rep: int, is_root: bool) -> SchemaNode:
        e = schema[pos[0]]
        pos[0] += 1
        rep = int(e.get("repetition", REQUIRED)) if not is_root else REQUIRED
        d, r = parent_def, parent_rep
        if rep == OPTIONAL:
            d += 1
        elif rep == REPEATED:
            d += 1
            r += 1
        node = SchemaNode(
            name=e["name"], repetition=rep, converted=e.get("converted"),
            def_th=d, rep_th=r,
        )
        n_children = int(e.get("num_children", 0) or 0)
        if n_children == 0:
            node.leaf_idx = counter[0]
            counter[0] += 1
        else:
            node.children = [build(d, r, False) for _ in range(n_children)]
        return node

    return build(0, 0, True)


def find_node(root: SchemaNode, dotted: str) -> SchemaNode | None:
    """Resolve a dotted path (relative to the root's children) to a node."""
    node = root
    for seg in dotted.split("."):
        nxt = next((c for c in node.children if c.name == seg), None)
        if nxt is None:
            return None
        node = nxt
    return node


def _assemble_leaf_marked(defs, reps, values, valid, rep_thresholds):
    """Phase 1: one leaf's slot stream → per-row nested lists (one nesting
    level per REPEATED ancestor) with _Term terminals.

    Same level bookkeeping as reader._assemble_nested, but terminals keep
    the raw def level so the merge can interpret them against the tree."""
    rows: list = []
    stack: list = []  # open lists; stack[k-1] = list at repeated level k

    for i in range(len(defs)):
        d, r = int(defs[i]), int(reps[i])
        k_exists = bisect.bisect_right(rep_thresholds, d)
        if r == 0:
            stack = []
            rows.append(None)  # placeholder; terminal below may replace it
        else:
            del stack[r:]
        while len(stack) < k_exists:
            new: list = []
            if stack:
                stack[-1].append(new)
            else:
                rows[-1] = new
            stack.append(new)

        v = values[i] if valid[i] else None
        if v is not None and isinstance(v, np.generic):
            v = v.item()
        term = _Term(d, v)
        if k_exists == 0:
            rows[-1] = term
        else:
            stack[k_exists - 1].append(term)
    return rows


def _first(vals: dict):
    return next(iter(vals.values()))


def _split_by_child(node: SchemaNode, vals: dict) -> list[dict]:
    """Partition the leaf→value map by which child subtree owns each leaf."""
    out = []
    for c in node.children:
        ls = set(c.leaves())
        out.append({k: v for k, v in vals.items() if k in ls})
    return out


def _merge_node(node: SchemaNode, vals: dict):
    """Value of `node` at one structural position. `vals` maps leaf index →
    that leaf's phase-1 value here (a _Term or a nested list)."""
    v0 = _first(vals)
    if isinstance(v0, _Term) and v0.d < node.def_th:
        # this node is the first undefined one (ancestors were checked by
        # the caller): a missing repeated node is an empty list, a missing
        # optional node is NULL
        return [] if node.repetition == REPEATED else None
    if node.repetition == REPEATED:
        n = len(v0)
        lists = list(vals.items())
        for _k, lv in lists:
            if not isinstance(lv, list) or len(lv) != n:
                raise ValueError(
                    "inconsistent repetition structure across leaves "
                    f"under '{node.name}'"
                )
        return [
            _merge_content(node, {k: lv[i] for k, lv in lists})
            for i in range(n)
        ]
    return _merge_content(node, vals)


def _merge_content(node: SchemaNode, vals: dict):
    """Element/point value of `node` once defined-ness and repetition are
    resolved: leaf value, LIST unwrap, MAP entry tuples, or a struct dict."""
    if node.is_leaf:
        t = _first(vals)
        return t.v
    if node.converted in (_CONV_MAP, _CONV_MAP_KV) and len(node.children) == 1:
        kv = node.children[0]
        if kv.repetition == REPEATED and len(kv.children) == 2:
            return _merge_node(kv, vals)  # entries are (k, v) tuples
    if node.converted == _CONV_LIST and len(node.children) == 1 \
            and node.children[0].repetition == REPEATED:
        return _merge_node(node.children[0], vals)
    # MAP key_value group: element is a (key, value) tuple
    parent_conv = getattr(node, "_parent_conv", None)
    if parent_conv in (_CONV_MAP, _CONV_MAP_KV) and len(node.children) == 2:
        kvals, vvals = _split_by_child(node, vals)
        return (_merge_node(node.children[0], kvals),
                _merge_node(node.children[1], vvals))
    # LIST wrapper group ('list' with single 'element' child)
    if parent_conv == _CONV_LIST and _is_list_wrapper_cached(node):
        return _merge_node(node.children[0], vals)
    # plain struct
    parts = _split_by_child(node, vals)
    return {c.name: _merge_node(c, parts[i])
            for i, c in enumerate(node.children)}


def _is_list_wrapper_cached(node: SchemaNode) -> bool:
    if len(node.children) != 1:
        return False
    return not (node.name == "array" or node.name.endswith("_tuple"))


def _annotate_parents(node: SchemaNode, parent_conv=None):
    """Stamp each node with its parent's converted type — the spec's LIST /
    MAP wrapper rules are parent-relative."""
    node._parent_conv = parent_conv  # type: ignore[attr-defined]
    for c in node.children:
        _annotate_parents(c, node.converted)


def merge_rows(field_node: SchemaNode, leaf_rows: dict[int, list]) -> list:
    """Phase 2: zip all leaves of `field_node` into python row values.

    `leaf_rows` maps leaf index → phase-1 per-row values; all streams have
    one entry per file row."""
    _annotate_parents(field_node)
    n = len(_first(leaf_rows))
    for lr in leaf_rows.values():
        if len(lr) != n:
            raise ValueError("leaf row counts disagree")
    return [
        _merge_node(field_node, {k: lr[r] for k, lr in leaf_rows.items()})
        for r in range(n)
    ]
