"""Host-side regex compilation: pattern -> dense DFA byte-transition table
(the port's own copy of `duckdb_parquet_parser_tpu/ops/regex.py`).

The reference README specifies a regex page-pruning mode backed by re2
(reference: README.md:54-64) but the snapshot ships no implementation, so the
behavioral contract here is: per-value *search* semantics (unanchored unless
^/$ are used, like re2 PartialMatch / SQL LIKE '%..%'), with `--neg-regex`
inverting the per-value accept; a page is reported when it has NO accepted
values.

Compilation is classic Thompson NFA -> subset-construction DFA over raw bytes.
Search semantics fold into the automaton itself: an implicit `.*` is wrapped
around the pattern on the unanchored sides, and acceptance is evaluated after
the whole value is consumed — so the device matcher is a single table walk per
byte with no backtracking and no per-value state beyond one int32.

Supported syntax: literals, '.', classes [...] (ranges, negation), escapes
(\\d \\D \\w \\W \\s \\S \\. etc.), groups (), alternation |, repeats * + ?
{m} {m,} {m,n}, anchors ^ $ (at the pattern edges).  SQL LIKE patterns
translate via `like_to_regex` ('%' -> '.*', '_' -> '.').  Anything the subset
cannot express raises UnsupportedPattern and callers fall back to the host
matcher (scan.py), which guarantees identical survivor sets either way.
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass

import numpy as np

MAX_DFA_STATES = 4096


class UnsupportedPattern(ValueError):
    pass


class InnerAnchors(UnsupportedPattern):
    """'^'/'$' away from the pattern edges — the DFA compiler cannot model
    them, but bitprog resolves the unsatisfiable cases to never-match
    machines (compile_pattern consults it before giving up)."""
    pass


# ── NFA construction ────────────────────────────────────────────────────────

ANY = frozenset(range(256))

_CLASS_ESCAPES = {
    "d": frozenset(range(ord("0"), ord("9") + 1)),
    "w": frozenset(
        list(range(ord("a"), ord("z") + 1))
        + list(range(ord("A"), ord("Z") + 1))
        + list(range(ord("0"), ord("9") + 1))
        + [ord("_")]
    ),
    "s": frozenset(map(ord, " \t\n\r\f\v")),
    "n": frozenset([10]),
    "t": frozenset([9]),
    "r": frozenset([13]),
}


class _NFA:
    """States hold edge lists [(byteset | None, target)]; None = epsilon."""

    def __init__(self):
        self.edges: list[list[tuple[frozenset | None, int]]] = []

    def state(self) -> int:
        self.edges.append([])
        return len(self.edges) - 1

    def link(self, a: int, b: int, symbols: frozenset | None = None) -> None:
        self.edges[a].append((symbols, b))


@dataclass
class _Frag:
    start: int
    end: int


class _Parser:
    def __init__(self, pattern: str, nfa: _NFA):
        self.p = pattern
        self.i = 0
        self.nfa = nfa

    def peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    # grammar: alt := concat ('|' concat)* ; concat := repeat* ;
    #          repeat := atom ('*'|'+'|'?'|'{m,n}')*
    def parse_alt(self) -> _Frag:
        frags = [self.parse_concat()]
        while self.peek() == "|":
            self.take()
            frags.append(self.parse_concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.state(), self.nfa.state()
        for f in frags:
            self.nfa.link(s, f.start)
            self.nfa.link(f.end, e)
        return _Frag(s, e)

    def parse_concat(self) -> _Frag:
        frags: list[_Frag] = []
        while self.peek() is not None and self.peek() not in "|)":
            frags.append(self.parse_repeat())
        if not frags:
            s = self.nfa.state()
            return _Frag(s, s)
        for a, b in zip(frags, frags[1:]):
            self.nfa.link(a.end, b.start)
        return _Frag(frags[0].start, frags[-1].end)

    MAX_COUNTED = 128  # expansion bound for {m,n}

    def parse_repeat(self) -> _Frag:
        atom_start = self.i
        frag = self.parse_atom()
        atom_src = self.p[atom_start : self.i]
        while (c := self.peek()) in ("*", "+", "?", "{"):
            if c == "{":
                frag = self._counted(frag, atom_src)
                atom_src = None  # re cannot double-quantify either
                continue
            self.take()
            s, e = self.nfa.state(), self.nfa.state()
            self.nfa.link(s, frag.start)
            self.nfa.link(frag.end, e)
            if c in "*?":
                self.nfa.link(s, e)
            if c in "*+":
                self.nfa.link(frag.end, frag.start)
            frag = _Frag(s, e)
        return frag

    def _counted(self, frag: _Frag, atom_src: str | None) -> _Frag:
        # {m}, {m,}, {m,n} — expanded by re-parsing the atom source; each
        # clone is a fresh NFA fragment (Thompson fragments cannot be shared).
        m = _re.match(r"\{(\d+)(,(\d*))?\}", self.p[self.i :])
        if not m or atom_src is None:
            raise UnsupportedPattern("bad counted repeat")
        self.i += m.end()
        lo = int(m.group(1))
        if m.group(2) is None:
            hi: int | None = lo
        elif m.group(3) == "":
            hi = None  # {m,}
        else:
            hi = int(m.group(3))
        if hi is not None and hi < lo:
            raise UnsupportedPattern("bad counted repeat bounds")
        if lo > self.MAX_COUNTED or (hi or 0) > self.MAX_COUNTED:
            raise UnsupportedPattern("counted repeat too large")

        def clone() -> _Frag:
            sub = _Parser(atom_src, self.nfa)
            f = sub.parse_alt()
            if sub.i != len(atom_src):
                raise UnsupportedPattern("bad counted repeat atom")
            return f

        pieces = [frag] + [clone() for _ in range(max(lo - 1, 0))] if lo else []
        if not pieces:
            s = self.nfa.state()
            base = _Frag(s, s)
        else:
            for a, b in zip(pieces, pieces[1:]):
                self.nfa.link(a.end, b.start)
            base = _Frag(pieces[0].start, pieces[-1].end)

        if hi is None:  # {m,}: trailing star
            f = clone()
            s, e = self.nfa.state(), self.nfa.state()
            self.nfa.link(s, f.start)
            self.nfa.link(f.end, e)
            self.nfa.link(s, e)
            self.nfa.link(f.end, f.start)
            self.nfa.link(base.end, s)
            return _Frag(base.start, e)
        for _ in range(hi - lo):  # optional copies
            f = clone()
            s, e = self.nfa.state(), self.nfa.state()
            self.nfa.link(s, f.start)
            self.nfa.link(f.end, e)
            self.nfa.link(s, e)
            self.nfa.link(base.end, s)
            base = _Frag(base.start, e)
        return base

    def parse_atom(self) -> _Frag:
        c = self.take()
        if c == "(":
            # non-capturing prefix (?: accepted and ignored
            if self.peek() == "?":
                self.take()
                if self.peek() != ":":
                    raise UnsupportedPattern("lookaround / named groups")
                self.take()
            frag = self.parse_alt()
            if self.peek() != ")":
                raise UnsupportedPattern("unbalanced group")
            self.take()
            return frag
        if c == "[":
            return self._leaf(self._char_class())
        if c == ".":
            return self._leaf(ANY)
        if c == "\\":
            return self._leaf(self._escape(self.take()))
        if c in "*+?{":
            raise UnsupportedPattern(f"dangling quantifier '{c}'")
        if c in "^$":
            raise InnerAnchors("inner anchors")
        return self._leaf(frozenset([ord(c)]))

    def _leaf(self, symbols: frozenset) -> _Frag:
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.link(s, e, symbols)
        return _Frag(s, e)

    def _escape(self, c: str) -> frozenset:
        return escape_set(c)

    def _char_class(self) -> frozenset:
        out, self.i = parse_class_at(self.p, self.i)
        return out


def escape_set(c: str) -> frozenset:
    """Byte set of escape `\\c` (shared by the DFA and bit-parallel
    compilers)."""
    if c in _CLASS_ESCAPES:
        return _CLASS_ESCAPES[c]
    if c in ("D", "W", "S"):
        return ANY - _CLASS_ESCAPES[c.lower()]
    if c.isalnum():
        raise UnsupportedPattern(f"escape \\{c}")
    return frozenset([ord(c)])


def parse_class_at(p: str, i: int) -> tuple[frozenset, int]:
    """Parses a [...] class body starting just after '['; returns
    (byte set, index after ']')."""
    negate = False
    if i < len(p) and p[i] == "^":
        i += 1
        negate = True
    items: set[int] = set()
    first = True
    while True:
        if i >= len(p):
            raise UnsupportedPattern("unterminated class")
        c = p[i]
        if c == "]" and not first:
            i += 1
            break
        first = False
        i += 1
        if c == "\\":
            if i >= len(p):
                raise UnsupportedPattern("unterminated class")
            items |= escape_set(p[i])
            i += 1
            continue
        lo = ord(c)
        if i < len(p) and p[i] == "-" and i + 1 < len(p) and p[i + 1] != "]":
            hi = ord(p[i + 1])
            items |= set(range(lo, hi + 1))
            i += 2
        else:
            items.add(lo)
    out = frozenset(items)
    return (ANY - out if negate else out), i


# ── DFA ─────────────────────────────────────────────────────────────────────


@dataclass
class DFA:
    """Dense byte DFA.  `table[s, b]` = next state; `accept[s]` = accepting.
    Matching = walk all bytes of the value, then test accept[final]."""

    table: np.ndarray  # [S, 256] int32
    accept: np.ndarray  # [S] bool
    pattern: str

    @property
    def n_states(self) -> int:
        return self.table.shape[0]

    def match_str(self, data: bytes) -> bool:
        s = 0
        for b in data:
            s = int(self.table[s, b])
        return bool(self.accept[s])

    def byte_classes(self) -> "ByteClasses":
        """Byte-class compression (the classic lexer-generator trick): bytes
        whose transition columns are identical across all states form one
        class; real patterns need ~5-20 classes, so the device matcher can
        one-hot over classes instead of all 256 byte values."""
        cols = self.table.T  # [256, S]
        _, inverse = np.unique(cols, axis=0, return_inverse=True)
        class_of = inverse.astype(np.int32)  # [256]
        n_classes = int(class_of.max()) + 1
        # class table: [S, C]
        reps = np.zeros(n_classes, np.int32)
        for b in range(256):
            reps[class_of[b]] = b
        class_table = self.table[:, reps]  # [S, C]
        # interval list per class: runs of consecutive equal class ids
        lo, hi, cls = [], [], []
        start = 0
        for b in range(1, 257):
            if b == 256 or class_of[b] != class_of[start]:
                lo.append(start)
                hi.append(b - 1)
                cls.append(int(class_of[start]))
                start = b
        return ByteClasses(
            class_of=class_of,
            table=class_table,
            n_classes=n_classes,
            interval_lo=np.array(lo, np.int32),
            interval_hi=np.array(hi, np.int32),
            interval_class=np.array(cls, np.int32),
        )


@dataclass
class ByteClasses:
    """Byte-class view of a DFA: `table[s, c]` over C << 256 classes, plus
    the interval decomposition of byte->class used by the device matcher."""

    class_of: np.ndarray       # [256] i32
    table: np.ndarray          # [S, C] i32
    n_classes: int
    interval_lo: np.ndarray    # [K] i32 (inclusive)
    interval_hi: np.ndarray    # [K] i32 (inclusive)
    interval_class: np.ndarray # [K] i32


def substring_chain(pattern: str) -> list[bytes] | None:
    """Detects '%lit1%lit2%...'-class patterns: an unanchored sequence of
    literal needles joined by '.*'.  These get the Shift-And (bitap) fast
    path — exact ordered-substring matching with a few int32 vector ops per
    byte instead of a DFA transition.  Returns the needle list, or None when
    the pattern is not a pure substring chain (or needles exceed 31 bytes,
    the bitap word width)."""
    pat = pattern
    # '^.*' / '.*$' edges are equivalent to unanchored search (LIKE '%..%'
    # translations arrive in this shape)
    if pat.startswith("^.*"):
        pat = pat[1:]
    if pat.endswith(".*$") and not pat.endswith("\\.*$"):
        pat = pat[:-1]
    if pat.startswith("^") or (pat.endswith("$") and not pat.endswith("\\$")):
        return None
    segments = pat.split(".*")
    needles: list[bytes] = []
    for seg in segments:
        if seg == "":
            continue
        lit = _literal_bytes(seg)
        if lit is None or not (1 <= len(lit) <= 31):
            return None
        needles.append(lit)
    if not needles or len(needles) > 8:
        return None
    return needles


def _literal_bytes(seg: str) -> bytes | None:
    """seg as a literal byte string, or None if it contains metacharacters."""
    out = bytearray()
    i = 0
    while i < len(seg):
        ch = seg[i]
        if ch == "\\":
            if i + 1 >= len(seg):
                return None
            nxt = seg[i + 1]
            if nxt.isalnum():  # escape classes (\d, \w, ...) are not literal
                return None
            out.append(ord(nxt))
            i += 2
            continue
        if ch in ".[](){}|*+?^$":
            return None
        out.append(ord(ch))
        i += 1
    return bytes(out)


def anchored_literal_prefix(pattern: str) -> bytes | None:
    """Longest MANDATORY literal prefix of an anchored pattern: every
    matching value must start with these bytes.  This is the stats-pruning
    hook — a page whose ColumnIndex [min, max] range cannot contain a value
    in [prefix, next_prefix) cannot match (see ColdPattern.prune_prefix in
    host/native/dpq_scan.hpp).

    None unless the pattern starts with '^' (unanchored search can match
    anywhere regardless of page min/max).  Collection stops BEFORE the first
    non-literal atom, before any quantified char that may repeat or vanish
    ('x*', 'x?', 'x{..}'), and AFTER a '+'-quantified char (mandatory at
    least once, but what follows is variable).  Any top-level alternation
    bails entirely: this engine anchors the whole alternation, so a sound
    common prefix would need per-branch analysis we don't attempt.
    """
    if not pattern.startswith("^"):
        return None
    # top-level '|' scan (outside classes; any paren depth counts as
    # non-top-level only if the '|' sits inside the group)
    depth = 0
    in_class = False
    i = 1
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            i += 2
            continue
        if in_class:
            if ch == "]":
                in_class = False
        elif ch == "[":
            in_class = True
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(depth - 1, 0)
        elif ch == "|" and depth == 0:
            return None
        i += 1

    out = bytearray()
    i = 1
    n = len(pattern)
    while i < n:
        ch = pattern[i]
        if ch in ".[](){}|*+?^$":
            break
        if ch == "\\":
            if i + 1 >= n or pattern[i + 1].isalnum():
                break  # escape classes (\d, \w, ...) are not literal
            lit = pattern[i + 1]
            nxt = i + 2
        else:
            lit = ch
            nxt = i + 1
        # peek the quantifier following this literal
        q = pattern[nxt] if nxt < n else ""
        if q and q in "*?{":
            break  # optional / variable repeat: char not mandatory
        out.append(ord(lit))
        if q == "+":
            break  # mandatory at least once; what follows is variable
        i = nxt
    return bytes(out) if out else None


def exact_literal(pattern: str) -> bytes | None:
    """The literal L when the pattern is `^L$` with NO metacharacters —
    i.e. it matches exactly the value L and nothing else.  This is the
    EQUALITY stats-pruning hook: a page whose ColumnIndex range cannot
    contain L itself (max < L or min > L) cannot match — strictly tighter
    than the prefix range [L, next(L)) that `anchored_literal_prefix`
    yields for the same pattern (which keeps pages holding L-prefixed
    longer values).  Escaped literal chars (`\\.`) are fine; escape
    classes (`\\d`), quantifiers, classes, groups, and alternations all
    disqualify.  None when the shape doesn't apply."""
    if not (pattern.startswith("^") and pattern.endswith("$")
            and not pattern.endswith("\\$")):
        return None
    body = pattern[1:-1]
    out = bytearray()
    i, n = 0, len(body)
    while i < n:
        ch = body[i]
        if ch in ".[](){}|*+?^$":
            return None
        if ch == "\\":
            if i + 1 >= n or body[i + 1].isalnum():
                return None  # \d, \w, ... are classes, not literals
            out.append(ord(body[i + 1]))
            i += 2
        else:
            out.append(ord(ch))
            i += 1
    return bytes(out) if out else None


def _inc_last(b: bytes) -> bytes | None:
    """Smallest upper bound of the set {strings starting with b} under the
    byte-increment rule: pop trailing 0xFF bytes, bump the last byte.  None
    when b is all-0xFF (no finite bound)."""
    q = bytearray(b)
    while q and q[-1] == 0xFF:
        q.pop()
    if not q:
        return None
    q[-1] += 1
    return bytes(q)


def anchored_prune_range(pattern: str) -> tuple[bytes, bytes | None] | None:
    """Unified ColumnIndex prune range for an anchored pattern: every
    matching value v satisfies lo <= v and (hi is None or v < hi), so a
    page is UNMATCHABLE when its stored max < lo or stored min >= hi
    (sound under the format's truncation bounds: stored min is a LOWER
    bound, stored max an UPPER bound of the true extremes).

    Cases, tightest first:
      * `^lit$` exact literal        -> [lit, lit + b"\\x00")  (equality)
      * `^P[c1-c2]...` class-extended -> [P + min_c, inc(P + max_c))
        (the class char is MANDATORY: unquantified or '+'); '.' extends
        with the full byte range (still tightens lo by one byte)
      * `^P...` literal prefix        -> [P, inc(P))
    None when the pattern is unanchored or yields no usable bound."""
    lit = exact_literal(pattern)
    if lit is not None:
        return lit, lit + b"\x00"
    if not pattern.startswith("^"):
        return None
    prefix = anchored_literal_prefix(pattern)
    if prefix is None:
        return None
    # find where the literal collection stopped to peek the next atom
    i, n = 1, len(pattern)
    taken = 0
    while i < n and taken < len(prefix):
        if pattern[i] == "\\":
            i += 2
        else:
            i += 1
        taken += 1
        # '+' after the final collected char ends collection there
        if taken == len(prefix) and i < n and pattern[i] == "+":
            return prefix, _inc_last(prefix)
    cls: frozenset | None = None
    if i < n and pattern[i] == "[":
        try:
            cls, j = parse_class_at(pattern, i + 1)
        except Exception:
            return prefix, _inc_last(prefix)
        q = pattern[j] if j < n else ""
        if q in ("*", "?", "{"):
            cls = None  # the class char may vanish: no extension
    elif i < n and pattern[i] == ".":
        q = pattern[i + 1] if i + 1 < n else ""
        if q not in ("*", "?", "{"):
            cls = ANY
    if cls:
        lo = prefix + bytes([min(cls)])
        hi = _inc_last(prefix + bytes([max(cls)]))
        return lo, hi
    return prefix, _inc_last(prefix)


def like_to_regex(pattern: str) -> str:
    """SQL LIKE -> regex ('%' any run, '_' any byte), anchored both ends."""
    out = ["^"]
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(_re.escape(ch))
    out.append("$")
    return "".join(out)


def minimize_dfa(dfa: DFA) -> DFA:
    """DFA minimization by Moore partition refinement (vectorized: each round
    splits blocks by the signature (own block, blocks of all 256 successors)
    via np.unique over rows).  Fewer states shrink the device matcher's
    per-step select/matmul cost linearly."""
    part = dfa.accept.astype(np.int64)
    n_blocks = 2 if dfa.accept.any() and not dfa.accept.all() else 1
    while True:
        sig = np.concatenate([part[:, None], part[dfa.table]], axis=1)
        _, new_part = np.unique(sig, axis=0, return_inverse=True)
        new_blocks = int(new_part.max()) + 1
        if new_blocks == n_blocks:
            part = new_part
            break
        part, n_blocks = new_part, new_blocks

    # renumber so the start state's block is 0
    remap = np.full(n_blocks, -1, np.int64)
    order = [int(part[0])]
    seen = {int(part[0])}
    for b in part:
        if int(b) not in seen:
            seen.add(int(b))
            order.append(int(b))
    for new_id, old_id in enumerate(order):
        remap[old_id] = new_id
    part = remap[part]

    reps = np.zeros(n_blocks, np.int64)
    reps[part] = np.arange(len(part))  # any representative per block
    table = part[dfa.table[reps]].astype(np.int32)
    accept = dfa.accept[reps]
    return DFA(table, accept, dfa.pattern)


def compile_pattern(pattern: str, max_states: int | None = None) -> DFA:
    """Compile to a minimized search-semantics DFA (raises
    UnsupportedPattern).  The state budget defaults to
    EngineConfig.max_dfa_states (DPQ_MAX_DFA_STATES)."""
    if max_states is None:
        from ..utils.config import get_config

        max_states = get_config().max_dfa_states
    pat = pattern
    anchored_start = pat.startswith("^")
    if anchored_start:
        pat = pat[1:]
    anchored_end = pat.endswith("$") and not pat.endswith("\\$")
    if anchored_end:
        pat = pat[:-1]

    nfa = _NFA()
    parser = _Parser(pat, nfa)
    try:
        frag = parser.parse_alt()
    except InnerAnchors as e:
        # the bitprog front-end resolves inner anchors: branches with
        # required bytes on the anchor's outer side are UNSATISFIABLE
        # (like Python re without MULTILINE) and compile to a
        # never-accepting DFA instead of falling back to the host
        from .bitprog import BitprogUnsupported, compile_bitprog

        try:
            prog = compile_bitprog(pattern)
        except BitprogUnsupported:
            raise e from None
        if not prog.machines and not prog.always:
            return DFA(
                table=np.zeros((1, 256), np.int32),
                accept=np.zeros(1, bool),
                pattern=pattern,
            )
        raise
    if parser.i != len(pat):
        raise UnsupportedPattern(f"trailing junk at {parser.i}")

    start = nfa.state()
    accept = nfa.state()
    nfa.link(start, frag.start)
    nfa.link(frag.end, accept)
    if not anchored_start:
        nfa.link(start, start, ANY)  # implicit leading .*
    if not anchored_end:
        nfa.link(accept, accept, ANY)  # implicit trailing .*

    # epsilon closures
    n = len(nfa.edges)
    eps = [set() for _ in range(n)]
    for s in range(n):
        stack, seen = [s], {s}
        while stack:
            u = stack.pop()
            for sym, v in nfa.edges[u]:
                if sym is None and v not in seen:
                    seen.add(v)
                    stack.append(v)
        eps[s] = seen

    def closure(states: frozenset) -> frozenset:
        out: set[int] = set()
        for s in states:
            out |= eps[s]
        return frozenset(out)

    start_set = closure(frozenset([start]))
    ids = {start_set: 0}
    table_rows: list[np.ndarray] = []
    accepts: list[bool] = []
    work = [start_set]
    while work:
        cur = work.pop(0)
        sid = ids[cur]
        while len(table_rows) <= sid:
            table_rows.append(np.zeros(256, np.int32))
            accepts.append(False)
        accepts[sid] = accept in cur
        # group targets per byte
        targets: list[set[int]] = [set() for _ in range(256)]
        for u in cur:
            for sym, v in nfa.edges[u]:
                if sym is None:
                    continue
                for b in sym:
                    targets[b].add(v)
        row = np.zeros(256, np.int32)
        cache: dict[frozenset, int] = {}
        for b in range(256):
            t = frozenset(targets[b])
            if t in cache:
                row[b] = cache[t]
                continue
            t_closed = closure(t)
            if t_closed not in ids:
                if len(ids) >= max_states:
                    raise UnsupportedPattern("DFA state blow-up")
                ids[t_closed] = len(ids)
                work.append(t_closed)
            row[b] = ids[t_closed]
            cache[t] = row[b]
        table_rows[sid] = row

    return minimize_dfa(DFA(np.stack(table_rows), np.array(accepts, bool), pattern))
