"""Bit-parallel NFA programs, and their transitions as a typed expression IR.

Two parts, in this order:

1. **The register-machine compiler**, the port's own copy of the
   reference's `duckdb_parquet_parser_tpu/ops/bitprog.py`
   (`compile_bitprog`, `make_bitprog_transition`, `BitprogUnsupported`).
   It generalizes Shift-And (bitap) to the extended Shift-And family
   (Glushkov NFA simulation, cf. Navarro & Raffinot, "Flexible Pattern
   Matching"): positions carry byte classes; `?`, `*`, `+`, `{m,n}` become
   optional / repeatable position masks (a self-loop term and a doubling
   epsilon smear); `.*` gaps split the pattern into segments chained
   through sticky done bits; top-level alternation compiles each branch to
   its own machine; edge anchors become first-byte-only seeding and
   non-sticky accepts; wide segments span carry-chained registers; big
   same-class counted runs become streak or anchored counters.  Anything
   outside the family raises `BitprogUnsupported`.  The per-byte transition
   is a closure over an `xp` array namespace that uses only `where`,
   `zeros_like`, `ones_like`, `full_like`, `.astype(int32)` and Python
   operators, with no Python branch on array values.  The reference's
   2-bytes-per-step composed transitions are not copied (nothing in the
   port runs them).

2. **The IR tracer**, which stays in this module behind the compiler:
   running such a closure ONCE with a recording namespace yields the whole
   transition as a small DAG (tens of nodes per byte), and that one IR
   drives both back ends of the port:

  * `eval_torch(ir, state, c)` — the plain PyTorch evaluator (CPU path and
    the reference the kernels are held against);
  * `emit_c(ir, ...)` — straight-line C for the CUDA stream-matcher kernel
    (ops/kernels/stream_matcher.py), whole or its state half alone, the
    byte-only half then read from a table of 256 words a value
    (`byte_frontier`, `byte_table`).

Every IR node is typed `bool` or `i32`, following numpy/jnp promotion (a
bool operand of an integer operator is widened first).  Integer arithmetic
wraps at 32 bits, as it does in numpy and jnp; shift amounts are constants
in [0, 31] and `>>` is arithmetic.  Constants fold and identical nodes are
shared while tracing.
"""

from __future__ import annotations

import functools
import numbers
import operator
from dataclasses import dataclass, field

import torch

from .regex import ANY, UnsupportedPattern, escape_set, parse_class_at

MAX_MACHINES = 16      # top-level alternation fan-out bound
MAX_SEGMENTS = 8       # '.*' gaps per machine (done bits share an int32)
MAX_POSITIONS = 31     # positions per register (int32 bits 0..30)
MAX_WIDE_REGS = 4      # registers a single WIDE segment may span (carry-chained)
MAX_COUNTED = 1 << 16  # {m,n} token-expansion sanity cap per atom.  The REAL
                       # register bound (MAX_POSITIONS * MAX_WIDE_REGS = 124
                       # positions per segment) is enforced AFTER the run
                       # collapses in compile_bitprog — a LEADING same-class
                       # {m,n} of any size becomes a streak counter
                       # (_collapse_lead_runs), and an INTERIOR one becomes
                       # an ANCHORED counter (_collapse_interior_runs), so
                       # 'x{500}', '[a-z]{2000}q', 'a[0-9]{200}b' and
                       # 'q[ab]{500,}z' all compile.  Still raising: bounded
                       # interior runs whose prefix shares the run class
                       # ('a[ab]{200}c' — the counter can't tell anchor age)
                       # past 124 positions


class BitprogUnsupported(UnsupportedPattern):
    pass


# ── AST ─────────────────────────────────────────────────────────────────────


@dataclass
class Lit:
    cls: frozenset


@dataclass
class Cat:
    items: list


@dataclass
class Alt:
    options: list


@dataclass
class Rep:
    item: object
    lo: int
    hi: int | None  # None = unbounded


@dataclass
class Anch:
    kind: str  # '^' or '$'


def _parse(pattern: str):
    """Pattern -> AST (raises BitprogUnsupported on anchors/lookaround)."""
    p, n = pattern, len(pattern)
    i = 0

    def peek():
        return p[i] if i < n else None

    def alt():
        nonlocal i
        opts = [cat()]
        while peek() == "|":
            i += 1
            opts.append(cat())
        return opts[0] if len(opts) == 1 else Alt(opts)

    def cat():
        nonlocal i
        items = []
        while (c := peek()) is not None and c not in "|)":
            items.append(rep())
        return Cat(items)

    def rep():
        nonlocal i
        node = atom()
        if isinstance(node, Anch) and peek() in ("*", "+", "?", "{"):
            raise BitprogUnsupported("quantified anchor")
        while (c := peek()) in ("*", "+", "?", "{"):
            if c == "{":
                import re as _re

                m = _re.match(r"\{(\d+)(,(\d*))?\}", p[i:])
                if not m:
                    raise BitprogUnsupported("bad counted repeat")
                i += m.end()
                lo = int(m.group(1))
                hi = (lo if m.group(2) is None
                      else (None if m.group(3) == "" else int(m.group(3))))
                if hi is not None and hi < lo:
                    raise BitprogUnsupported("bad counted repeat bounds")
                node = Rep(node, lo, hi)
                continue
            i += 1
            node = Rep(node, 0 if c in "*?" else 1, None if c in "*+" else 1)
        return node

    def atom():
        nonlocal i
        c = peek()
        if c is None:
            raise BitprogUnsupported("empty atom")
        i += 1
        if c == "(":
            if peek() == "?":
                i += 1
                if peek() != ":":
                    raise BitprogUnsupported("lookaround / named groups")
                i += 1
            node = alt()
            if peek() != ")":
                raise BitprogUnsupported("unbalanced group")
            i += 1
            return node
        if c == "[":
            cls, ni = parse_class_at(p, i)
            i = ni
            return Lit(cls)
        if c == ".":
            return Lit(ANY)
        if c == "\\":
            e = peek()
            if e is None:
                raise BitprogUnsupported("trailing backslash")
            i += 1
            return Lit(escape_set(e))
        if c in "*+?{":
            raise BitprogUnsupported(f"dangling quantifier '{c}'")
        if c in "^$":
            return Anch(c)  # inner anchors resolve in _segment
        return Lit(frozenset([ord(c)]))

    tree = alt()
    if i != n:
        raise BitprogUnsupported(f"trailing junk at {i}")
    return tree


# ── lowering: AST -> machines of segments of positions ──────────────────────

Q_ONE, Q_OPT, Q_PLUS, Q_STAR = 0, 1, 2, 3
GAP = "gap"      # segment separator marker ('.*')
ANCH_S = "anch_s"  # inner '^' token (resolved per branch in _segment)
ANCH_E = "anch_e"  # inner '$' token


@dataclass
class Segment:
    cls: list = field(default_factory=list)    # frozenset per position
    quant: list = field(default_factory=list)  # Q_* per position


@dataclass
class Machine:
    segments: list = field(default_factory=list)
    lead_gap: bool = False   # '.*' (or an absorbed optional run) before content
    trail_gap: bool = False  # '.*' after the last content
    anch_s: bool = False     # first segment seeds only at the value's 1st byte
    anch_e: bool = False     # accept sampled non-sticky (match must END at the
                             # value's last byte)
    always: bool = False     # matches every value incl. empty ('.*', 'a?', …)
    lead_run: tuple | None = None  # (cls, mand, sticky): leading same-class
                             # position run collapsed to a saturating counter
                             # (_collapse_lead_runs); segments hold the residual
    mid_run: tuple | None = None   # (cls, mand, cap, bounded): INTERIOR
                             # same-class run collapsed to an anchored counter
                             # (_collapse_interior_runs); segments then hold
                             # [prefix] or [prefix, suffix]


def _as_class(node) -> frozenset | None:
    """Single-byte-consuming view of a node, or None."""
    if isinstance(node, Lit):
        return node.cls
    if isinstance(node, Alt):
        parts = [_as_class(o) for o in node.options]
        if all(x is not None for x in parts):
            out: frozenset = frozenset()
            for x in parts:
                out |= x
            return out
    if isinstance(node, Cat) and len(node.items) == 1:
        return _as_class(node.items[0])
    return None


def _flatten(node) -> list[list]:
    """Node -> alternatives, each a flat token list (frozenset positions with
    quantifiers as (cls, Q_*) tuples, or GAP markers)."""

    def cross(seqs_a: list[list], seqs_b: list[list]) -> list[list]:
        out = [a + b for a in seqs_a for b in seqs_b]
        if len(out) > MAX_MACHINES:
            raise BitprogUnsupported("alternation fan-out too large")
        return out

    if isinstance(node, Lit):
        return [[(node.cls, Q_ONE)]]

    if isinstance(node, Anch):
        return [[ANCH_S if node.kind == "^" else ANCH_E]]

    if isinstance(node, Cat):
        seqs: list[list] = [[]]
        for item in node.items:
            seqs = cross(seqs, _flatten(item))
        return seqs

    if isinstance(node, Alt):
        out = []
        for o in node.options:
            out.extend(_flatten(o))
        if len(out) > MAX_MACHINES:
            raise BitprogUnsupported("alternation fan-out too large")
        return out

    if isinstance(node, Rep):
        cls = _as_class(node.item)
        if cls is not None:
            if node.lo == 0 and node.hi is None and cls == ANY:
                return [[GAP]]  # '.*' — the unanchored gap
            if max(node.lo, node.hi or 0) > MAX_COUNTED:
                raise BitprogUnsupported("counted repeat too large")
            if node.hi is None:
                if node.lo == 0:
                    return [[(cls, Q_STAR)]]
                return [[(cls, Q_ONE)] * (node.lo - 1) + [(cls, Q_PLUS)]]
            return [[(cls, Q_ONE)] * node.lo + [(cls, Q_OPT)] * (node.hi - node.lo)]
        # bounded repeat of a multi-byte group: expand by concatenation
        if node.hi is not None and node.hi <= 4:
            inner = _flatten(node.item)
            out = []
            for count in range(node.lo, node.hi + 1):
                seqs: list[list] = [[]]
                for _ in range(count):
                    seqs = cross(seqs, inner)
                out.extend(seqs)
            if len(out) > MAX_MACHINES:
                raise BitprogUnsupported("alternation fan-out too large")
            return out
        raise BitprogUnsupported("unbounded repeat of a multi-byte group")

    raise BitprogUnsupported(f"node {type(node).__name__}")


def _segment(tokens: list) -> Machine | None:
    """Token list -> Machine.  Returns None for a branch that can never
    match (an inner anchor with required content on its outer side — e.g.
    'a^b' / 'a$b' never match, exactly like Python re without MULTILINE).
    Inner anchors that are edge-EQUIVALENT (only assertion-transparent
    positions outside them, e.g. '(^a)b') set the machine's anchor flags;
    anchors adjacent to optionals or gaps raise (genuinely positional)."""
    m = Machine()
    seg = Segment()
    raw: list[Segment] = []
    saw_content = False
    saw_required = False
    anch_e_seen = False
    for tok in tokens:
        if tok is ANCH_S:
            if anch_e_seen:
                return None  # '$^…' with content around: unmatchable
            if not saw_content and not m.lead_gap:
                m.anch_s = True
                continue
            if saw_required:
                return None  # required bytes before '^': never matches
            raise BitprogUnsupported("anchor adjacent to optionals/gaps")
        if tok is ANCH_E:
            anch_e_seen = True
            continue
        if anch_e_seen:
            if tok is GAP:
                raise BitprogUnsupported("anchor adjacent to optionals/gaps")
            _cls, _q = tok
            if _q in (Q_ONE, Q_PLUS):
                return None  # required bytes after '$': never matches
            raise BitprogUnsupported("anchor adjacent to optionals/gaps")
        if tok is GAP:
            if seg.cls:
                raw.append(seg)
                seg = Segment()
            if not saw_content:
                m.lead_gap = True
            m.trail_gap = True
            continue  # empty segment between gaps collapses
        cls, q = tok
        if not cls:
            raise BitprogUnsupported("empty byte class")
        seg.cls.append(cls)
        seg.quant.append(q)
        saw_content = True
        saw_required = saw_required or q in (Q_ONE, Q_PLUS)
        m.trail_gap = False
    if anch_e_seen:
        if m.trail_gap or (seg.cls and not any(
                q in (Q_ONE, Q_PLUS) for q in seg.quant)):
            raise BitprogUnsupported("anchor adjacent to optionals/gaps")
        m.anch_e = True
    if seg.cls:
        raw.append(seg)
    # drop fully-optional segments: they are absorbed by the gap around them
    # (a dropped EDGE segment also absorbs any edge anchor — the optional run
    # plus its gap can match anything, so the machine is gap-edged there)
    m.segments = [
        s for s in raw
        if any(q in (Q_ONE, Q_PLUS) for q in s.quant)
    ]
    if not m.segments:
        # no required position anywhere: the branch matches EVERY value
        # (search semantics — an empty match exists at some offset), unless
        # anchors pin BOTH edges without a gap to absorb them (then the
        # match set is value-dependent: fall back)
        if m.anch_s and m.anch_e and not (m.lead_gap or m.trail_gap):
            raise BitprogUnsupported(
                "empty-matching branch pinned by both anchors")
        m.always = True
        return m
    if raw[0] is not m.segments[0]:
        m.lead_gap = True
    if raw[-1] is not m.segments[-1]:
        m.trail_gap = True
    if len(m.segments) > MAX_SEGMENTS:
        raise BitprogUnsupported("too many '.*' gaps")
    # NOTE: segment-length limits are enforced in compile_bitprog AFTER
    # _collapse_lead_runs (a leading same-class run of any length collapses
    # to a counter register and escapes the position budget entirely)
    return m


LEAD_RUN_MIN = 9  # below this, the positions ride an existing shift ladder
                  # for free; at/above, a counter register wins


def _collapse_lead_runs(machines: list[Machine]) -> None:
    """Collapse each unanchored machine's leading run of SAME-CLASS positions
    into a saturating-counter register (Machine.lead_run).

    Valid because an unanchored machine seeds a fresh match attempt at EVERY
    byte: the run lengths that can precede the residual at byte t form the
    full range {mand .. current same-class streak}, so "the residual may
    start at byte t" reduces to "the streak of class bytes ending at t-1 is
    >= mand" (mand = the run's required-position count).  The run's upper
    bound and its optional/repeatable structure are both irrelevant — a
    streak of k >= mand class bytes always contains a suffix the run
    accepts.  The transition then pays ~4 ops/byte for the whole run
    (saturating count + compare) instead of a 31-bit shift ladder per
    register chunk — `[a-z ]{30,45}requests` drops from 2 carry-chained
    registers (53 positions) to a counter plus an 8-position register.

    sticky: the run was segment 0 ENTIRELY, so run-done feeds segments[1:]
    like a '.*' done bit (once seen, seeds forever).  Non-sticky: the run
    was a strict prefix of segment 0 — the residual's first position must
    match the byte immediately after the streak, so it is seeded per byte
    from the live counter."""
    for m in machines:
        if m.anch_s or m.always or not m.segments:
            continue
        seg = m.segments[0]
        cls0 = seg.cls[0]
        j = 1
        while j < len(seg.cls) and seg.cls[j] == cls0:
            j += 1
        if j < LEAD_RUN_MIN:
            continue
        mand = sum(1 for q in seg.quant[:j] if q in (Q_ONE, Q_PLUS))
        if mand < 1:
            continue  # all-optional run: machine-level semantics unchanged
        rest_cls, rest_q = seg.cls[j:], seg.quant[j:]
        sticky = not rest_cls
        if not sticky and not any(q in (Q_ONE, Q_PLUS) for q in rest_q):
            # residual prefix with no required position: acceptance would
            # need counter-OR-register accepts — rare shape, keep registers
            continue
        residual = ([] if sticky else [Segment(cls=rest_cls, quant=rest_q)])
        residual += m.segments[1:]
        if sum(len(s.cls) for s in residual) > MAX_POSITIONS:
            continue  # v1: residual must fit one fused register
        m.lead_run = (cls0, mand, sticky)
        m.segments = residual


def _collapse_interior_runs(machines: list[Machine]) -> None:
    """Collapse a long INTERIOR same-class position run into an ANCHORED
    saturating counter (Machine.mid_run) — `a[0-9]{200}b` compiles without
    the MXU DFA fallback.

    Model: the machine's single segment splits into PREFIX | RUN | SUFFIX.
    The prefix is an ordinary (sub-31-position) register whose accept bit
    p_t = "prefix ends at byte t" anchors the counter; the counter tracks
    the run-class streak since its anchor; the suffix register is seeded
    from the counter window, exactly like the lead-run residual.

    Soundness:
      * unbounded runs ({m,}): the counter keeps the EARLIEST anchor alive
        through the streak (later p-events inside the streak are redundant
        — a longer streak-suffix always contains an acceptable one), so
        seed = (streak since earliest anchor) >= mand is exact.
      * bounded runs ({m,u}): exactness needs the anchor age, which a
        single counter only knows when anchors can occur ONLY at streak
        starts — guaranteed when every class that can END the prefix (its
        last required position + trailing optionals = the acc_mask
        positions) is DISJOINT from the run class: a p-event byte is then
        never a run-class byte, so each streak has at most one anchor and
        the streak length IS the age.  Non-disjoint bounded runs keep
        their registers (and fall back to the DFA past 124 positions).

    Within one same-class run the ORDER of required/optional positions is
    irrelevant (the acceptable consume-counts are [mand, n_positions] — or
    [mand, inf) with a STAR/PLUS) so mixed shapes like `[0-9]{3}[0-9]*`
    collapse too."""
    for m in machines:
        if m.lead_run is not None or m.always or m.anch_s:
            continue
        if len(m.segments) != 1:
            continue
        seg = m.segments[0]
        n = len(seg.cls)
        best = None  # (length, i, j) of the longest same-class run
        i = 0
        while i < n:
            j = i + 1
            while j < n and seg.cls[j] == seg.cls[i]:
                j += 1
            if best is None or j - i > best[0]:
                best = (j - i, i, j)
            i = j
        if best is None or best[0] <= MAX_POSITIONS:
            continue  # short runs: plain registers are cheaper
        _, i, j = best
        if i == 0:
            continue  # leading run: _collapse_lead_runs territory
        run_cls = seg.cls[i]
        runq = seg.quant[i:j]
        mand = sum(1 for q in runq if q in (Q_ONE, Q_PLUS))
        if mand < 1:
            continue  # all-optional run: acceptance may skip it entirely
        unbounded = any(q in (Q_STAR, Q_PLUS) for q in runq)
        cap = 0 if unbounded else (j - i)
        pre_cls, pre_q = seg.cls[:i], seg.quant[:i]
        suf_cls, suf_q = seg.cls[j:], seg.quant[j:]
        if len(pre_cls) > MAX_POSITIONS or len(suf_cls) > MAX_POSITIONS:
            continue  # v1: prefix/suffix must each fit one register
        if not any(q in (Q_ONE, Q_PLUS) for q in pre_q):
            continue  # prefix must consume >= 1 byte (p is a register bit)
        if suf_cls and not any(q in (Q_ONE, Q_PLUS) for q in suf_q):
            continue  # would need counter-OR-register accepts — rare shape
        if not unbounded:
            k = len(pre_cls) - 1
            ok = True
            while k >= 0:
                if pre_cls[k] & run_cls:
                    ok = False
                    break
                if pre_q[k] in (Q_ONE, Q_PLUS):
                    break
                k -= 1
            if not ok:
                continue  # bounded + shared classes: age would be ambiguous
        m.mid_run = (run_cls, mand, cap, not unbounded)
        m.segments = [Segment(cls=pre_cls, quant=pre_q)]
        if suf_cls:
            m.segments.append(Segment(cls=suf_cls, quant=suf_q))


@dataclass
class BitProgram:
    machines: list            # list[Machine]
    pattern: str
    fingerprint: tuple = ()   # hashable identity for jit caches
    always: bool = False      # matches every value incl. empty; machines
                              # empty + not always = matches NOTHING (all
                              # branches carried unsatisfiable inner anchors)

    @property
    def n_registers(self) -> int:
        """Unpacked upper bound (one register per 31-position segment chunk
        + a done word per machine + the first-byte marker);
        make_bitprog_transition packs gap-free machines into shared
        registers and reports the true count."""
        return sum(
            sum(-(-len(s.cls) // MAX_POSITIONS) for s in m.segments) + 1
            + (2 if m.lead_run else 0)
            + (1 if m.mid_run else 0)  # the anchored counter word
            for m in self.machines
        ) + 1


def compile_bitprog(pattern: str) -> BitProgram:
    """Pattern -> BitProgram (raises BitprogUnsupported outside the extended
    Shift-And family).  Search semantics exactly like the DFA compiler:
    unanchored unless ^/$ sit at the pattern edges, and an edge anchor
    applies to the WHOLE pattern — '^a|b' means '^(a|b)', matching
    compile_pattern (regex.py:457-462), not Python re."""
    pat = pattern
    # NOTE: no '^.*' / '.*$' wrapper stripping here — under a top-level
    # alternation the edge anchor applies to EVERY branch ('a|b.*$' means
    # '(a|b.*)$'), so the wrapper only defeats the anchor for the branch
    # that carries the gap; _segment records that per machine (lead_gap /
    # trail_gap) and the anchor flags below honor it.
    anchor_start = pat.startswith("^")
    if anchor_start:
        pat = pat[1:]
    anchor_end = pat.endswith("$") and not pat.endswith("\\$")
    if anchor_end:
        pat = pat[:-1]
    machines = [m for m in (_segment(toks) for toks in _flatten(_parse(pat)))
                if m is not None]  # None = a never-matching branch (dropped)
    always = False
    kept = []
    for m in machines:
        m.anch_s = m.anch_s or (anchor_start and not m.lead_gap)
        m.anch_e = m.anch_e or (anchor_end and not m.trail_gap)
        if m.always:
            if m.anch_s and m.anch_e:
                raise BitprogUnsupported(
                    "empty-matching branch pinned by both anchors")
            always = True  # one always-branch accepts every value
            continue
        kept.append(m)
    machines = [] if always else kept
    _collapse_lead_runs(machines)
    _collapse_interior_runs(machines)
    for m in machines:
        for s in m.segments:
            if len(s.cls) > MAX_POSITIONS * MAX_WIDE_REGS:
                raise BitprogUnsupported("segment too long")
    fp = (always, tuple(
        (
            m.anch_s,
            m.anch_e,
            (None if m.lead_run is None
             else (tuple(sorted(m.lead_run[0])), m.lead_run[1], m.lead_run[2])),
            (None if m.mid_run is None
             else (tuple(sorted(m.mid_run[0])), m.mid_run[1], m.mid_run[2],
                   m.mid_run[3])),
            tuple(
                tuple(
                    (tuple(sorted(c)), q)
                    for c, q in zip(s.cls, s.quant)
                )
                for s in m.segments
            ),
        )
        for m in machines
    ))
    return BitProgram(machines=machines, pattern=pattern, fingerprint=fp,
                      always=always)


# ── transition closure ──────────────────────────────────────────────────────


def _intervals(cls: frozenset) -> list[tuple[int, int]]:
    """Byte set -> sorted disjoint [lo, hi] intervals."""
    out = []
    bs = sorted(cls)
    lo = prev = bs[0]
    for b in bs[1:]:
        if b == prev + 1:
            prev = b
            continue
        out.append((lo, prev))
        lo = prev = b
    out.append((lo, prev))
    return out


# Distinct singleton classes per register before the bit-sliced membership
# plan beats per-class compare+select (bit-slicing costs <= 8 selects + 7
# ands + a 2-op constant-plane gate regardless of the letter count; the
# compare path costs ~3 ops per distinct letter).
BITSLICE_MIN = 4


def _bitslice_plan(singletons: dict[int, int]):
    """Bit-sliced membership constants for singleton classes {byte: bits}.

    Position bit j (class = the single byte b_j) must survive iff every bit
    plane of the input byte matches b_j's: m = AND_k where(bit_k(c), S_k,
    C_k), where S_k/C_k hold the position bits whose byte has plane k
    set/clear.  Planes where ALL participating bytes agree fold into one
    `(c & const_mask) == const_val` gate (for ASCII text that removes 3-4
    planes), so the per-byte cost is a handful of ops independent of how
    many distinct letters the register watches — the fix for the
    letter-union cost of alternations (measured in the reference).
    """
    all_bits = 0
    set_planes = [0] * 8
    clear_planes = [0] * 8
    for byte, bits in singletons.items():
        all_bits |= bits
        for k in range(8):
            (set_planes if (byte >> k) & 1 else clear_planes)[k] |= bits
    const_mask = const_val = 0
    var_planes = []
    for k in range(8):
        if set_planes[k] == all_bits:
            const_mask |= 1 << k
            const_val |= 1 << k
        elif clear_planes[k] == all_bits:
            const_mask |= 1 << k
        else:
            var_planes.append((k, set_planes[k], clear_planes[k]))
    return all_bits, const_mask, const_val, tuple(var_planes)


def _smear_plan(o_mask: int) -> tuple:
    """Doubling schedule for the epsilon-smear fixed point.

    `F |= (F & O) << 1` iterated r times (r = longest optional run) is
    serial critical-path depth; the same fixed point follows from
    log2(r) doubling steps `F |= (F & T_k) << 2^k`, where T_k marks
    positions whose next 2^k positions are ALL optional (so the jump's
    intermediate landings all lie inside the run): T_0 = O,
    T_{k+1} = T_k & (T_k >> 2^k).  Returns ((shift, mask), ...).

    Masks are computed PER MACHINE (before register packing merges them):
    packed machines sit at adjacent bit offsets, and a merged-mask T_k
    could otherwise splice one machine's trailing optionals onto the next
    machine's leading ones, letting a jump cross the machine boundary."""
    plan = []
    t, d = o_mask, 1
    while t:
        plan.append((d, t))
        t = t & (t >> d)
        d *= 2
    return tuple(plan)


def _arith_fill_ok(sc) -> bool:
    """True when the epsilon smear may run as ONE arithmetic carry fill.

    Within a contiguous optional run M, the upward closure of entering bits
    t = f & M is exactly the carry-in set of the integer add M + t (the carry
    enters every position above the lowest t bit and exits one past the run
    top, then dies where M = 0):  fill = ((M + t) ^ M) ^ t.  That is 5 ops
    independent of the run length, vs 3 ops per doubling level.

    The add propagates carries through ANY contiguous run of the merged
    o_mask — including runs spliced together across a machine/segment packing
    boundary, where the doubling plan (masks computed per component) correctly
    stops.  Safe iff every adjacent optional pair lies inside one component."""
    adj = sc.o_mask & (sc.o_mask >> 1)
    internal = 0
    for cm in sc.o_runs:
        internal |= cm & (cm >> 1)
    return adj == internal


@dataclass
class _SegConsts:
    """Per-register compile-time constants of one (possibly packed) segment."""

    weights: dict          # byte-class frozenset -> position bits
    any_bits: int          # positions with class == ANY
    r_mask: int            # repeatable positions
    o_mask: int            # optional positions
    smear_plan: tuple      # ((shift, mask), ...) doubling epsilon smears
    acc_mask: int          # STICKY completion bits (last position + trailing
                           # opts of end-unanchored machines)
    start_mask: int        # always-seeded start bits (unanchored machines)
    seg_idx: int           # segment index within its machine (gap chains)
    width: int = 0         # bits used (packing watermark)
    anch_start_mask: int = 0  # start bits seeded only at the value's 1st byte
    acc_now_mask: int = 0     # NON-STICKY accept bits ('$'-anchored machines)
    o_runs: tuple = ()     # per-component o_masks BEFORE merging: the
                           # arithmetic carry fill (see _arith_fill_ok) is only
                           # safe when no optional run crosses a component
                           # (machine/segment) packing boundary


def _seg_consts(seg: Segment, base: int) -> _SegConsts:
    """Constants for `seg` with its positions placed at bit offset `base`."""
    weights: dict[frozenset, int] = {}
    any_bits = 0
    for p_idx, cls in enumerate(seg.cls):
        if cls == ANY:
            any_bits |= 1 << (base + p_idx)
            continue
        weights[cls] = weights.get(cls, 0) | (1 << (base + p_idx))
    r_mask = sum(
        1 << (base + i) for i, q in enumerate(seg.quant) if q in (Q_PLUS, Q_STAR)
    )
    o_mask = sum(
        1 << (base + i) for i, q in enumerate(seg.quant) if q in (Q_OPT, Q_STAR)
    )
    # accept mask: the last position plus the trailing optional run above it
    # (a prefix reaching any of those bits completes the segment via skips)
    acc_mask = 0
    for i in range(len(seg.cls) - 1, -1, -1):
        acc_mask |= 1 << (base + i)
        if seg.quant[i] not in (Q_OPT, Q_STAR):
            break
    return _SegConsts(weights, any_bits, r_mask, o_mask, _smear_plan(o_mask),
                      acc_mask, 1 << base, 0, base + len(seg.cls),
                      o_runs=((o_mask,) if o_mask else ()))


def _merge(a: _SegConsts, b: _SegConsts) -> _SegConsts:
    w = dict(a.weights)
    for cid, bits in b.weights.items():
        w[cid] = w.get(cid, 0) | bits
    # smear plans merge per shift distance: each mask was computed from one
    # machine's own optionals, so the union cannot splice runs across the
    # packing boundary (see _smear_plan)
    plan: dict[int, int] = dict(a.smear_plan)
    for d, m in b.smear_plan:
        plan[d] = plan.get(d, 0) | m
    return _SegConsts(w, a.any_bits | b.any_bits, a.r_mask | b.r_mask,
                      a.o_mask | b.o_mask,
                      tuple(sorted(plan.items())),
                      a.acc_mask | b.acc_mask, a.start_mask | b.start_mask, 0,
                      max(a.width, b.width),
                      a.anch_start_mask | b.anch_start_mask,
                      a.acc_now_mask | b.acc_now_mask,
                      a.o_runs + b.o_runs)


def _chunk_consts(seg: Segment) -> list[_SegConsts]:
    """Split a segment into <=MAX_POSITIONS-bit register chunks.

    Chunk k+1's entering set is fed by two carries out of chunk k (computed
    in the transition): the SHIFT carry — the old top position bit moves to
    the next chunk's bit 0 — and, when the top position is optional, the
    SMEAR carry — the post-smear entering bit skips across the boundary.
    Local smears then continue the skip within the next chunk (an optional
    run crossing the boundary re-starts its run count at bit 0, so the local
    smear count covers it).  The accept mask (last position + its trailing
    optional run) is computed over GLOBAL positions and sliced per chunk, so
    a run crossing the boundary accepts from either side."""
    n = len(seg.cls)
    acc_pos = set()
    for i in range(n - 1, -1, -1):
        acc_pos.add(i)
        if seg.quant[i] not in (Q_OPT, Q_STAR):
            break
    chunks = []
    for base in range(0, n, MAX_POSITIONS):
        sub = Segment(cls=seg.cls[base:base + MAX_POSITIONS],
                      quant=seg.quant[base:base + MAX_POSITIONS])
        sc = _seg_consts(sub, 0)
        sc.acc_mask = sum(1 << (i - base) for i in acc_pos
                          if base <= i < base + MAX_POSITIONS)
        if base:
            sc.start_mask = 0  # only chunk 0 carries the segment start bit
        chunks.append(sc)
    return chunks


@dataclass
class _MaskPlan:
    """Per-register byte-class membership plan (chosen at build time)."""

    cmp_weights: dict      # class id -> position bits (compare path)
    any_bits: int
    bslice: tuple | None   # _bitslice_plan output for singleton classes


def _mask_plan(sc: _SegConsts, class_ids, specs) -> _MaskPlan:
    """Choose the membership representation for one register's classes:
    bit-sliced planes when enough distinct single-byte classes share the
    register (cost then independent of the letter count), interval compares
    (shared program-wide per distinct class) for the rest."""
    singles: dict[int, int] = {}
    multis: dict[frozenset, int] = {}
    for cls, bits in sc.weights.items():
        if len(cls) == 1:
            (b,) = cls
            singles[b] = singles.get(b, 0) | bits
        else:
            multis[cls] = multis.get(cls, 0) | bits
    bslice = None
    if len(singles) >= BITSLICE_MIN:
        bslice = _bitslice_plan(singles)
    else:
        for b, bits in singles.items():
            key = frozenset([b])
            multis[key] = multis.get(key, 0) | bits
    cmp_weights: dict[int, int] = {}
    for cls, bits in multis.items():
        if cls not in class_ids:
            class_ids[cls] = len(specs)
            specs.append(_intervals(cls))
        cid = class_ids[cls]
        cmp_weights[cid] = cmp_weights.get(cid, 0) | bits
    return _MaskPlan(cmp_weights, sc.any_bits, bslice)


@dataclass
class _CountedMachine:
    """Lead-run counter machine (Machine.lead_run, _collapse_lead_runs)."""

    run_cid: int | None    # specs index of the run class; None = ANY
    mand: int              # counter threshold (saturation point)
    sticky: bool           # run-done feeds residual like a '.*' done bit
    res: tuple | None      # (consts, seg_offs, seg_accs) residual, or None
    anch_e: bool


@dataclass
class _MidRunMachine:
    """Interior-run counter machine (Machine.mid_run,
    _collapse_interior_runs): prefix register -> anchored counter ->
    optional suffix register."""

    pre: object            # _SegConsts of the prefix (start-seeded normally)
    run_cid: int | None    # specs index of the run class; None = ANY
    mand: int              # minimum run length
    cap: int               # maximum run length (bounded mode; 0 otherwise)
    bounded: bool
    suf: object | None     # _SegConsts of the suffix (counter-seeded) | None
    anch_e: bool


@dataclass
class _Compiled:
    """Register-compile stage shared by the per-byte and pair emitters."""

    packed: list
    fused: list
    chained: list
    packed_plans: list
    fused_plans: list
    chained_plans: list
    specs: list
    bit_planes: list
    needs_marker: bool
    n_regs: int
    counted: list = field(default_factory=list)        # _CountedMachine
    counted_plans: list = field(default_factory=list)  # _MaskPlan | None
    midrun: list = field(default_factory=list)         # _MidRunMachine
    midrun_plans: list = field(default_factory=list)   # (pre, suf|None)


def _compile_registers(prog: BitProgram) -> _Compiled:
    class_ids: dict[frozenset, int] = {}
    specs: list[list[tuple[int, int]]] = []

    packed: list[_SegConsts] = []   # shared registers of gap-free machines
    fused = []    # (consts, seg_offs, seg_accs, anch_e) per gapped machine
    chained = []  # per oversized machine: ([[chunk consts] per seg], anch_e)
    needs_marker = any(m.anch_s for m in prog.machines)
    counted: list[_CountedMachine] = []
    midrun: list[_MidRunMachine] = []

    for m in prog.machines:
        if m.mid_run is not None:
            run_cls, mand, cap, bounded = m.mid_run
            if run_cls == ANY:
                rcid = None
            else:
                if run_cls not in class_ids:
                    class_ids[run_cls] = len(specs)
                    specs.append(_intervals(run_cls))
                rcid = class_ids[run_cls]
            pre_sc = _seg_consts(m.segments[0], 0)
            suf_sc = None
            if len(m.segments) > 1:
                suf_sc = _seg_consts(m.segments[1], 0)
                suf_sc.start_mask = 0  # seeded by the counter, never freely
            midrun.append(
                _MidRunMachine(pre_sc, rcid, mand, cap, bounded, suf_sc,
                               m.anch_e))
            continue
        if m.lead_run is not None:
            run_cls, mand, sticky = m.lead_run
            if run_cls == ANY:
                rcid = None
            else:
                if run_cls not in class_ids:
                    class_ids[run_cls] = len(specs)
                    specs.append(_intervals(run_cls))
                rcid = class_ids[run_cls]
            res = None
            if m.segments:
                base = 0
                consts = None
                seg_offs, seg_accs = [], []
                for seg in m.segments:
                    sc = _seg_consts(seg, base)
                    seg_offs.append(base)
                    seg_accs.append(sc.acc_mask)
                    consts = sc if consts is None else _merge(consts, sc)
                    base += len(seg.cls)
                consts.start_mask = 0  # seeded by the counter, never freely
                res = (consts, tuple(seg_offs), tuple(seg_accs))
            counted.append(_CountedMachine(rcid, mand, sticky, res, m.anch_e))
            continue
        if len(m.segments) == 1 and len(m.segments[0].cls) <= MAX_POSITIONS:
            seg = m.segments[0]

            def _flagged(base):
                sc = _seg_consts(seg, base)
                if m.anch_s:
                    sc.anch_start_mask, sc.start_mask = sc.start_mask, 0
                if m.anch_e:
                    sc.acc_now_mask, sc.acc_mask = sc.acc_mask, 0
                return sc

            placed = False
            for slot, existing in enumerate(packed):
                if existing.width + len(seg.cls) <= MAX_POSITIONS:
                    packed[slot] = _merge(existing, _flagged(existing.width))
                    placed = True
                    break
            if not placed:
                packed.append(_flagged(0))
            continue
        total = sum(len(s.cls) for s in m.segments)
        if total <= MAX_POSITIONS:
            base = 0
            consts = None
            seg_offs, seg_accs = [], []
            for seg in m.segments:
                sc = _seg_consts(seg, base)
                seg_offs.append(base)
                seg_accs.append(sc.acc_mask)
                consts = sc if consts is None else _merge(consts, sc)
                base += len(seg.cls)
            if m.anch_s:
                consts.anch_start_mask, consts.start_mask = 1, 0
            else:
                consts.start_mask = 1
            fused.append((consts, tuple(seg_offs), tuple(seg_accs), m.anch_e))
            continue
        segs = []
        for s_idx, seg in enumerate(m.segments):
            chunks = _chunk_consts(seg)
            for sc in chunks:
                sc.seg_idx = s_idx
            if s_idx == 0 and m.anch_s:
                c0 = chunks[0]
                c0.anch_start_mask, c0.start_mask = c0.start_mask, 0
            segs.append(chunks)
        chained.append((segs, m.anch_e))

    packed_plans = [_mask_plan(sc, class_ids, specs) for sc in packed]
    fused_plans = [_mask_plan(sc, class_ids, specs) for sc, _, _, _ in fused]
    chained_plans = [
        [[_mask_plan(sc, class_ids, specs) for sc in chunks] for chunks in segs]
        for segs, _ in chained
    ]
    counted_plans = [
        _mask_plan(e.res[0], class_ids, specs) if e.res is not None else None
        for e in counted
    ]
    midrun_plans = [
        (_mask_plan(e.pre, class_ids, specs),
         _mask_plan(e.suf, class_ids, specs) if e.suf is not None else None)
        for e in midrun
    ]
    bit_planes = sorted({
        k
        for plan in (packed_plans + fused_plans
                     + [p for seg in chained_plans for ch in seg for p in ch]
                     + [p for p in counted_plans if p is not None]
                     + [p for pair in midrun_plans for p in pair
                        if p is not None])
        if plan.bslice is not None
        for k, _, _ in plan.bslice[3]
    })

    # packed groups carry a sticky accept word when any of their machines
    # accepts sticky (acceptance is sampled at the value's LAST byte, so
    # transient acc-bit hits must accumulate); '$'-anchored accepts are
    # non-sticky by definition and need no extra word.  Fused machines carry
    # (reg, done); the marker register drives '^' first-byte seeding.
    n_regs = (sum(2 if sc.acc_mask else 1 for sc in packed)
              + 2 * len(fused)
              + sum(sum(len(ch) for ch in s) + 1 for s, _ in chained)
              + sum(3 if e.res is not None else (1 if e.anch_e else 2)
                    for e in counted)
              + sum(2 + (1 if e.suf is not None else 0)
                    + (0 if e.anch_e else 1)
                    for e in midrun)
              + (1 if needs_marker else 0))
    return _Compiled(packed, fused, chained, packed_plans, fused_plans,
                     chained_plans, specs, bit_planes, needs_marker, n_regs,
                     counted, counted_plans, midrun, midrun_plans)


def make_bitprog_transition(xp, prog: BitProgram):
    """Returns (transition(state_tuple, c) -> (next_tuple, accept [N] i32),
    n_state_regs, accept_empty) — the ops/strings.py matcher interface.

    Per byte, class membership is tested once per register via the cheapest
    plan (_mask_plan): registers watching >= BITSLICE_MIN distinct letters
    use bit-sliced planes — `AND_k where(bit_k(c), S_k, C_k)` with
    always-agreeing planes folded into one constant compare — so the cost is
    ~a dozen ops regardless of the letter union; sparse registers and true
    byte classes use interval compares shared program-wide.  Then per
    register a shift/or/and ladder, an optional-run smear only where
    optionals exist, and sticky done-bit updates.  All [N] int32 vector ops;
    no gathers, no matmuls.

    Register packing: gap-free machines (single segment — e.g. the branches
    of `cat|dog|mouse`) SHARE registers, stacked at disjoint bit offsets.
    Their start positions are seeded every byte via `start_mask`, which also
    makes cross-boundary shift carries harmless (a carry can only land on an
    always-seeded start bit), so an A-way alternation of short words costs
    the same per byte as a single word.

    Machines with '.*' gaps whose total position count fits one register are
    FUSED: all segments share one register at disjoint offsets plus one done
    word, paying a single shift ladder per byte.  Segment s's start bit is
    seeded from done bit s-1 (sticky), which subsumes every cross-segment
    shift carry / optional smear: a bit can only cross the s-1 | s boundary
    out of positions inside segment s-1's acc_mask (the trailing-optional
    run plus its anchor), and any such bit set done bit s-1 on the previous
    byte — so the seed already covers the crossing.  Oversized machines keep
    the one-register-per-segment layout, and segments beyond MAX_POSITIONS
    split into carry-chained register chunks (_chunk_consts)."""
    if prog.always:
        # matches every value incl. empty: constant accept, no registers
        return (lambda state, c: ((), xp.ones_like(c))), 0, 1
    if not prog.machines:
        # every branch was an unsatisfiable inner-anchor pattern
        return (lambda state, c: ((), xp.zeros_like(c))), 0, 0
    cp = _compile_registers(prog)
    packed, fused, chained = cp.packed, cp.fused, cp.chained
    packed_plans, fused_plans = cp.packed_plans, cp.fused_plans
    chained_plans = cp.chained_plans
    counted, counted_plans = cp.counted, cp.counted_plans
    midrun, midrun_plans = cp.midrun, cp.midrun_plans
    specs, bit_planes = cp.specs, cp.bit_planes
    needs_marker, n_regs = cp.needs_marker, cp.n_regs

    def transition(state, c):
        # shared membership tests: one per distinct compare-path class, one
        # per bit plane referenced by any bit-sliced register
        tests = []
        for iv in specs:
            t = None
            for lo, hi in iv:
                m = (c == lo) if lo == hi else ((c >= lo) & (c <= hi))
                t = m if t is None else (t | m)
            tests.append(t)
        bit_tests = {k: (c & (1 << k)) != 0 for k in bit_planes}

        def byte_mask(plan: _MaskPlan):
            # OR-tree (not a serial chain): the reduction is the per-byte
            # critical path for class-heavy registers
            terms = [xp.where(tests[cid], bits, 0)
                     for cid, bits in plan.cmp_weights.items()]
            if plan.bslice is not None:
                all_bits, cmask, cval, var = plan.bslice
                if var:
                    # AND-tree, not a serial chain: the per-byte cost is the
                    # step's critical-path DEPTH (round 2d ablations), so
                    # reduce in log2(planes) levels
                    sels = [xp.where(bit_tests[k], s_bits, c_bits)
                            for k, s_bits, c_bits in var]
                    while len(sels) > 1:
                        nxt = [sels[i] & sels[i + 1]
                               for i in range(0, len(sels) - 1, 2)]
                        if len(sels) % 2:
                            nxt.append(sels[-1])
                        sels = nxt
                    m = sels[0]
                else:
                    m = xp.full_like(c, all_bits)
                if cmask:
                    m = xp.where((c & cmask) == cval, m, 0)
                terms.append(m)
            if plan.any_bits:
                terms.append(xp.full_like(c, plan.any_bits))
            if not terms:
                return xp.zeros_like(c)
            while len(terms) > 1:
                nxt = [terms[i] | terms[i + 1]
                       for i in range(0, len(terms) - 1, 2)]
                if len(terms) % 2:
                    nxt.append(terms[-1])
                terms = nxt
            return terms[0]

        def advance(sc: _SegConsts, plan: _MaskPlan, reg, seed, clear=0):
            # `clear` strips shift/smear carries INTO '^'-anchored start
            # bits (their only legitimate activation is the first-byte seed;
            # unanchored start bits are always-seeded, so carries onto them
            # are subsumed and need no clearing).  Returns (next register,
            # post-smear entering set) — wide chunks read the entering set
            # for their cross-register smear carry.
            f = reg << 1
            if clear:
                f = f & ~clear
            f = f | seed
            if len(sc.smear_plan) >= 2 and _arith_fill_ok(sc):
                # arithmetic carry fill: constant 5 ops vs 3/doubling level
                # (_arith_fill_ok proves no run crosses a component boundary;
                # a `clear` bit inside a run would also cross one, so a single
                # post-fill clear matches the per-level doubling clears)
                m = sc.o_mask
                t = f & m
                inc = ((m + t) ^ m) ^ t
                if clear:
                    inc = inc & ~clear
                f = f | inc
            else:
                for d, m in sc.smear_plan:
                    inc = (f & m) << d
                    if clear:
                        inc = inc & ~clear
                    f = f | inc
            b = byte_mask(plan)
            nxt = f & b
            if sc.r_mask:
                nxt = nxt | (reg & sc.r_mask & b)
            return nxt, f

        new_state = []
        accept = None

        def acc_or(v):
            nonlocal accept
            accept = v if accept is None else (accept | v)

        if needs_marker:
            first_b = state[-1] == 0  # the value's first byte (control_update
            first_i = first_b.astype(xp.int32)  # zeroes state at boundaries)

        reg_at = 0
        for sc, plan in zip(packed, packed_plans):
            seed = sc.start_mask
            clear = 0
            if sc.anch_start_mask:
                aseed = xp.where(first_b, sc.anch_start_mask, 0)
                seed = (aseed | seed) if seed else aseed
                clear = sc.anch_start_mask & ~1
            reg, _ = advance(sc, plan, state[reg_at], seed, clear)
            reg_at += 1
            new_state.append(reg)
            cur = None
            if sc.acc_mask:
                sticky = state[reg_at] | (reg & sc.acc_mask)
                reg_at += 1
                new_state.append(sticky)
                cur = sticky
            if sc.acc_now_mask:
                now = reg & sc.acc_now_mask
                cur = now if cur is None else (cur | now)
            acc_or((cur != 0).astype(xp.int32))
        for (sc, seg_offs, seg_accs, anch_e), plan in zip(fused, fused_plans):
            old_reg, done = state[reg_at], state[reg_at + 1]
            reg_at += 2
            seed = first_i if sc.anch_start_mask else 1
            for s in range(1, len(seg_offs)):
                seed = seed | (((done >> (s - 1)) & 1) << seg_offs[s])
            reg, _ = advance(sc, plan, old_reg, seed)
            new_done = done
            last_hit = None
            for s, acc_mask in enumerate(seg_accs):
                hit = ((reg & acc_mask) != 0).astype(xp.int32)
                new_done = new_done | (hit << s)
                last_hit = hit
            acc_or(last_hit if anch_e
                   else ((new_done >> (len(seg_accs) - 1)) & 1))
            new_state.append(reg)
            new_state.append(new_done)
        for (segs, anch_e), plans in zip(chained, chained_plans):
            n_chunk_regs = sum(len(ch) for ch in segs)
            regs = state[reg_at : reg_at + n_chunk_regs]
            done = state[reg_at + n_chunk_regs]
            reg_at += n_chunk_regs + 1
            new_done = done
            last_hit = None
            r = 0
            for s_idx, (chunks, cplans) in enumerate(zip(segs, plans)):
                if s_idx == 0:
                    seed = first_i if chunks[0].anch_start_mask else 1
                else:
                    seed = (done >> (s_idx - 1)) & 1
                hit = None
                prev_old = prev_f = prev_sc = None
                for c_idx, (sc, plan) in enumerate(zip(chunks, cplans)):
                    old = regs[r]
                    r += 1
                    if c_idx:
                        # carries across the register boundary: the old top
                        # position shifts into bit 0; a post-smear entering
                        # bit on an optional top position skips across too
                        top = prev_sc.width - 1
                        carry = (prev_old >> top) & 1
                        if prev_sc.o_mask & (1 << top):
                            carry = carry | ((prev_f >> top) & 1)
                        seed_c = carry
                    else:
                        seed_c = seed
                    nxt, f = advance(sc, plan, old, seed_c)
                    if sc.acc_mask:
                        h = ((nxt & sc.acc_mask) != 0).astype(xp.int32)
                        hit = h if hit is None else (hit | h)
                    new_state.append(nxt)
                    prev_old, prev_f, prev_sc = old, f, sc
                new_done = new_done | (hit << s_idx)
                if s_idx == len(segs) - 1:
                    last_hit = hit
            acc_or(last_hit if anch_e else ((new_done >> (len(segs) - 1)) & 1))
            new_state.append(new_done)
        for ent, plan in zip(counted, counted_plans):
            # lead-run counter machine: cnt = saturating streak of run-class
            # bytes (value-boundary resets zero it like any register)
            cnt = state[reg_at]
            reg_at += 1
            inc = cnt + (cnt < ent.mand).astype(xp.int32)
            new_cnt = (inc if ent.run_cid is None
                       else xp.where(tests[ent.run_cid], inc, 0))
            new_state.append(new_cnt)
            hit_now = (new_cnt >= ent.mand).astype(xp.int32)
            if ent.res is None:
                if ent.anch_e:
                    acc_or(hit_now)  # run must END at the value's last byte
                else:
                    stick = state[reg_at] | hit_now
                    reg_at += 1
                    new_state.append(stick)
                    acc_or(stick)
                continue
            sc, seg_offs, seg_accs = ent.res
            old_reg, done = state[reg_at], state[reg_at + 1]
            reg_at += 2
            # done bit 0 = run-done (sticky machines only: run was segment 0
            # entirely, so it seeds like a '.*' done bit); residual segment s
            # owns done bit s+1.  Non-sticky: the residual's first position
            # must start the byte right after the streak — seed it from the
            # LIVE counter (run through the previous byte) instead.
            seed = (done & 1) if ent.sticky else (cnt >= ent.mand).astype(
                xp.int32)
            for s in range(1, len(seg_offs)):
                seed = seed | (((done >> s) & 1) << seg_offs[s])
            reg, _ = advance(sc, plan, old_reg, seed)
            new_done = (done | hit_now) if ent.sticky else done
            last_hit = None
            for s, acc_mask in enumerate(seg_accs):
                hit = ((reg & acc_mask) != 0).astype(xp.int32)
                new_done = new_done | (hit << (s + 1))
                last_hit = hit
            acc_or(last_hit if ent.anch_e
                   else ((new_done >> len(seg_accs)) & 1))
            new_state.append(reg)
            new_state.append(new_done)
        for ent, (pre_plan, suf_plan) in zip(midrun, midrun_plans):
            # interior-run counter machine: prefix register -> anchored
            # counter -> suffix register (_collapse_interior_runs).  All
            # three pieces read LAST byte's state, so their updates are
            # independent dataflow within the step:
            #   p_prev  = prefix accept through the PREVIOUS byte
            #   counter = run-class streak since its anchor (0 = inactive);
            #             saturates at cap+1 (bounded: counts past the
            #             window disable the seed) or mand (unbounded)
            #   suffix  = seeded from the LIVE counter window, exactly like
            #             the lead-run residual
            pre_reg = state[reg_at]
            cnt = state[reg_at + 1]
            reg_at += 2
            p_prev = ((pre_reg & ent.pre.acc_mask) != 0).astype(xp.int32)
            hit_now = None
            new_suf = None
            if ent.suf is not None:
                seed_ok = cnt >= ent.mand
                if ent.bounded:
                    seed_ok = seed_ok & (cnt <= ent.cap)
                suf_old = state[reg_at]
                reg_at += 1
                sreg, _ = advance(ent.suf, suf_plan, suf_old,
                                  seed_ok.astype(xp.int32))
                hit_now = ((sreg & ent.suf.acc_mask) != 0).astype(xp.int32)
                new_suf = sreg
            cap_sat = (ent.cap + 1) if ent.bounded else ent.mand
            inc = cnt + (cnt < cap_sat).astype(xp.int32)
            active = xp.where(cnt > 0, inc, p_prev)
            new_cnt = (active if ent.run_cid is None
                       else xp.where(tests[ent.run_cid], active, 0))
            if ent.suf is None:
                ok = new_cnt >= ent.mand
                if ent.bounded:
                    ok = ok & (new_cnt <= ent.cap)
                hit_now = ok.astype(xp.int32)
            new_pre, _ = advance(ent.pre, pre_plan, pre_reg,
                                 ent.pre.start_mask)
            new_state.append(new_pre)
            new_state.append(new_cnt)
            if new_suf is not None:
                new_state.append(new_suf)
            if ent.anch_e:
                acc_or(hit_now)
            else:
                stick = state[reg_at] | hit_now
                reg_at += 1
                new_state.append(stick)
                acc_or(stick)

        if needs_marker:
            new_state.append(xp.ones_like(c))
        return tuple(new_state), accept

    return transition, n_regs, 0


# ── the typed expression IR ──────────────────────────────────────────────────

I32, BOOL = "i32", "bool"
_INT_MIN, _INT_MAX = -(1 << 31), (1 << 31) - 1

_BITWISE = {"and", "or", "xor"}
_COMPARE = {"eq", "ne", "lt", "le", "gt", "ge"}


def _wrap32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def _fold(op: str, a: int, b: int) -> int:
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "add":
        return _wrap32(a + b)
    if op == "sub":
        return _wrap32(a - b)
    if op == "shl":
        return _wrap32(a << b)
    if op == "shr":
        return a >> b
    return int({"eq": a == b, "ne": a != b, "lt": a < b, "le": a <= b,
                "gt": a > b, "ge": a >= b}[op])


class _Graph:
    """Node store of one trace: nodes[i] = (op, kind, args); args hold
    node ids, except the value of a `const` and the amount of a shift."""

    def __init__(self):
        self.nodes: list[tuple[str, str, tuple]] = []
        self._memo: dict[tuple, int] = {}

    def add(self, op: str, kind: str, args: tuple) -> "Sym":
        key = (op, kind, args)
        i = self._memo.get(key)
        if i is None:
            i = len(self.nodes)
            self.nodes.append(key)
            self._memo[key] = i
        return Sym(self, i)

    def const(self, v, kind: str = I32) -> "Sym":
        v = int(v)
        if kind == BOOL:
            v = int(bool(v))
        elif not _INT_MIN <= v <= _INT_MAX:
            raise OverflowError(f"constant {v} does not fit int32")
        return self.add("const", kind, (v,))

    def lift(self, v) -> "Sym":
        if isinstance(v, Sym):
            return v
        if isinstance(v, (bool, numbers.Integral)):
            return self.const(v)
        raise TypeError(f"cannot trace operand {v!r}")

    def value(self, s: "Sym"):
        """The constant value of `s`, or None."""
        op, _kind, args = self.nodes[s.i]
        return args[0] if op == "const" else None

    # typed constructors (fold constants, widen bools) ----------------------

    def to_i32(self, s: "Sym") -> "Sym":
        if s.kind == I32:
            return s
        v = self.value(s)
        if v is not None:
            return self.const(v)
        return self.add("cast", I32, (s.i,))

    def binary(self, op: str, a, b) -> "Sym":
        a, b = self.lift(a), self.lift(b)
        if op in _BITWISE and a.kind == BOOL and b.kind == BOOL:
            kind = BOOL
        else:
            a, b, kind = self.to_i32(a), self.to_i32(b), I32
        va, vb = self.value(a), self.value(b)
        out_kind = BOOL if op in _COMPARE else kind
        if va is not None and vb is not None:
            return self.const(_fold(op, va, vb), out_kind)
        # identities that keep the operand's kind
        for x, vy in ((a, vb), (b, va)):
            if vy is None:
                continue
            ones = 1 if kind == BOOL else -1
            if op in ("or", "xor") and vy == 0 or op == "and" and vy == ones:
                return x
            if op == "and" and vy == 0:
                return self.const(0, kind)
        if op in ("add", "sub") and vb == 0:
            return a
        if op in ("and", "or") and a.i == b.i:
            return a
        if op in ("and", "or", "xor", "add", "eq", "ne") and a.i > b.i:
            a, b = b, a  # commutative: one canonical operand order
        return self.add(op, out_kind, (a.i, b.i))

    def shift(self, op: str, a, k) -> "Sym":
        a = self.to_i32(self.lift(a))
        if isinstance(k, Sym):
            k = self.value(k)
        if not isinstance(k, numbers.Integral) or not 0 <= int(k) <= 31:
            raise ValueError(f"shift amount must be a constant in [0, 31]: {k!r}")
        k = int(k)
        va = self.value(a)
        if va is not None:
            return self.const(_fold(op, va, k))
        if k == 0:
            return a
        return self.add(op, I32, (a.i, k))

    def invert(self, a: "Sym") -> "Sym":
        v = self.value(a)
        if v is not None:
            return self.const(1 - v if a.kind == BOOL else ~v, a.kind)
        return self.add("not", a.kind, (a.i,))

    def where(self, cond, a, b) -> "Sym":
        cond, a, b = self.lift(cond), self.lift(a), self.lift(b)
        if cond.kind != BOOL:
            cond = self.binary("ne", cond, 0)
        if not (a.kind == BOOL and b.kind == BOOL):
            a, b = self.to_i32(a), self.to_i32(b)
        vc = self.value(cond)
        if vc is not None:
            return a if vc else b
        if a.i == b.i:
            return a
        return self.add("where", a.kind, (cond.i, a.i, b.i))


class Sym:
    """A traced value: operators record nodes instead of computing."""

    __slots__ = ("g", "i")

    def __init__(self, g: _Graph, i: int):
        self.g, self.i = g, i

    @property
    def kind(self) -> str:
        return self.g.nodes[self.i][1]

    def __bool__(self):
        raise TypeError("a traced value has no truth value: the transition "
                        "must not branch on array values")

    def astype(self, dtype):
        if dtype is not _Namespace.int32:
            raise TypeError(f"only .astype(int32) is traceable, got {dtype!r}")
        return self.g.to_i32(self)

    def __invert__(self):
        return self.g.invert(self)

    def __lshift__(self, k):
        return self.g.shift("shl", self, k)

    def __rshift__(self, k):
        return self.g.shift("shr", self, k)

    __hash__ = object.__hash__


def _binop(op, reflected=False):
    if reflected:
        return lambda self, other: self.g.binary(op, other, self)
    return lambda self, other: self.g.binary(op, self, other)


for _name, _op in (("and", "and"), ("or", "or"), ("xor", "xor"),
                   ("add", "add"), ("sub", "sub")):
    setattr(Sym, f"__{_name}__", _binop(_op))
    setattr(Sym, f"__r{_name}__", _binop(_op, reflected=True))
for _name in ("eq", "ne", "lt", "le", "gt", "ge"):
    setattr(Sym, f"__{_name}__", _binop(_name))


class _Namespace:
    """The `xp` subset the reference transitions use, recording into one
    graph."""

    int32 = object()

    def __init__(self, g: _Graph):
        self._g = g

    def where(self, cond, a, b):
        return self._g.where(cond, a, b)

    def zeros_like(self, c):
        return self._g.const(0)

    def ones_like(self, c):
        return self._g.const(1)

    def full_like(self, c, v):
        return self._g.const(v)


@dataclass(frozen=True, eq=False)
class TransitionIR:
    """One traced matcher transition.  Inputs: node `c` (the byte, i32)
    and `s0..s{n_regs-1}` (i32 registers); outputs: the next registers and
    the accept bit; `accept_empty` is the accept of a zero-length value.
    `nodes` is in topological order and holds only what the outputs
    reach."""

    nodes: tuple
    n_regs: int
    out_state: tuple
    out_accept: int
    accept_empty: int


def trace_transition(make_transition, *args) -> TransitionIR:
    """Runs a reference transition factory `make_transition(xp, *args)`
    (-> (transition, n_state_regs, accept_empty)) with a recording `xp`,
    and returns the typed IR of one byte step."""
    g = _Graph()
    trans, n_regs, accept_empty = make_transition(_Namespace(g), *args)
    c = g.add("input", I32, ("c",))
    state = tuple(g.add("input", I32, (f"s{k}",)) for k in range(n_regs))
    new_state, accept = trans(state, c)
    outs = [g.to_i32(g.lift(s)) for s in new_state]
    acc = g.to_i32(g.lift(accept))
    if len(outs) != n_regs:
        raise ValueError(f"transition returned {len(outs)} registers, "
                         f"declared {n_regs}")
    return _prune(g, outs, acc, n_regs, int(accept_empty))


def _prune(g: _Graph, outs, acc, n_regs: int, accept_empty: int):
    live = set()
    stack = [s.i for s in outs] + [acc.i]
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        op, _kind, args = g.nodes[i]
        stack.extend(_reads(op, args))
    # inputs always keep their slots so evaluators can bind them by name
    keep = sorted(live | {i for i, n in enumerate(g.nodes) if n[0] == "input"})
    remap = {old: new for new, old in enumerate(keep)}
    nodes = []
    for old in keep:
        op, kind, args = g.nodes[old]
        if op in ("const", "input"):
            new_args = args
        elif op in ("shl", "shr"):
            new_args = (remap[args[0]], args[1])
        else:
            new_args = tuple(remap[a] for a in args)
        nodes.append((op, kind, new_args))
    return TransitionIR(tuple(nodes), n_regs,
                        tuple(remap[s.i] for s in outs), remap[acc.i],
                        accept_empty)


@functools.lru_cache(maxsize=256)
def bitprog_ir(pattern: str) -> TransitionIR:
    """The IR of the reference's bit-parallel NFA program for `pattern`
    (raises BitprogUnsupported outside its family)."""
    return trace_transition(make_bitprog_transition, compile_bitprog(pattern))


# ── PyTorch evaluator ───────────────────────────────────────────────────────

_PY_BINARY = {
    "and": operator.and_, "or": operator.or_, "xor": operator.xor,
    "add": operator.add, "sub": operator.sub, "eq": operator.eq,
    "ne": operator.ne, "lt": operator.lt, "le": operator.le,
    "gt": operator.gt, "ge": operator.ge,
}


def _input_slot(name: str) -> int:
    """-1 for the byte `c`, k for register `s<k>`."""
    return -1 if name == "c" else int(name[1:])


def _evaluate(ir: TransitionIR, state, c: torch.Tensor) -> list:
    """Every node's value for one byte step: a tensor shaped like `c`, or a
    Python scalar for a constant."""
    vals: list = []
    for op, kind, args in ir.nodes:
        if op == "const":
            vals.append(bool(args[0]) if kind == BOOL else args[0])
        elif op == "input":
            slot = _input_slot(args[0])
            vals.append(c if slot < 0 else state[slot])
        elif op == "cast":
            vals.append(vals[args[0]].to(torch.int32))
        elif op == "not":
            vals.append(torch.bitwise_not(vals[args[0]]))
        elif op == "shl":
            vals.append(torch.bitwise_left_shift(vals[args[0]], args[1]))
        elif op == "shr":
            vals.append(torch.bitwise_right_shift(vals[args[0]], args[1]))
        elif op == "where":
            cond, a, b = (vals[j] for j in args)
            if not isinstance(a, torch.Tensor):
                dtype = torch.bool if kind == BOOL else torch.int32
                a = torch.full_like(c, a, dtype=dtype)
            vals.append(torch.where(cond, a, b))
        else:
            vals.append(_PY_BINARY[op](vals[args[0]], vals[args[1]]))
    return vals


def eval_torch(ir: TransitionIR, state, c: torch.Tensor):
    """One byte step on tensors: `state` is a tuple of int32 tensors shaped
    like `c` (the byte, int32).  Returns (next_state tuple, accept int32).
    Constants stay Python scalars (a scalar operand keeps the tensor's
    dtype); a constant output is broadcast to `c`'s shape."""

    def full(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.full_like(c, v, dtype=torch.int32)

    vals = _evaluate(ir, state, c)
    return (tuple(full(vals[i]) for i in ir.out_state),
            full(vals[ir.out_accept]))


# ── the byte half ───────────────────────────────────────────────────────────


def _reads(op: str, args: tuple) -> tuple:
    """The node ids a node reads (a shift's second argument is its
    amount)."""
    if op in ("const", "input"):
        return ()
    return args[:1] if op in ("shl", "shr") else args


def byte_only(ir: TransitionIR) -> list[bool]:
    """Per node: it computes from the byte and from no register (the byte
    itself and the constants are not counted)."""
    state, byte, out = [], [], []
    for op, _kind, args in ir.nodes:
        reads = _reads(op, args)
        state.append(op == "input" and args[0] != "c"
                     or any(state[a] for a in reads))
        byte.append(op == "input" and args[0] == "c"
                    or any(byte[a] for a in reads))
        out.append(op != "input" and byte[-1] and not state[-1])
    return out


def byte_frontier(ir: TransitionIR) -> tuple[int, ...]:
    """The byte-only nodes (`byte_only`) whose values leave the byte-only
    half: read by a node that reads a register, or a next register or the
    accept themselves.  They are functions of the byte alone, so a table of
    each over the 256 bytes (`byte_table`) stands for the whole half."""
    only = byte_only(ir)
    front = {i for i in (*ir.out_state, ir.out_accept) if only[i]}
    for i, (op, _kind, args) in enumerate(ir.nodes):
        if not only[i] and op != "input":
            front.update(a for a in _reads(op, args) if only[a])
    return tuple(sorted(front))


def byte_table(ir: TransitionIR) -> torch.Tensor:
    """[F, 256] int32: row f holds node `byte_frontier(ir)[f]` at every
    byte value (a bool node as 0 / 1)."""
    c = torch.arange(256, dtype=torch.int32)
    zero = tuple(torch.zeros_like(c) for _ in range(ir.n_regs))
    vals = _evaluate(ir, zero, c)
    rows = [vals[i].to(torch.int32) for i in byte_frontier(ir)]
    if not rows:
        return torch.zeros((0, 256), dtype=torch.int32)
    return torch.stack(rows)


# ── C emitter ───────────────────────────────────────────────────────────────

_C_OPS = {"and": "&", "or": "|", "xor": "^", "eq": "==", "ne": "!=",
          "lt": "<", "le": "<=", "gt": ">", "ge": ">="}


def _c_const(v: int, kind: str) -> str:
    if kind == BOOL:
        return "true" if v else "false"
    if v == _INT_MIN:
        return "(-2147483647 - 1)"
    return f"({v})" if v < 0 else str(v)


def emit_c(ir: TransitionIR, prefix: str, c_name: str, state_names,
           next_names, accept_name: str, inputs: dict | None = None) -> str:
    """Straight-line C for one byte step: reads `c_name` and the
    `state_names` registers (int32_t), declares `next_names` and
    `accept_name` (int32_t).  Temporaries are `<prefix><node>`.  Integer
    add/sub/shl go through uint32_t (wraparound, never signed overflow);
    `>>` stays an arithmetic shift of int32_t.

    `inputs` ({node: C expression of int32_t}), where given, emits the
    state half only: each node of `byte_frontier(ir)` reads its expression
    (a bool node as the expression != 0), and the other byte-only nodes are
    left out."""
    if len(state_names) != ir.n_regs or len(next_names) != ir.n_regs:
        raise ValueError("register name count does not match the IR")
    only = [False] * len(ir.nodes)
    if inputs is not None:
        if set(inputs) != set(byte_frontier(ir)):
            raise ValueError("inputs must name the IR's byte frontier")
        only = byte_only(ir)
    names: list[str | None] = []
    lines: list[str] = []
    for i, (op, kind, args) in enumerate(ir.nodes):
        if op == "const":
            names.append(_c_const(args[0], kind))
            continue
        if op == "input":
            slot = _input_slot(args[0])
            names.append(c_name if slot < 0 else state_names[slot])
            continue
        if only[i] and i not in inputs:
            names.append(None)  # inside the byte half: never read here
            continue
        a = [names[j] for j in _reads(op, args)]
        if only[i]:
            expr = f"({inputs[i]} != 0)" if kind == BOOL else inputs[i]
        elif op == "cast":
            expr = f"(int32_t){a[0]}"
        elif op == "not":
            expr = f"!{a[0]}" if kind == BOOL else f"~{a[0]}"
        elif op == "shl":
            expr = f"(int32_t)((uint32_t){a[0]} << {args[1]})"
        elif op == "shr":
            expr = f"({a[0]} >> {args[1]})"
        elif op in ("add", "sub"):
            sign = "+" if op == "add" else "-"
            expr = f"(int32_t)((uint32_t){a[0]} {sign} (uint32_t){a[1]})"
        elif op == "where":
            expr = f"({a[0]} ? {a[1]} : {a[2]})"
        else:
            expr = f"({a[0]} {_C_OPS[op]} {a[1]})"
        name = f"{prefix}{i}"
        ctype = "bool" if kind == BOOL else "int32_t"
        lines.append(f"const {ctype} {name} = {expr};")
        names.append(name)
    for dst, i in zip(next_names, ir.out_state):
        lines.append(f"const int32_t {dst} = {names[i]};")
    lines.append(f"const int32_t {accept_name} = {names[ir.out_accept]};")
    return "\n".join(lines)
