"""Register-machine transitions as a typed expression IR.

The reference builds its per-byte matcher transition as a Python closure
over an `xp` array namespace (`duckdb_parquet_parser_tpu.ops.bitprog.
make_bitprog_transition`, and `ops/strings.make_bitap_transition` for
substring chains).  The closure only uses `where`, `zeros_like`,
`ones_like`, `full_like`, `.astype(int32)` and Python operators, and no
Python branch depends on array values (it was written to be traced by
`jax.jit`).  So running it ONCE with a recording namespace yields the whole
transition as a small DAG (tens of nodes per byte), and that one IR drives
both back ends of the port:

  * `eval_torch(ir, state, c)` — the plain PyTorch evaluator (CPU path and
    the reference the kernels are held against);
  * `emit_c(ir, ...)` — straight-line C for the CUDA stream-matcher kernel
    (ops/kernels/stream_matcher.py).

Every node is typed `bool` or `i32`, following numpy/jnp promotion (a
bool operand of an integer operator is widened first).  Integer arithmetic
wraps at 32 bits, as it does in numpy and jnp; shift amounts are constants
in [0, 31] and `>>` is arithmetic.  Constants fold and identical nodes are
shared while tracing.
"""

from __future__ import annotations

import functools
import numbers
import operator
from dataclasses import dataclass

import torch

from duckdb_parquet_parser_tpu.ops.bitprog import (
    compile_bitprog,
    make_bitprog_transition,
)

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
        if op in ("const", "input"):
            continue
        stack.extend(args[:1] if op in ("shl", "shr") else args)
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


def eval_torch(ir: TransitionIR, state, c: torch.Tensor):
    """One byte step on tensors: `state` is a tuple of int32 tensors shaped
    like `c` (the byte, int32).  Returns (next_state tuple, accept int32).
    Constants stay Python scalars (a scalar operand keeps the tensor's
    dtype); a constant output is broadcast to `c`'s shape."""

    def full(v, kind=I32):
        if isinstance(v, torch.Tensor):
            return v
        dtype = torch.bool if kind == BOOL else torch.int32
        return torch.full_like(c, v, dtype=dtype)

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
                a = full(a, kind)
            vals.append(torch.where(cond, a, b))
        else:
            vals.append(_PY_BINARY[op](vals[args[0]], vals[args[1]]))
    return (tuple(full(vals[i]) for i in ir.out_state),
            full(vals[ir.out_accept]))


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
           next_names, accept_name: str) -> str:
    """Straight-line C for one byte step: reads `c_name` and the
    `state_names` registers (int32_t), declares `next_names` and
    `accept_name` (int32_t).  Temporaries are `<prefix><node>`.  Integer
    add/sub/shl go through uint32_t (wraparound, never signed overflow);
    `>>` stays an arithmetic shift of int32_t."""
    if len(state_names) != ir.n_regs or len(next_names) != ir.n_regs:
        raise ValueError("register name count does not match the IR")
    names: list[str] = []
    lines: list[str] = []
    for i, (op, kind, args) in enumerate(ir.nodes):
        if op == "const":
            names.append(_c_const(args[0], kind))
            continue
        if op == "input":
            slot = _input_slot(args[0])
            names.append(c_name if slot < 0 else state_names[slot])
            continue
        a = [names[j] for j in (args[:1] if op in ("shl", "shr") else args)]
        if op == "cast":
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
