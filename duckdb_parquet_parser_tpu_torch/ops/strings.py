"""Streaming matcher over raw PLAIN BYTE_ARRAY payloads — plain PyTorch.

Port of `duckdb_parquet_parser_tpu.ops.strings` (`_match_stream_multi`,
`match_payload_stream`, `match_payload_multi`).  Each lane (one page, or
one split segment) walks its raw value section one byte per step: a 4-byte
little-endian length prefix, then the value bytes.  Per byte, K matcher
transitions advance; the state resets at each value start; at each value
end the lane adds the accept bit to `hits[k]` (a zero-length value adds
`accept_empty`).  The lane stops after `nn` values or `plen` bytes.

This is the plain version the CUDA stream-matcher kernel is held against
(ops/kernels/stream_matcher.py), and the path CPU tensors take.  It walks
the [steps, N] u8 stream (lane j's bytes down column j); the resident
column keeps the kernel's chunked layout, which
`stream_matcher.unchunk_stream` turns back into this one.

Matchers: register machines (the reference's bit-parallel programs, or
Shift-And chains for pure substring chains) come as traced IRs
(ops/bitprog.py); patterns outside both families use the table DFA as a
plain gather (`dfa_transition`).  The reference's MXU one-hot DFA
(`ops/mxu_dfa.py`) existed only to avoid TPU gathers, and its 2-byte pair
step (`make_bitprog_transition_pair`) is off by default there; neither is
ported.
"""

from __future__ import annotations

import functools

import torch

from .bitprog import (
    BitprogUnsupported,
    TransitionIR,
    bitprog_ir,
    eval_torch,
    trace_transition,
)
from .regex import substring_chain


def make_bitap_transition(xp, needles: list[bytes]):
    """Shift-And (bitap) transition for substring-chain patterns
    ('%lit1%lit2%' / 'lit1.*lit2'); the port's own copy of the reference's
    `ops/strings.make_bitap_transition`, kept generic over the `xp`
    namespace because the IR tracer drives it.

    Exact ordered-substring matching: register k is a bitset of the active
    prefix lengths of needle k (all prefixes tracked simultaneously, so
    self-overlapping needles are handled); needle k+1 starts seeding only
    after needle k has completed.

    Returns (transition(state_tuple, c) -> (next_tuple, accept [N] i32),
    n_state_regs, accept_empty).
    """
    k_needles = len(needles)
    specs = []
    for nd in needles:
        masks: dict[int, int] = {}
        for pos, byte in enumerate(nd):
            masks[byte] = masks.get(byte, 0) | (1 << pos)
        specs.append((sorted(masks.items()), 1 << (len(nd) - 1)))

    def transition(state, c):
        regs, donebits = state[:-1], state[-1]
        new_regs = []
        new_done = donebits
        for k, (mask_items, top_bit) in enumerate(specs):
            mask = xp.zeros_like(c)
            for byte, m in mask_items:
                mask = mask | xp.where(c == byte, m, 0)
            seed = 1 if k == 0 else ((donebits >> (k - 1)) & 1)
            reg = ((regs[k] << 1) | seed) & mask
            hit = ((reg & top_bit) != 0).astype(xp.int32)
            new_done = new_done | (hit << k)
            new_regs.append(reg)
        accept = (new_done >> (k_needles - 1)) & 1
        return tuple(new_regs) + (new_done,), accept

    return transition, k_needles + 1, 0


@functools.lru_cache(maxsize=256)
def bitap_ir(needles: tuple[bytes, ...]) -> TransitionIR:
    """The IR of the reference's Shift-And transition for a substring
    chain."""
    return trace_transition(make_bitap_transition, list(needles))


def pattern_ir(pattern: str) -> TransitionIR | None:
    """The register-machine IR for `pattern` by the reference's priority —
    bit-parallel program, then bitap chain — or None when the pattern needs
    the table DFA."""
    try:
        return bitprog_ir(pattern)
    except BitprogUnsupported:
        chain = substring_chain(pattern)
        return bitap_ir(tuple(chain)) if chain else None


def ir_spec(ir: TransitionIR):
    """(transition, n_state_regs, accept_empty) for a traced IR."""
    return functools.partial(eval_torch, ir), ir.n_regs, ir.accept_empty


def dfa_spec(table, accept, device):
    """(transition, 1, accept_empty) for the table DFA: `state =
    table[state, c]`, `accept = accept[state]` as flat gathers."""
    tflat = torch.as_tensor(table, dtype=torch.int32).reshape(-1).to(device)
    acc = torch.as_tensor(accept).to(torch.int32).to(device)
    accept_empty = int(acc[0])

    def transition(state, c):
        nxt = tflat[(state[0].clamp(min=0) * 256 + c).long()]
        return (nxt,), acc[nxt.long()]

    return transition, 1, accept_empty


def match_stream_multi(payload_t: torch.Tensor, plen: torch.Tensor,
                       nn: torch.Tensor, specs, steps: int | None = None):
    """K matcher transitions in ONE walk over `payload_t` [P, N] u8.
    `specs` is a list of (transition, n_state_regs, accept_empty).
    Returns (hits: tuple of K [N] int32, seen [N] int32).

    `ctr` serves double duty as in the reference: inside a length prefix it
    accumulates the little-endian length, inside a value it counts the
    bytes left.  Inactive lanes may hold garbage ctr/state; `active` gates
    every finalize."""
    p, n = payload_t.shape
    steps = min(int(steps if steps is not None else p), p)
    dev = payload_t.device
    nn = nn.to(device=dev, dtype=torch.int32)
    plen = plen.to(device=dev, dtype=torch.int32)

    def zero():
        return torch.zeros(n, dtype=torch.int32, device=dev)

    total_regs = sum(s[1] for s in specs)
    prefix_left = torch.full((n,), 4, dtype=torch.int32, device=dev)
    ctr, done = zero(), zero()
    state = tuple(zero() for _ in range(total_regs))
    hits = [zero() for _ in specs]
    for b in range(steps):
        c = payload_t[b].to(torch.int32)
        st2, accs, at = [], [], 0
        for trans, nregs, _ae in specs:
            s2, a = trans(state[at:at + nregs], c)
            at += nregs
            st2.extend(s2)
            accs.append(a)

        active = (b < plen) & (done < nn)
        in_prefix = prefix_left > 0
        # prefix byte: accumulate the length (the shift reaches bit 31 and
        # wraps in int32, as in the reference)
        la2 = ctr | torch.bitwise_left_shift(c, 8 * (4 - prefix_left))
        pl2 = prefix_left - 1
        prefix_done = in_prefix & (pl2 == 0) & active
        zero_len = prefix_done & (la2 == 0)
        # value byte: count down
        bl2 = ctr - 1
        value_done = ~in_prefix & (bl2 == 0) & active
        fin = zero_len | value_done
        for k, (_t, _n, ae) in enumerate(specs):
            add = torch.where(zero_len, ae, accs[k])
            hits[k] = hits[k] + torch.where(fin, add, 0)
        done = done + fin.to(torch.int32)
        prefix_left = torch.where(fin, 4, torch.where(in_prefix, pl2,
                                                      prefix_left))
        ctr = torch.where(fin, 0, torch.where(in_prefix, la2, bl2))
        state = tuple(
            torch.where(prefix_done, 0, torch.where(in_prefix, old, new))
            for old, new in zip(state, st2))
    return tuple(hits), done


def match_payload_stream(payload_t, plen, nn, table, accept,
                         steps: int | None = None):
    """Single-pattern walk of the table DFA (patterns outside the
    register-machine family).  Returns (hits [N] int32, seen [N] int32)."""
    spec = dfa_spec(table, accept, payload_t.device)
    hits, seen = match_stream_multi(payload_t, plen, nn, [spec], steps)
    return hits[0], seen


def match_payload_multi(payload_t, plen, nn, irs, steps: int | None = None):
    """K register-machine patterns in one walk.  Returns (hits: tuple of K
    [N] int32, seen [N] int32)."""
    return match_stream_multi(payload_t, plen, nn,
                              [ir_spec(ir) for ir in irs], steps)
