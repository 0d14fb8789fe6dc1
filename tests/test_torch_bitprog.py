"""Traced transition IR (duckdb_parquet_parser_tpu_torch/ops/bitprog.py)
against the reference's numpy walk.

Every bit-parallel pattern family of tests/test_bitprog.py, plus Shift-And
chains, goes through (a) the IR evaluated in PyTorch and (b) the C that
`emit_c` generates, inside the stream-matcher template, compiled for the
host with g++ — so a codegen fault shows before any GPU time is spent.
The emitted walk also runs at the edges of its 16-byte chunks
(tests/page_edges.py, shared with K3's page walk), where its value-boundary
control, once a value, meets prefixes, values and cuts of the walk.
Tolerance 0: every output is an integer count.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from duckdb_parquet_parser_tpu.ops.bitprog import compile_bitprog
from duckdb_parquet_parser_tpu.ops.strings import match_payload_stream
from duckdb_parquet_parser_tpu_torch.ops import bitprog as tb
from duckdb_parquet_parser_tpu_torch.ops import strings as ts
from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher
from tests import k1_host
from tests.page_edges import (K1_EDGE_WALKS, PAGE_EDGE_STEPS, PAGE_EDGES,
                               k1_edge_irs, page_edge)
from tests.test_bitprog import SUPPORTED, _pages

CHAINS = [(b"ab",), (b"ab", b"q"), (b"abc", b"x", b"yz"), (b"qq", b"q"),
          (b"abcdefgabcdefgabcdefgabcdefgab",)]
FUSED = ("a.*z", "q[ax]+x", "^cat|dog$", "x{40}y{40}")


@pytest.fixture(scope="module")
def pages():
    pm, plen, nn = _pages(np.random.default_rng(5))
    pt = torch.from_numpy(np.ascontiguousarray(pm.T))
    return pm, plen, nn, pt


def _reference(pm, plen, nn, pattern=None, chain=None, steps=None):
    prog = compile_bitprog(pattern) if pattern is not None else None
    return match_payload_stream(np, pm, plen, nn, None, None, steps,
                                prog=prog,
                                chain=list(chain) if chain else None)


@pytest.mark.parametrize("pattern", SUPPORTED)
def test_ir_torch_matches_numpy(pages, pattern):
    pm, plen, nn, pt = pages
    h0, s0 = _reference(pm, plen, nn, pattern)
    (h1,), s1 = ts.match_payload_multi(pt, torch.from_numpy(plen),
                                       torch.from_numpy(nn),
                                       (tb.bitprog_ir(pattern),))
    np.testing.assert_array_equal(h1.numpy(), h0, err_msg=pattern)
    np.testing.assert_array_equal(s1.numpy(), s0, err_msg=pattern)


@pytest.mark.parametrize("chain", CHAINS)
def test_bitap_ir_torch_matches_numpy(pages, chain):
    pm, plen, nn, pt = pages
    h0, s0 = _reference(pm, plen, nn, chain=chain)
    (h1,), s1 = ts.match_payload_multi(pt, torch.from_numpy(plen),
                                       torch.from_numpy(nn),
                                       (ts.bitap_ir(chain),))
    np.testing.assert_array_equal(h1.numpy(), h0)
    np.testing.assert_array_equal(s1.numpy(), s0)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The emitted walks of every case, built for the host with g++."""
    tuples = ([(tb.bitprog_ir(p),) for p in SUPPORTED]
              + [(ts.bitap_ir(c),) for c in CHAINS]
              + [tuple(ts.pattern_ir(p) for p in FUSED)]
              + [k1_edge_irs(walk) for walk in K1_EDGE_WALKS])
    return k1_host.build(tuples, tmp_path_factory.mktemp("walk"))


@pytest.mark.parametrize("pattern", SUPPORTED)
def test_emitted_c_matches_numpy(host_lib, pages, pattern):
    pm, plen, nn, _pt = pages
    h0, s0 = _reference(pm, plen, nn, pattern)
    hits, seen = k1_host.walk(host_lib, (tb.bitprog_ir(pattern),), pm, plen,
                              nn)
    np.testing.assert_array_equal(hits[0], h0, err_msg=pattern)
    np.testing.assert_array_equal(seen, s0, err_msg=pattern)


@pytest.mark.parametrize("chain", CHAINS)
def test_emitted_bitap_c_matches_numpy(host_lib, pages, chain):
    pm, plen, nn, _pt = pages
    h0, s0 = _reference(pm, plen, nn, chain=chain)
    hits, seen = k1_host.walk(host_lib, (ts.bitap_ir(chain),), pm, plen, nn)
    np.testing.assert_array_equal(hits[0], h0)
    np.testing.assert_array_equal(seen, s0)


def test_emitted_fused_c_matches_numpy(host_lib, pages):
    pm, plen, nn, _pt = pages
    irs = tuple(ts.pattern_ir(p) for p in FUSED)
    hits, seen = k1_host.walk(host_lib, irs, pm, plen, nn)
    for k, p in enumerate(FUSED):
        h0, s0 = _reference(pm, plen, nn, p)
        np.testing.assert_array_equal(hits[k], h0, err_msg=p)
        np.testing.assert_array_equal(seen, s0)


@pytest.mark.parametrize("walk", list(K1_EDGE_WALKS))
@pytest.mark.parametrize("edge", list(PAGE_EDGES))
def test_emitted_walk_chunk_edges(host_lib, edge, walk):
    """The emitted walk at the edges of its chunks, under cuts of `steps`
    that land in prefixes and in values: against the port's plain walk and
    the JAX package's numpy walk, pattern by pattern."""
    pm, plen, nn = page_edge([edge])
    irs = k1_edge_irs(walk)
    spec = K1_EDGE_WALKS[walk]
    refs = ([{"chain": spec}] if walk == "bitap" else
            [{"pattern": spec}] if walk == "bitprog" else
            [{"pattern": p} for p in spec])
    pt = torch.from_numpy(np.ascontiguousarray(pm.T))
    for steps in PAGE_EDGE_STEPS:
        hits, seen = k1_host.walk(host_lib, irs, pm, plen, nn, steps)
        h1, s1 = stream_matcher.match_stream_plain(
            pt, torch.from_numpy(plen), torch.from_numpy(nn), irs, steps)
        np.testing.assert_array_equal(hits, h1.numpy(), err_msg=f"{steps}")
        np.testing.assert_array_equal(seen, s1.numpy(), err_msg=f"{steps}")
        for k, ref in enumerate(refs):
            h0, s0 = _reference(pm, plen, nn, steps=steps, **ref)
            np.testing.assert_array_equal(hits[k], h0, err_msg=f"{ref} {steps}")
            np.testing.assert_array_equal(seen, s0, err_msg=f"{steps}")


def test_long_prefix_reaches_bit_31():
    """A length prefix with its top byte set: the accumulator's last shift
    lands in bit 31 and wraps, as the reference's int32 math does; the
    value never ends inside the section, so no hit and no count."""
    pm = np.zeros((2, 16), np.uint8)
    pm[0, :8] = [1, 0, 0, 0x80, ord("a"), ord("z"), 0, 0]
    pm[1, :6] = [1, 0, 0, 0, ord("a"), 0]
    plen = np.array([8, 5], np.int32)
    nn = np.array([1, 1], np.int32)
    h0, s0 = _reference(pm, plen, nn, "a")
    (h1,), s1 = ts.match_payload_multi(
        torch.from_numpy(np.ascontiguousarray(pm.T)), torch.from_numpy(plen),
        torch.from_numpy(nn), (tb.bitprog_ir("a"),))
    np.testing.assert_array_equal(h1.numpy(), h0)
    np.testing.assert_array_equal(s1.numpy(), s0)


def test_tracer_folds_wraps_and_types():
    def make(xp):
        def transition(state, c):
            r = state[0]
            big = (r << 31) + 0x7FFFFFFF          # wraps in int32
            flag = (c == 65) | (c == 66)          # bool | bool -> bool
            both = flag & (r > 3)                 # stays bool
            return (big, (both.astype(xp.int32) << 1) | 1), ~flag
        return transition, 2, 0

    ir = tb.trace_transition(make)
    kinds = {(op, kind) for op, kind, _ in ir.nodes}
    assert {("or", tb.BOOL), ("and", tb.BOOL), ("not", tb.BOOL),
            ("or", tb.I32)} <= kinds
    c = torch.tensor([65, 66, 67, 0], dtype=torch.int32)
    s = (torch.tensor([1, 4, 5, -1], dtype=torch.int32),
         torch.tensor([0, 0, 0, 0], dtype=torch.int32))
    (big, bits), acc = tb.eval_torch(ir, s, c)
    want_big = ((s[0].numpy().astype(np.int64) << 31) + 0x7FFFFFFF)
    want_big = ((want_big + 2**31) % 2**32 - 2**31).astype(np.int32)
    np.testing.assert_array_equal(big.numpy(), want_big)
    np.testing.assert_array_equal(bits.numpy(), [1, 3, 1, 1])
    np.testing.assert_array_equal(acc.numpy(), [0, 0, 1, 1])
    code = tb.emit_c(ir, "t", "c", ["r0", "r1"], ["n0", "n1"], "acc")
    assert "(uint32_t)r0 << 31" in code and "!" in code


def test_tracer_rejects_value_branches_and_wide_constants():
    def branchy(xp):
        return (lambda state, c: (((c if c == 1 else c),), c)), 1, 0

    with pytest.raises(TypeError):
        tb.trace_transition(branchy)

    def too_wide(xp):
        return (lambda state, c: ((c | (1 << 32),), c)), 1, 0

    with pytest.raises(OverflowError):
        tb.trace_transition(too_wide)

    def runtime_shift(xp):
        return (lambda state, c: ((c << c,), c)), 1, 0

    with pytest.raises(ValueError):
        tb.trace_transition(runtime_shift)


def test_int_min_constant_emits_valid_c():
    assert tb._c_const(-(1 << 31), tb.I32) == "(-2147483647 - 1)"
    assert tb._c_const(-5, tb.I32) == "(-5)"
    assert tb._c_const(1, tb.BOOL) == "true"
