"""K1 — the streaming regex matcher as a CUDA kernel for Hopper.

Replaces the TPU kernel `duckdb_parquet_parser_tpu/ops/pallas/
stream_matcher.py::_build_call` (bodies `kernel`, `kernel1`, `kernel_sb`):
every PLAIN byte of every query goes through it.  One CUDA kernel serves
the contracts of all three TPU bodies (single pattern, K fused patterns,
and the split layout's short segment lanes); the TPU's tiled layout, lane
tiles, stream counts and step blocks existed for VMEM and sublane packing
and are not ported.

What bounds it on the H100: each lane is a sequential walk whose per-byte
cost is the dependent chain of the transition (tens of int32 ops) plus the
boundary control, so the kernel is bound by the latency of each thread's
chain, not by memory bandwidth: every byte of the resident stream is read
once.  The design: one thread per lane with every register machine held
in registers, the transitions emitted as straight-line C from the traced
IR (ops/bitprog.emit_c), a coalesced byte load per step from the
pre-transposed [steps, n] stream, and an early exit at the lane's first
inactive byte.  Filling the card with enough independent lanes, and
loading more than one byte per step, are later work.

Several pattern tuples build into one library (`prepare`), so a run pays
one `nvcc` call for all the tuples it names up front.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib

import torch

from .. import strings
from ..bitprog import TransitionIR, emit_c
from . import build

launches = 0  # kernel launches (one per call that reaches the card)

_TEMPLATE = "stream_matcher.cu.in"
_registry: dict[str, object] = {}  # tag -> loaded launch function


@functools.lru_cache(maxsize=1)
def _sections() -> dict[str, str]:
    out, name = {}, None
    for line in build.read_csrc(_TEMPLATE).splitlines(keepends=True):
        if line.startswith("//@@ "):
            name = line[5:].strip()
            out[name] = ""
        elif name is not None:
            out[name] += line
    return out


@functools.lru_cache(maxsize=256)
def _walk(irs: tuple[TransitionIR, ...]) -> tuple[str, str]:
    """(tag, walk-section source with @TAG@ still open) for one pattern
    tuple; the tag hashes the rendered walk."""
    decl, trans, hits, state, store = [], [], [], [], []
    reg = 0
    for k, ir in enumerate(irs):
        regs = [f"r{reg + j}" for j in range(ir.n_regs)]
        nxt = [f"n{reg + j}" for j in range(ir.n_regs)]
        reg += ir.n_regs
        decl += [f"int32_t {r} = 0;" for r in regs] + [f"int32_t h{k} = 0;"]
        trans.append(emit_c(ir, f"t{k}_", "c", regs, nxt, f"a{k}"))
        hits.append(f"if (fin) h{k} += zero_len ? {ir.accept_empty} : a{k};")
        state += [f"{r} = prefix_done ? 0 : (in_prefix ? {r} : {x});"
                  for r, x in zip(regs, nxt)]
        store.append(f"hits[{k}LL * n + lane] = h{k};")

    def block(lines, indent):
        return "\n".join(indent + ln for text in lines
                         for ln in text.splitlines())

    body = (_sections()["walk"]
            .replace("@K@", str(len(irs)))
            .replace("@DECLARE@", block(decl, "    "))
            .replace("@TRANSITION@", block(trans, "        "))
            .replace("@HITS@", block(hits, "        "))
            .replace("@STATE@", block(state, "        "))
            .replace("@STORE@", block(store, "    ")))
    tag = hashlib.sha1(body.encode()).hexdigest()[:12]
    return tag, body


def render(ir_tuples, host: bool = False) -> str:
    """The full source for the given pattern tuples: CUDA kernels and
    launch functions, or (`host=True`) plain C++ host loops over the same
    walk, which the CPU tests compile with g++."""
    sec = _sections()
    tags = {}
    for irs in ir_tuples:
        tag, body = _walk(tuple(irs))
        tags[tag] = body.replace("@TAG@", tag)
    parts = [sec["prelude"], *tags.values()]
    if host:
        parts += [sec["host"].replace("@TAG@", t) for t in tags]
    else:
        parts.append(sec["kernel_prelude"])
        parts += [sec["kernel"].replace("@TAG@", t) for t in tags]
    return "".join(parts)


def tag_of(irs) -> str:
    return _walk(tuple(irs))[0]


def prepare(ir_tuples) -> None:
    """Builds one library holding a kernel for every tuple not built yet
    (one nvcc run) and registers their launch functions."""
    todo = {}
    for irs in ir_tuples:
        todo.setdefault(tag_of(irs), tuple(irs))
    todo = {t: irs for t, irs in todo.items() if t not in _registry}
    if not todo:
        return
    lib = build.load_source(render(list(todo.values())))
    for tag in todo:
        fn = getattr(lib, f"dpq_stream_launch_{tag}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _registry[tag] = fn


def match_stream_plain(payload_t, plen, nn, irs, steps: int | None = None):
    """The plain PyTorch version: (hits [K, n] int32, seen [n] int32)."""
    hits, seen = strings.match_payload_multi(payload_t, plen, nn, irs, steps)
    return torch.stack(hits), seen


def match_stream(payload_t: torch.Tensor, plen: torch.Tensor,
                 nn: torch.Tensor, irs, steps: int | None = None):
    """K register-machine patterns over the [P, n] u8 stream `payload_t`
    (lane j's raw value section down column j), walking at most `steps`
    bytes.  Returns (hits [K, n] int32, seen [n] int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    irs = tuple(irs)
    dev = payload_t.device
    if dev.type == "cpu":
        return match_stream_plain(payload_t, plen, nn, irs, steps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if payload_t.dtype != torch.uint8 or payload_t.dim() != 2:
        raise ValueError("payload_t must be a 2-D uint8 tensor [steps, n]")
    if not payload_t.is_contiguous():
        raise ValueError("payload_t must be contiguous")
    p, n = payload_t.shape
    for name, t in (("plen", plen), ("nn", nn)):
        if (t.device != dev or t.dtype != torch.int32 or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [{n}] "
                             f"tensor on {dev}")
    steps = p if steps is None else min(int(steps), p)
    if not irs:
        raise ValueError("match_stream needs at least one pattern")
    hits = torch.empty((len(irs), n), dtype=torch.int32, device=dev)
    seen = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return hits, seen
    tag = tag_of(irs)
    if tag not in _registry:
        prepare([irs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _registry[tag](payload_t.data_ptr(), n, steps, plen.data_ptr(),
                            nn.data_ptr(), hits.data_ptr(), seen.data_ptr(),
                            stream)
    if rc != 0:
        raise RuntimeError(f"stream matcher launch failed: cudaError {rc}")
    launches += 1
    return hits, seen
