"""K1 — the streaming regex matcher as a CUDA kernel for Hopper.

Replaces the TPU kernel `duckdb_parquet_parser_tpu/ops/pallas/
stream_matcher.py::_build_call` (bodies `kernel`, `kernel1`, `kernel_sb`):
every PLAIN byte of every query goes through it.  One CUDA kernel serves
the contracts of all three TPU bodies (single pattern, K fused patterns,
and the split layout's short segment lanes); the TPU's tiled layout, lane
tiles, stream counts and step blocks existed for its vector memory and
sublane packing and are not ported.

What bounds it on the H100: operations.  Each lane is a sequential walk
whose per-byte cost is the dependent int32 chain of the transition (tens
of operations), while every byte of the resident stream is read once.  So
the design keeps every load and the value-boundary control out of that
chain: the stream is resident in 16-byte chunks, `[chunks, n, 16]` u8
(`chunk_stream`), one thread per lane reads 16 bytes of its own lane in
one load (a warp reads 512 neighbouring bytes) and holds chunks i to i + 2
in registers; the value boundaries of a chunk (accept, count, the next
length prefix, the reset) are worked out once a value, as two masks of
the chunk's bytes, and the chunk's 16 steps are unrolled, each the
transition, an AND that keeps or resets the state and the accept where a
value ends.  Every register machine lives in registers, the transitions
are emitted as straight-line C from the traced IR (ops/bitprog.emit_c),
and a lane stops after its last value that ends inside the walk (lanes
arrive sorted by length, so a warp's lanes end together).

The wrapper's contract: `match_stream` takes the chunked layout;
`match_stream_plain` takes the [steps, n] stream; `chunk_stream` and
`unchunk_stream` convert.

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

CHUNK = 16    # bytes of one lane that lie together in the resident stream
THREADS = 64  # lanes per block: small blocks spread evenly over the SMs

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
    decl, trans, hits, empty, state, store = [], [], [], [], [], []
    reg = 0
    for k, ir in enumerate(irs):
        regs = [f"r{reg + j}" for j in range(ir.n_regs)]
        nxt = [f"n{reg + j}" for j in range(ir.n_regs)]
        reg += ir.n_regs
        decl += [f"int32_t {r} = 0;" for r in regs] + [f"int32_t h{k} = 0;"]
        trans.append(emit_c(ir, f"t{k}_", "c", regs, nxt, f"a{k}"))
        hits.append(f"h{k} += a{k};")
        empty.append(f"h{k} += {ir.accept_empty};")
        state += [f"{r} = {x} & keep;" for r, x in zip(regs, nxt)]
        store.append(f"hits[{k}LL * n + lane] = h{k};")

    def block(lines, indent):
        return "\n".join(indent + ln for text in lines
                         for ln in text.splitlines())

    body = (_sections()["walk"]
            .replace("@K@", str(len(irs)))
            .replace("@DECLARE@", block(decl, "    "))
            .replace("@EMPTY@", block(empty, " " * 20))
            .replace("@TRANSITION@", block(trans, " " * 16))
            .replace("@STATE@", block(state, " " * 16))
            .replace("@HITS@", block(hits, " " * 20))
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


def _pending(ir_tuples) -> dict:
    """{tag: tuple} of the tuples of `ir_tuples` not built yet."""
    todo = {}
    for irs in ir_tuples:
        todo.setdefault(tag_of(irs), tuple(irs))
    return {t: irs for t, irs in todo.items() if t not in _registry}


def source(ir_tuples) -> str:
    """The CUDA source `prepare(ir_tuples)` builds (to start its `nvcc` run
    beside others: `build.build_sources`)."""
    return render(list(_pending(ir_tuples).values()))


def prepare(ir_tuples) -> None:
    """Builds one library holding a kernel for every tuple not built yet
    (one nvcc run) and registers their launch functions."""
    todo = _pending(ir_tuples)
    if not todo:
        return
    lib = build.load_source(render(list(todo.values())))
    for tag in todo:
        fn = getattr(lib, f"dpq_stream_launch_{tag}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _registry[tag] = fn


def chunk_stream(stream: torch.Tensor) -> torch.Tensor:
    """The [steps, n] u8 stream (lane j's bytes down column j) in the
    kernel's layout: [ceil(steps / 16), n, 16], chunk c of lane j holding
    the lane's bytes [16 c, 16 c + 16), zero-padded past `steps`."""
    steps, n = stream.shape
    chunks = -(-steps // CHUNK)
    if chunks * CHUNK != steps:
        pad = torch.zeros((chunks * CHUNK - steps, n), dtype=stream.dtype,
                          device=stream.device)
        stream = torch.cat([stream, pad])
    return stream.reshape(chunks, CHUNK, n).permute(0, 2, 1).contiguous()


def unchunk_stream(chunked: torch.Tensor,
                   steps: int | None = None) -> torch.Tensor:
    """The [steps, n] stream of a `chunk_stream` layout (`steps` defaults
    to all chunks * 16 bytes)."""
    chunks, n, width = chunked.shape
    stream = chunked.permute(0, 2, 1).reshape(chunks * width, n)
    return (stream if steps is None else stream[:steps]).contiguous()


def match_stream_plain(payload_t, plen, nn, irs, steps: int | None = None):
    """The plain PyTorch version, over the [steps, n] u8 stream:
    (hits [K, n] int32, seen [n] int32)."""
    hits, seen = strings.match_payload_multi(payload_t, plen, nn, irs, steps)
    return torch.stack(hits), seen


def match_stream(chunked: torch.Tensor, plen: torch.Tensor,
                 nn: torch.Tensor, irs, steps: int | None = None):
    """K register-machine patterns over the byte stream `chunked`
    ([chunks, n, 16] u8, the layout `chunk_stream` makes: lane j's raw
    value section in chunks [:, j, :]), walking at most `steps` bytes.
    Returns (hits [K, n] int32, seen [n] int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    irs = tuple(irs)
    dev = chunked.device
    if (chunked.dtype != torch.uint8 or chunked.dim() != 3
            or chunked.shape[2] != CHUNK):
        raise ValueError(f"the stream must be a uint8 tensor [chunks, n, "
                         f"{CHUNK}]")
    chunks, n, _ = chunked.shape
    steps = chunks * CHUNK if steps is None else min(int(steps),
                                                     chunks * CHUNK)
    if dev.type == "cpu":
        return match_stream_plain(unchunk_stream(chunked, steps), plen, nn,
                                  irs, steps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{dev} is not the current CUDA device")
    if not chunked.is_contiguous():
        raise ValueError("the stream must be contiguous")
    for name, t in (("plen", plen), ("nn", nn)):
        if (t.device != dev or t.dtype != torch.int32 or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [{n}] "
                             f"tensor on {dev}")
    if not irs:
        raise ValueError("match_stream needs at least one pattern")
    hits = torch.empty((len(irs), n), dtype=torch.int32, device=dev)
    seen = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return hits, seen
    tag = tag_of(irs)
    if tag not in _registry:
        prepare([irs])
    rc = _registry[tag](chunked.data_ptr(), n, steps, plen.data_ptr(),
                        nn.data_ptr(), hits.data_ptr(), seen.data_ptr(),
                        THREADS, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stream matcher launch failed: cudaError {rc}")
    launches += 1
    return hits, seen
