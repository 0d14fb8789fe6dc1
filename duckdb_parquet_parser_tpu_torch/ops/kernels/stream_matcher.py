"""K1 — the streaming regex matcher as a CUDA kernel for Hopper.

Replaces the TPU kernel `duckdb_parquet_parser_tpu/ops/pallas/
stream_matcher.py::_build_call` (bodies `kernel`, `kernel1`, `kernel_sb`):
every PLAIN byte of every query goes through it.  One CUDA kernel serves
the contracts of all three TPU bodies (single pattern, K fused patterns,
and the split layout's short segment lanes); the TPU's tiled layout, lane
tiles, stream counts and step blocks existed for its vector memory and
sublane packing and are not ported.

What bounds it on the H100: operations.  Each lane is a sequential walk
whose per-byte cost is the dependent int32 chain of the transition, while
every byte of the resident stream is read once.  So the design keeps every
load and the value-boundary control out of that chain: the stream is
resident in 16-byte chunks, `[chunks, n, 16]` u8 (`chunk_stream`), one
thread per lane reads 16 bytes of its own lane in one load (a warp reads
512 neighbouring bytes) and holds chunks i to i + 2 in registers; the value
boundaries of a chunk (accept, count, the next length prefix, the reset)
are worked out once a value, as two masks of the chunk's bytes, and the
chunk's 16 steps are unrolled, each the transition, an AND that keeps or
resets the state and the accept where a value ends.  Every register
machine lives in registers, the transitions are emitted as straight-line C
from the traced IR (ops/bitprog.emit_c), and a lane stops after its last
value that ends inside the walk (lanes arrive sorted by length, so a warp's
lanes end together).

Of that chain, the half that reads only the byte (a Q13 pattern's bit
tests, selects and ANDs: 22 of its 39 IR nodes) is a table: its values
where it meets the state half (`bitprog.byte_frontier`, one mask word a
pattern in every cell) are evaluated at the 256 byte values on the host and
emitted as a static array of the tuple, which each block copies into shared
memory once; a byte step reads its word(s), one load each indexed by the
byte, and computes the state half alone.  The loads depend on the bytes
alone, and chunk i + 1 is in registers while chunk i is walked, so chunk
i + 1's loads are issued before chunk i's walk and held in registers: they
stay off the state's chain, and what bounds K1 is the state half's
operations and the byte's extraction and control.  A tuple of more than
TABLE_WORDS words keeps its byte half computed (`table_words` says which;
`table_launches` counts the launches that read a table, and so does the
program counter `k1_table_launches` while a profiler records).

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
from ...utils import tracing
from ..bitprog import TransitionIR, byte_frontier, byte_table, emit_c
from . import build

launches = 0        # kernel launches (one per call that reaches the card)
table_launches = 0  # of them, those whose byte half came from the table

CHUNK = 16    # bytes of one lane that lie together in the resident stream
THREADS = 64  # lanes per block: small blocks spread evenly over the SMs
# most words a byte of a tuple's byte-half table; a tuple with more keeps
# its byte half computed.  The walk holds two chunks' words, 32 registers a
# word, beside the ~48 of the rest of the walk, within 255 a thread (no
# pattern of the benchmark comes near: one word a pattern)
TABLE_WORDS = 6

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
def _walk(irs: tuple[TransitionIR, ...]) -> tuple[str, str, int]:
    """(tag, table and walk sections' source with @TAG@ still open, words
    of the byte half's table a byte: 0 where the byte half is computed) for
    one pattern tuple; the tag hashes both sections."""
    fronts = [byte_frontier(ir) for ir in irs]
    words = sum(map(len, fronts))
    if words > TABLE_WORDS:
        words = 0
    decl, trans, hits, empty, state, store = [], [], [], [], [], []
    reg = w = 0
    for k, (ir, front) in enumerate(zip(irs, fronts)):
        regs = [f"r{reg + j}" for j in range(ir.n_regs)]
        nxt = [f"n{reg + j}" for j in range(ir.n_regs)]
        reg += ir.n_regs
        inputs = None
        if words:
            inputs = {i: f"tw[{16 * (w + f)} + j]" if w + f else "tw[j]"
                      for f, i in enumerate(front)}
            w += len(front)
        decl += [f"int32_t {r} = 0;" for r in regs] + [f"int32_t h{k} = 0;"]
        trans.append(emit_c(ir, f"t{k}_", "c", regs, nxt, f"a{k}", inputs))
        hits.append(f"h{k} += a{k};")
        empty.append(f"h{k} += {ir.accept_empty};")
        state += [f"{r} = {x} & keep;" for r, x in zip(regs, nxt)]
        store.append(f"hits[{k}LL * n + lane] = h{k};")

    def block(lines, indent):
        return "\n".join(indent + ln for text in lines
                         for ln in text.splitlines())

    sec = _sections()
    body = sec["walk"]
    for slot in ("table_first", "table_next", "table_shift"):
        body = body.replace(f"@{slot.upper()}@\n", sec[slot] if words else "")
    body = (body.replace("@WORDS@", str(words))
            .replace("@TABLE_PARAM@", ",\n    const int32_t* __restrict__ tab"
                     if words else "")
            .replace("@K@", str(len(irs)))
            .replace("@DECLARE@", block(decl, "    "))
            .replace("@EMPTY@", block(empty, " " * 20))
            .replace("@TRANSITION@", block(trans, " " * 16))
            .replace("@STATE@", block(state, " " * 16))
            .replace("@HITS@", block(hits, " " * 20))
            .replace("@STORE@", block(store, "    ")))
    if words:
        table = torch.cat([byte_table(ir) for ir in irs]).reshape(-1, 16)
        values = ",\n".join("    " + ", ".join(map(str, row))
                            for row in table.tolist())
        body = (sec["table"].replace("@WORDS@", str(words))
                .replace("@VALUES@", values) + body)
    tag = hashlib.sha1(body.encode()).hexdigest()[:12]
    return tag, body, words


def render(ir_tuples, host: bool = False) -> str:
    """The full source for the given pattern tuples: CUDA kernels and
    launch functions, or (`host=True`) plain C++ host loops over the same
    walk, which the CPU tests compile with g++."""
    sec = _sections()
    walks = {}
    for irs in ir_tuples:
        tag, body, words = _walk(tuple(irs))
        walks[tag] = (body, words)
    parts = [sec["prelude"]]
    parts += [body.replace("@TAG@", t) for t, (body, _w) in walks.items()]
    if not host:
        parts.append(sec["kernel_prelude"])
    for tag, (_body, words) in walks.items():
        if host:
            text = sec["host"].replace(
                "@TABLE_ARG@", ", dpq_table_@TAG@" if words else "")
        else:
            text = (sec["kernel"]
                    .replace("@STAGE@", sec["stage"].rstrip("\n")
                             if words else "")
                    .replace("@TABLE_ARG@", ", tab" if words else ""))
        parts.append(text.replace("@WORDS@", str(words))
                     .replace("@TAG@", tag))
    return "".join(parts)


def table_words(irs) -> int:
    """Words of the byte half's table a byte for the pattern tuple `irs`;
    0 where its kernel computes the byte half."""
    return _walk(tuple(irs))[2]


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
    global launches, table_launches
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
    if table_words(irs):
        table_launches += 1
        tracing.count("k1_table_launches")
    return hits, seen
