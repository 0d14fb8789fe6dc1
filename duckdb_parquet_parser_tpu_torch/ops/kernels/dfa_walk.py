"""K3 — the table-DFA walk as a CUDA kernel for Hopper, two entry points.

Replaces the JAX package's device walk of every pattern outside the
register-machine family: `duckdb_parquet_parser_tpu/ops/mxu_dfa.py::
make_transition` inside the `lax.scan` of `ops/strings.py::
_match_stream_multi` (the page walk), and the `lax.scan` of
`ops/scan.py::dfa_match` (the per-value walk).  There was no Pallas kernel
there; the matrix-unit one-hot only avoided that machine's slow gathers, and
is not carried over.  The route is: one program on the device, in place of
a Python loop of PyTorch ops (about 40 launches a byte step).

* `stream_walk` — the page walk over the resident stream in K1's chunked
  layout (`stream_matcher.chunk_stream`); (hits [n], seen [n]) int32, what
  `strings.match_payload_stream` returns.
* `value_walk` — the per-value walk over a [L, P] u8 pad_strings matrix;
  [L] bool accepts, what `ops/scan.dfa_match` returns.

What bounds them on the H100 (see `csrc/dfa_walk.cu`): the bytes they read
and the table's loads, one a byte on a dependent chain.  The page walk
walks each 16-byte chunk of a lane unrolled, predicated on the bytes that
lie in the value, and handles a value boundary once a value; the per-value
walk loads a 64-byte window of a row ahead of the one it walks.  Both run
one grid of the blocks the SMs hold.  The transition table is data
(`pack_table`: a byte -> class map and a [S, C] uint16 table whose entries
carry the next state and its accept bit), so one `nvcc` run serves every
pattern and a new pattern's first query builds nothing.  A launch stages
the table in shared memory while that keeps the kernel more than half its
resident blocks (`stages`) and reads it from device memory otherwise; a
staged table of up to `FOLD_MAX_STATES` states is folded into a
byte-indexed one (one load a byte; `table_mode`).  The variants are one
walk.

CPU tensors take the plain versions (`stream_walk_plain`, `value_walk_plain`);
CUDA tensors launch the kernel or raise.  Both entries share `launches`.
The kernels they replaced stay as yardsticks (`stream_walk_bytewise`,
`value_walk_rowwise`): no route calls them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from .. import strings
from . import build
from .stream_matcher import CHUNK, unchunk_stream

launches = 0  # kernel launches of either entry (one per call on the card)

MAX_STATES = 1 << 15  # an entry holds the next state in 15 bits
# The folded table (csrc/dfa_walk.cu): a row of 257 words a state (the next
# rows' addresses for the 256 bytes, and the accept), at most 64 states
# (65,792 bytes).
FOLD_ROW_BYTES = 1028
FOLD_MAX_STATES = 64
# the walks' table modes, as csrc/dfa_walk.cu numbers them
FOLDED, PACKED_SHARED, PACKED_GLOBAL = 0, 1, 2
MODE_NAMES = {FOLDED: "folded table in shared memory",
              PACKED_SHARED: "packed table in shared memory",
              PACKED_GLOBAL: "packed table in device memory"}

_device_tables: OrderedDict = OrderedDict()  # key -> (packed, tensor)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = build.load_source(build.read_csrc("dfa_walk.cu"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dpq_dfa_stream.argtypes = [vp, ctypes.c_longlong, i, vp, vp, vp, i, i,
                                   i, i, i, i, vp, vp, vp]
    lib.dpq_dfa_stream.restype = i
    lib.dpq_dfa_stream_bytewise.argtypes = [vp, ctypes.c_longlong, i, vp, vp,
                                            vp, i, i, i, i, vp, vp, vp]
    lib.dpq_dfa_stream_bytewise.restype = i
    lib.dpq_dfa_values.argtypes = [vp, ctypes.c_longlong, i, vp, vp, i, i, i,
                                   i, i, i, vp, vp]
    lib.dpq_dfa_values.restype = i
    lib.dpq_dfa_values_rowwise.argtypes = [vp, ctypes.c_longlong, i, vp, vp,
                                           i, i, i, i, vp, vp]
    lib.dpq_dfa_values_rowwise.restype = i
    lib.dpq_dfa_blocks_per_sm.argtypes = [i, i]
    lib.dpq_dfa_blocks_per_sm.restype = i
    return lib


def prepare() -> None:
    """Builds and loads the kernel library (first use does it otherwise)."""
    _lib()


def walk_code(values: bool, folded: bool) -> int:
    """csrc/dfa_walk.cu's number of a walk and its staged table: the page
    walk with the packed (0) or folded (3) table, the per-value walk with
    the folded (1) or packed (2) one."""
    if values:
        return 1 if folded else 2
    return 3 if folded else 0


@functools.lru_cache(maxsize=None)
def blocks_per_sm(device_index: int, walk: int, staged_bytes: int) -> int:
    """Blocks one SM of CUDA device `device_index` (the current device)
    holds at once of the walk numbered `walk` (`walk_code`), `staged_bytes`
    of its table in shared memory (0: the variant that reads the packed
    table from device memory)."""
    return _lib().dpq_dfa_blocks_per_sm(walk, staged_bytes)


@functools.lru_cache(maxsize=None)
def stages(device_index: int, values: bool, table_bytes: int,
           folded: bool = False) -> bool:
    """Whether a launch on CUDA device `device_index` (the current device)
    stages a table of `table_bytes` in shared memory: where the staged
    variant of the walk (`values`: the per-value walk, else the page walk;
    its staged table `folded` or packed) keeps more than half the blocks an
    SM that the device-memory variant holds.  Every block copies the whole
    table, and a table that costs more blocks leaves too few warps to hide
    the walk's latency (`utils/probe_dfa_walk.py`; PERF.md, K3).  The page
    walk's block of up to 1,024 threads holds an SM alone in either
    variant, so it stages every table that fits."""
    walk = walk_code(values, folded)
    return (2 * blocks_per_sm(device_index, walk, table_bytes)
            > blocks_per_sm(device_index, walk, 0))


def table_mode(packed: "PackedTable", device_index: int, values: bool,
               staged: bool | None = None) -> tuple[int, int]:
    """(mode, bytes of the table in shared memory) of a walk (`values`: the
    per-value walk, else the page walk) under `packed` on CUDA device
    `device_index`: staged, the table is folded where it has at most
    `FOLD_MAX_STATES` states and packed otherwise; `staged` None stages it
    by `stages`."""
    folded = packed.n_states <= FOLD_MAX_STATES
    nbytes = (-(-FOLD_ROW_BYTES * packed.n_states // 16) * 16 if folded
              else len(packed.data))
    if staged is None:
        staged = stages(device_index, values, nbytes, folded)
    if not staged:
        return PACKED_GLOBAL, 0
    return (FOLDED if folded else PACKED_SHARED), nbytes


def value_mode(packed: "PackedTable", device_index: int,
               staged: bool | None = None) -> tuple[int, int]:
    """`table_mode` of the per-value walk."""
    return table_mode(packed, device_index, True, staged)


@functools.lru_cache(maxsize=None)
def grid(device_index: int, values: bool, mode: int, staged_bytes: int) -> int:
    """The grid of a walk (`values`: the per-value walk, else the page
    walk) in table mode `mode`: the blocks the device's SMs hold at once."""
    return (torch.cuda.get_device_properties(device_index).multi_processor_count
            * blocks_per_sm(device_index, walk_code(values, mode == FOLDED),
                            staged_bytes))


@dataclass(frozen=True)
class PackedTable:
    """A DFA in the kernel's layout: `data` holds the 256-byte class map,
    then the [n_states, n_classes] uint16 entries (bits 0-14 the next
    state, bit 15 its accept), zero-padded to a multiple of 16 bytes."""

    data: np.ndarray  # u8
    n_states: int
    n_classes: int
    accept0: int      # the accept of the empty string (state 0)


def pack_table(dfa) -> PackedTable:
    """The kernel's layout of `dfa` (ops/regex.DFA), over its byte classes
    (`DFA.byte_classes`, the compression `mxu_dfa.py` uses)."""
    bc = dfa.byte_classes()
    n_states, n_classes = bc.table.shape
    if n_states > MAX_STATES:
        raise ValueError(f"the DFA has {n_states} states; K3 takes at most "
                         f"{MAX_STATES}")
    accept = np.asarray(dfa.accept, dtype=bool)
    entry = (bc.table.astype(np.uint16)
             | (accept[bc.table].astype(np.uint16) << 15))
    raw = np.concatenate([bc.class_of.astype(np.uint8),
                          entry.astype("<u2").reshape(-1).view(np.uint8)])
    pad = -len(raw) % 16
    data = np.concatenate([raw, np.zeros(pad, np.uint8)]) if pad else raw
    return PackedTable(data, int(n_states), int(n_classes), int(accept[0]))


def _device_table(dfa, dev: torch.device):
    """(packed table, its tensor on `dev`); the last few tables stay there,
    keyed by the automaton's bytes, so a repeated query uploads nothing."""
    table = np.ascontiguousarray(dfa.table, dtype=np.int32)
    accept = np.ascontiguousarray(dfa.accept, dtype=bool)
    key = (hashlib.sha1(table.tobytes() + accept.tobytes()).hexdigest(),
           table.shape, str(dev))
    hit = _device_tables.get(key)
    if hit is None:
        packed = pack_table(dfa)
        hit = (packed, torch.from_numpy(packed.data).to(dev))
        _device_tables[key] = hit
        while len(_device_tables) > 16:
            _device_tables.popitem(last=False)
    _device_tables.move_to_end(key)
    return hit


def _check_cuda(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{dev} is not the current CUDA device")


def _check_int32(name: str, t: torch.Tensor, dev, n: int) -> None:
    if (t.device != dev or t.dtype != torch.int32 or t.shape != (n,)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [{n}] tensor on "
                         f"{dev}")


# ── the page walk ───────────────────────────────────────────────────────────


def stream_walk_plain(payload_t, plen, nn, dfa, steps: int | None = None):
    """The plain PyTorch version over the [steps, n] u8 stream: one byte
    step a loop iteration (`strings.match_stream_multi` with the table
    gathers of `strings.dfa_spec`).  (hits [n] int32, seen [n] int32)."""
    return strings.match_payload_stream(payload_t, plen, nn, dfa.table,
                                        dfa.accept, steps)


def _check_stream(chunked, plen, nn, steps):
    """(device, lanes, steps walked at most) of a page walk's arguments."""
    dev = chunked.device
    if (chunked.dtype != torch.uint8 or chunked.dim() != 3
            or chunked.shape[2] != CHUNK):
        raise ValueError(f"the stream must be a uint8 tensor [chunks, n, "
                         f"{CHUNK}]")
    chunks, n, _ = chunked.shape
    steps = chunks * CHUNK if steps is None else min(int(steps),
                                                     chunks * CHUNK)
    if dev.type == "cpu":
        return dev, n, steps
    _check_cuda(dev)
    if not chunked.is_contiguous():
        raise ValueError("the stream must be contiguous")
    _check_int32("plen", plen, dev, n)
    _check_int32("nn", nn, dev, n)
    return dev, n, steps


def stream_walk(chunked: torch.Tensor, plen: torch.Tensor, nn: torch.Tensor,
                dfa, steps: int | None = None, *, staged: bool | None = None):
    """The table DFA of `dfa` over the byte stream `chunked` ([chunks, n,
    16] u8, `stream_matcher.chunk_stream`'s layout), walking at most `steps`
    bytes of each lane: the 4-byte length prefixes, then the value bytes;
    at each value's end the lane adds its accept.  Returns (hits [n] int32,
    seen [n] int32).  `staged` forces a variant (True: the table in shared
    memory, folded where `table_mode` folds it; False: the packed table in
    device memory); None picks one (`stages`).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    dev, n, steps = _check_stream(chunked, plen, nn, steps)
    if dev.type == "cpu":
        return stream_walk_plain(unchunk_stream(chunked, steps), plen, nn,
                                 dfa, steps)
    hits = torch.empty((n,), dtype=torch.int32, device=dev)
    seen = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return hits, seen
    packed, table = _device_table(dfa, dev)
    mode, nbytes = table_mode(packed, dev.index, False, staged)
    rc = _lib().dpq_dfa_stream(
        chunked.data_ptr(), n, steps, plen.data_ptr(), nn.data_ptr(),
        table.data_ptr(), table.numel(), packed.n_states, packed.n_classes,
        packed.accept0, mode, grid(dev.index, False, mode, nbytes),
        hits.data_ptr(), seen.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"table-DFA stream walk launch failed: cudaError "
                           f"{rc}")
    launches += 1
    return hits, seen


def stream_walk_bytewise(chunked: torch.Tensor, plen: torch.Tensor,
                         nn: torch.Tensor, dfa, steps: int | None = None, *,
                         staged: bool = True):
    """The one-thread-a-lane byte loop that `stream_walk`'s kernel
    replaced, on CUDA tensors only, the packed table staged in each 64-lane
    block (`staged`) or read from device memory: the yardstick
    `chip_smoke.py` and `utils/probe_stream_walk.py` time `stream_walk`
    against.  No route calls it, and it counts no launch."""
    dev, n, steps = _check_stream(chunked, plen, nn, steps)
    _check_cuda(dev)
    hits = torch.empty((n,), dtype=torch.int32, device=dev)
    seen = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return hits, seen
    packed, table = _device_table(dfa, dev)
    rc = _lib().dpq_dfa_stream_bytewise(
        chunked.data_ptr(), n, steps, plen.data_ptr(), nn.data_ptr(),
        table.data_ptr(), table.numel(), packed.n_classes, packed.accept0,
        int(staged), hits.data_ptr(), seen.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bytewise stream walk launch failed: cudaError "
                           f"{rc}")
    return hits, seen


# ── the per-value walk ──────────────────────────────────────────────────────


def value_walk_plain(chars: torch.Tensor, lens: torch.Tensor, dfa):
    """The plain PyTorch version: one column of `chars` a loop iteration,
    `state = table[state, c]` where the value is still long enough.
    Returns [L] bool accepts."""
    dev = chars.device
    tflat = torch.as_tensor(np.asarray(dfa.table, dtype=np.int32)).reshape(
        -1).to(dev)
    acc = torch.as_tensor(np.asarray(dfa.accept, dtype=bool)).to(dev)
    state = torch.zeros(chars.shape[0], dtype=torch.int32, device=dev)
    for j in range(chars.shape[1]):
        nxt = tflat[(state * 256 + chars[:, j].to(torch.int32)).long()]
        state = torch.where(j < lens, nxt, state)
    return acc[state.long()]


def _check_values(chars: torch.Tensor, lens: torch.Tensor):
    dev = chars.device
    _check_cuda(dev)
    if not chars.is_contiguous():
        raise ValueError("chars must be contiguous")
    count = chars.shape[0]
    _check_int32("lens", lens, dev, count)
    return dev, count, chars.shape[1]


def value_walk(chars: torch.Tensor, lens: torch.Tensor, dfa, *,
               staged: bool | None = None) -> torch.Tensor:
    """The accept of each value of `chars` ([L, P] u8, one zero-padded row
    a value) under `dfa`, after its first min(lens[v], P) bytes; lens: [L]
    int32.  Returns [L] bool.  `staged` as for `stream_walk` (`value_mode`
    says which table a staged walk holds).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global launches
    if chars.dtype != torch.uint8 or chars.dim() != 2:
        raise ValueError("chars must be a 2-D uint8 tensor")
    if chars.device.type == "cpu":
        return value_walk_plain(chars, lens, dfa)
    dev, count, pitch = _check_values(chars, lens)
    out = torch.empty((count,), dtype=torch.bool, device=dev)
    if count == 0:
        return out
    packed, table = _device_table(dfa, dev)
    mode, nbytes = value_mode(packed, dev.index, staged)
    rc = _lib().dpq_dfa_values(
        chars.data_ptr(), count, pitch, lens.data_ptr(), table.data_ptr(),
        table.numel(), packed.n_states, packed.n_classes, packed.accept0,
        mode, grid(dev.index, True, mode, nbytes), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"table-DFA value walk launch failed: cudaError "
                           f"{rc}")
    launches += 1
    return out


def value_walk_rowwise(chars: torch.Tensor, lens: torch.Tensor, dfa, *,
                       staged: bool = True) -> torch.Tensor:
    """The one-thread-a-value walk that `value_walk`'s kernel replaced,
    on CUDA tensors only: the yardstick `chip_smoke.py` and
    `utils/probe_value_walk.py` time `value_walk` against.  No route calls
    it, and it counts no launch."""
    if chars.dtype != torch.uint8 or chars.dim() != 2:
        raise ValueError("chars must be a 2-D uint8 tensor")
    dev, count, pitch = _check_values(chars, lens)
    out = torch.empty((count,), dtype=torch.bool, device=dev)
    if count == 0:
        return out
    packed, table = _device_table(dfa, dev)
    rc = _lib().dpq_dfa_values_rowwise(
        chars.data_ptr(), count, pitch, lens.data_ptr(), table.data_ptr(),
        table.numel(), packed.n_classes, packed.accept0, int(staged),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row-wise value walk launch failed: cudaError "
                           f"{rc}")
    return out
