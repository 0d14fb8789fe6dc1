"""K2 — dictionary lookup as a CUDA kernel for Hopper.

Replaces the TPU kernel `duckdb_parquet_parser_tpu/ops/pallas/
dict_lookup.py::_kernel` (via `_lookup_call` / `dict_lookup_pallas`):
`out[p] = planes[p][gidx]`.  On the scan's path it maps each dictionary
page's per-value indices to the per-entry accept bits of the pattern
(ops/scan.map_dict_accepts).

What bounds it on the H100: it is a gather, so memory traffic (4 bytes of
index in, 4 bytes per plane out) and the latency of the table reads.  The
TPU built it as a one-hot bf16 matmul on the MXU to avoid slow gathers;
here a gather is native.  Each thread produces one output position,
reading the table through `__ldg`.  (Staging the table in shared memory
per block was measured on the H100 and was never faster, up to 2x slower
at 2.5M cells; see PERF.md.)  On CUDA
every lookup goes through the kernel whatever DN is: the reference's DN
thresholds (select below 513, MXU up to 8192, XLA gather beyond) were TPU
cost choices with identical outputs, and its select paths
(`dict_lookup_select`, `dict_lookup_local`) are cost variants of the same
gather, so the plain version below stands for them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0  # kernel launches (one per call that reaches the card)


@functools.lru_cache(maxsize=1)
def _fn():
    lib = build.load_source(build.read_csrc("dict_lookup.cu"))
    fn = lib.dpq_dict_lookup
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def prepare() -> None:
    """Builds and loads the kernel library (first use does it otherwise)."""
    _fn()


def dict_lookup_plain(planes, gidx: torch.Tensor) -> list[torch.Tensor]:
    """The plain PyTorch version: [plane[gidx] for plane in planes]."""
    idx = gidx.long()
    return [p[idx] for p in planes]


def dict_lookup(planes, gidx: torch.Tensor) -> list[torch.Tensor]:
    """Looks `gidx` [N, V] int32 (pre-clipped to [0, DN)) up in each of
    `planes` (1-D int32 [DN] tensors); returns one [N, V] int32 tensor per
    plane.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    global launches
    planes = list(planes)
    if not planes:
        return []
    dev = gidx.device
    if dev.type == "cpu":
        return dict_lookup_plain(planes, gidx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    dn = planes[0].shape[0]
    for p in planes:
        if (p.device != dev or p.dtype != torch.int32 or p.shape != (dn,)):
            raise ValueError(f"planes must be int32 [{dn}] tensors on {dev}")
    if gidx.dtype != torch.int32 or gidx.dim() != 2:
        raise ValueError("gidx must be a 2-D int32 tensor")
    if not gidx.is_contiguous():
        raise ValueError("gidx must be contiguous")
    if dn < 1:
        raise ValueError("the dictionary table is empty")
    table = torch.stack(planes).contiguous()
    n, v = gidx.shape
    out = torch.empty((len(planes), n, v), dtype=torch.int32, device=dev)
    m = n * v
    if m == 0:
        return list(out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(table.data_ptr(), len(planes), dn, gidx.data_ptr(), m,
                   out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dict lookup launch failed: cudaError {rc}")
    launches += 1
    return list(out)
