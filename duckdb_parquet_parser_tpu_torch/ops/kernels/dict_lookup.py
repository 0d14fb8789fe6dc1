"""K2 — dictionary lookup as a CUDA kernel for Hopper, two entry points.

Replaces the TPU kernel `duckdb_parquet_parser_tpu/ops/pallas/
dict_lookup.py::_kernel` (via `_lookup_call` / `dict_lookup_pallas`):
`out[p] = planes[p][gidx]`, done there as a one-hot bf16 limb matmul
because gathers are slow on that machine.

What bounds it on the H100: bytes and launches, never operations.  The
work is a gather plus a row sum, far below the card's ridge, and at the
scan's shapes (a few hundred thousand cells) one launch costs more than
the bytes it moves.  So the design moves fewer bytes through fewer
launches:

* `dict_count` — the scan's entry.  One launch per page bucket computes
  what the scan step needs of its dictionary pages: the per-page count of
  accepted values for each of K patterns, and the per-page count of
  participating values.  It reads the resident planes as they lie
  (`idx_vals` int32, `def_levels` uint8) with 16-byte loads, gathers the
  patterns' accepts from a [K, DN] byte table that sits in L1, reduces in
  the warp, and writes K + 1 integers per page.  The [N, V] index, mask
  and accept planes of the unfused step never reach device memory.
* `dict_lookup` — the gather entry, `out[p] = planes[p][gidx]`, for
  callers that need the looked-up plane itself (the run-expansion route
  of the scan; value decode later).  One thread per output position,
  table through `__ldg`.  (Staging the table in shared memory per block
  was measured on the H100 and was never faster; see PERF.md.)  The
  wrapper does no per-call work beyond one allocation and the launch.

Both share `launches`.  On CUDA every call goes through a kernel whatever
DN is: the reference's DN thresholds and its select variants
(`dict_lookup_select`, `dict_lookup_local`) were cost choices of its
machine with identical outputs, so the plain versions below stand for
them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..decode import fit_columns
from ..expand import nonnull_mask
from . import build

launches = 0  # kernel launches of either entry (one per call on the card)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = build.load_source(build.read_csrc("dict_lookup.cu"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dpq_dict_lookup.argtypes = [vp, i, i, vp, ctypes.c_longlong, vp, vp]
    lib.dpq_dict_lookup.restype = i
    lib.dpq_dict_count.argtypes = [vp, i, vp, i, vp, vp, vp, vp, vp, i, i, i,
                                   i, i, i, vp, vp, vp]
    lib.dpq_dict_count.restype = i
    return lib


def prepare() -> None:
    """Builds and loads the kernel library (first use does it otherwise)."""
    _lib()


def _stream(dev: torch.device) -> int:
    """The current stream of `dev`, which must be the current device (the
    kernels launch on the current device)."""
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{dev} is not the current CUDA device")
    return torch.cuda.current_stream().cuda_stream


# ── the gather entry ────────────────────────────────────────────────────────


def dict_lookup_plain(planes, gidx: torch.Tensor):
    """The plain PyTorch version: `plane[gidx]` for each plane."""
    idx = gidx.long()
    if isinstance(planes, torch.Tensor):
        return planes[:, idx]
    return [p[idx] for p in planes]


def dict_lookup(planes, gidx: torch.Tensor):
    """Looks `gidx` [N, V] int32 (pre-clipped to [0, DN)) up in `planes`:
    a [P, DN] int32 tensor, which gives a [P, N, V] int32 tensor, or a
    sequence of P [DN] int32 tensors (stacked here), which gives a list of
    P [N, V] tensors.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global launches
    as_list = not isinstance(planes, torch.Tensor)
    if as_list:
        planes = list(planes)
        if not planes:
            return []
    dev = gidx.device
    if dev.type == "cpu":
        return dict_lookup_plain(planes, gidx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    table = torch.stack(planes) if as_list else planes
    if (table.dim() != 2 or table.dtype != torch.int32 or table.device != dev
            or not table.is_contiguous() or table.shape[1] < 1):
        raise ValueError(f"planes must be contiguous int32 [P, DN >= 1] on "
                         f"{dev}")
    if (gidx.dtype != torch.int32 or gidx.dim() != 2
            or not gidx.is_contiguous()):
        raise ValueError("gidx must be a contiguous 2-D int32 tensor")
    p, dn = table.shape
    n, v = gidx.shape
    out = torch.empty((p, n, v), dtype=torch.int32, device=dev)
    if p * n * v:
        rc = _lib().dpq_dict_lookup(table.data_ptr(), p, dn, gidx.data_ptr(),
                                    n * v, out.data_ptr(), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"dict lookup launch failed: cudaError {rc}")
        launches += 1
    return list(out.unbind(0)) if as_list else out


# ── the scan's entry ────────────────────────────────────────────────────────


def dict_count_plain(idx_vals, def_levels, num_values, page_kind, dict_base,
                     dict_size, table, *, vmax: int, max_def: int,
                     negate: bool):
    """The plain PyTorch version of `dict_count`, with the ops of the
    unfused step: masks, clamp, gather, compare, row sums."""
    if max_def > 0:
        levels = fit_columns(def_levels, vmax, 0).to(torch.int32)
    else:
        levels = torch.zeros((num_values.shape[0], vmax), dtype=torch.int32,
                             device=num_values.device)
    nonnull = nonnull_mask(levels, num_values, max_def, vmax)
    dict_idx = fit_columns(idx_vals, vmax, -1).to(torch.int32)
    ok = (dict_idx >= 0) & (dict_idx < dict_size[:, None])
    valid = ok & nonnull & (page_kind == 1)[:, None]
    dn = table.shape[1]
    g = (dict_base[:, None] + dict_idx.clamp(min=0)).clamp(0, dn - 1)
    accept = table[:, g.long()] != 0                      # [K, N, V]
    counts = ((accept ^ bool(negate)) & valid[None]).sum(2)
    return counts.to(torch.int32), valid.sum(1).to(torch.int32)


def dict_count(idx_vals, def_levels, num_values, page_kind, dict_base,
               dict_size, table, *, vmax: int, max_def: int, negate: bool):
    """Per-page counts of a bucket's dictionary pages for K patterns.

    idx_vals: [N, Vi] int32 value-space dictionary indices (-1 at nulls
    and padding); def_levels: [N, Vd] uint8 definition levels, or None
    when `max_def == 0` (a REQUIRED column: every value is non-null);
    num_values, page_kind, dict_base, dict_size: [N] int32; table: [K, DN]
    uint8, nonzero where pattern k accepts dictionary entry d.  With

        valid[n, v] = v < min(num_values[n], vmax)
                      and def_levels[n, v] == max_def
                      and 0 <= idx_vals[n, v] < dict_size[n]

    (cells outside a stored plane are padding and never valid; an
    out-of-range index is a NULL, not an error) and `g = clamp(dict_base[n]
    + idx_vals[n, v], 0, DN - 1)`, returns

        counts [K, N] int32 = sum_v valid and ((table[k, g] != 0) xor negate)
        values [N] int32    = sum_v valid

    for rows with `page_kind == 1`, and 0 for the other rows.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    global launches
    dev = idx_vals.device
    if max_def > 0 and def_levels is None:
        raise ValueError("max_def > 0 needs the def_levels plane")
    args = dict(vmax=int(vmax), max_def=int(max_def), negate=bool(negate))
    if dev.type == "cpu":
        return dict_count_plain(idx_vals, def_levels, num_values, page_kind,
                                dict_base, dict_size, table, **args)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = idx_vals.shape[0]
    planes = [("idx_vals", idx_vals, torch.int32, 2),
              ("table", table, torch.uint8, 2)]
    planes += [(name, t, torch.int32, 1) for name, t in (
        ("num_values", num_values), ("page_kind", page_kind),
        ("dict_base", dict_base), ("dict_size", dict_size))]
    if max_def > 0:
        planes.append(("def_levels", def_levels, torch.uint8, 2))
    for name, t, dtype, dim in planes:
        if (t.device != dev or t.dtype != dtype or t.dim() != dim
                or not t.is_contiguous()
                or (name != "table" and t.shape[0] != n)):
            raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} "
                             f"tensor on {dev} with {n} rows")
    k, dn = table.shape
    if k < 1 or dn < 1:
        raise ValueError("the accept table is empty")
    counts = torch.empty((k, n), dtype=torch.int32, device=dev)
    values = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return counts, values
    lev_ptr, lev_w = ((def_levels.data_ptr(), def_levels.shape[1])
                      if max_def > 0 else (None, 0))
    rc = _lib().dpq_dict_count(
        idx_vals.data_ptr(), idx_vals.shape[1], lev_ptr, lev_w,
        num_values.data_ptr(), page_kind.data_ptr(), dict_base.data_ptr(),
        dict_size.data_ptr(), table.data_ptr(), k, dn, n, args["vmax"],
        args["max_def"], int(args["negate"]), counts.data_ptr(),
        values.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"dict count launch failed: cudaError {rc}")
    launches += 1
    return counts, values
