"""Probe of what one launch through a wrapper costs on the host, over time.

Both entries of the dictionary kernel (`ops/kernels/dict_lookup.py`) take
microseconds on the device at the scan's shapes, so a call costs what the
host spends on it: the argument checks, two `torch.empty` and one ctypes
launch.  That cost is not steady.  This probe times `dict_count` and
`dict_lookup` at the resident scan's shape (784 pages x 512 values, a
6,000-entry dictionary) beside a bare `torch.empty` and one elementwise
`add`, once a second, and prints with every sample the share of a core
the process had while it was timed (CPU seconds over wall seconds of
the timed loops, which never sleep).  It samples a fresh process, then
again after one and after six `torch.profiler` sessions, after a pass of
large allocations, and after `torch.cuda.empty_cache()`, so that a cost
that comes from any of those states shows beside one that comes and goes
by itself.

Usage: python3 -m duckdb_parquet_parser_tpu_torch.utils.probe_launch_cost
(needs one CUDA device and `nvcc`; builds the dictionary kernels into
build/torch_kernels/).
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ..ops.kernels import dict_lookup

PAGES, VMAX, DN = 784, 512, 6000
REPS = 200


def _ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _inputs(device):
    g = torch.Generator().manual_seed(11)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g).to(dtype).to(device)

    count_args = (
        ints(-1, 1500, (PAGES, VMAX)),                  # idx_vals
        ints(0, 2, (PAGES, VMAX), torch.uint8),         # def_levels
        ints(1, VMAX + 1, (PAGES,)),                    # num_values
        torch.ones(PAGES, dtype=torch.int32, device=device),   # page_kind
        ints(0, 4, (PAGES,)) * 1500,                    # dict_base
        torch.full((PAGES,), 1500, dtype=torch.int32, device=device),
        ints(0, 2, (1, DN), torch.uint8))               # accept table
    planes = ints(0, 1 << 20, (1, DN))
    gidx = ints(0, DN, (PAGES, VMAX))
    return count_args, planes, gidx


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_launch_cost: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    dict_lookup.prepare()
    count_args, planes, gidx = _inputs(device)
    kw = dict(vmax=VMAX, max_def=1, negate=False)
    fns = {
        "dict_count": lambda: dict_lookup.dict_count(*count_args, **kw),
        "dict_lookup": lambda: dict_lookup.dict_lookup(planes, gidx),
        "torch.empty": lambda: torch.empty((1, PAGES), dtype=torch.int32,
                                           device=device),
        "add": lambda: planes.add(1)}
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"ms per call, CUDA events around {REPS} calls", flush=True)

    def sample(label: str, n: int):
        for i in range(n):
            c0, w0 = os.times(), time.perf_counter()
            t = {name: _ms(fn) for name, fn in fns.items()}
            c1, w1 = os.times(), time.perf_counter()
            share = (c1.user + c1.system - c0.user - c0.system) / (w1 - w0)
            print(f"{label} +{i}s: " + ", ".join(
                f"{name} {ms:.4f}" for name, ms in t.items())
                + f" ms; {share:.2f} of a core", flush=True)
            time.sleep(1)

    def session():
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for fn in fns.values():
                fn()
            torch.cuda.synchronize()
        prof.key_averages()

    sample("fresh process", 8)
    session()
    sample("after 1 profiler session", 8)
    for _ in range(6):
        session()
    sample("after 6 more sessions", 8)
    held = [torch.empty((64 << 20,), dtype=torch.uint8, device=device)
            for _ in range(16)]
    del held
    st = torch.cuda.memory_stats()
    print(f"allocator: {st['reserved_bytes.all.current'] >> 20} MiB reserved "
          f"in {st['segment.all.current']} segments", flush=True)
    sample("after 1 GiB of allocations", 8)
    torch.cuda.empty_cache()
    sample("after empty_cache", 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
