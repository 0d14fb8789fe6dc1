"""Probe of where the table-DFA walk keeps its table, on one GPU.

Times both variants of kernel K3 (`ops/kernels/dfa_walk.py`): the table
staged in shared memory (folded up to 64 states), and the packed table read
from device memory, at the main path's shapes (the page walk on the larger
bucket of the resident 2M-row `l_comment` column, the per-value walk on its
`str_padded` matrix), under the tables of a real pattern and of random
automata of 256 byte classes from 16 to 300 states, in alternating rounds,
and prints the least time of each beside the blocks an SM holds and the
variant the wrapper picks (`dfa_walk.stages`). That rule was chosen from
this probe's numbers (PERF.md, K3).

Usage: CXX=g++ python3 -m duckdb_parquet_parser_tpu_torch.utils.probe_dfa_walk
(needs one CUDA device; writes its fixture under build/fixtures/).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..host.batch import to_tensor
from ..models.scan import ScanEngine
from ..ops.kernels import dfa_walk
from ..ops.regex import DFA, compile_pattern
from . import fixtures

ROOT = Path(__file__).resolve().parents[2]
ROWS = 2_000_000
PATTERN = "(furiously|carefully) (express|regular)+ (deposits|requests)"
RANDOM_STATES = (16, 24, 32, 64, 150, 300)


def _ms(fn, reps: int = 10) -> float:
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


def _random_dfa(rng, n_states: int) -> DFA:
    table = rng.integers(0, n_states, (n_states, 256)).astype(np.int32)
    return DFA(table, rng.random(n_states) < 0.4, f"random {n_states}x256")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dfa_walk: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    path = fixtures.lineitem(
        ROOT / "build" / "fixtures" / f"lineitem_{ROWS}.parquet", ROWS)
    eng = ScanEngine(str(path))
    col = eng.resident("l_comment", device="cuda")
    bk = max(col._buckets, key=lambda b: b["stream"].numel())
    batch = eng.reader.prescan("l_comment", pad_strings=8)
    chars = to_tensor(batch.arrays["str_padded"], "cuda")
    lens = to_tensor(batch.arrays["str_lens"], "cuda", dtype=np.int32)
    print(f"card: {card}; page walk over {tuple(bk['stream'].shape)} u8, "
          f"per-value walk over {tuple(chars.shape)} u8", flush=True)
    per_block = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = dfa_walk._lib()
    dev = torch.cuda.current_device()
    rng = np.random.default_rng(7)
    dfas = [compile_pattern(PATTERN)] + [_random_dfa(rng, s)
                                         for s in RANDOM_STATES]
    walks = {
        "page walk": (False, lambda d, st: dfa_walk.stream_walk(
            bk["stream"], bk["walk_plen"], bk["walk_nn"], d, bk["steps"],
            staged=st)),
        "per-value walk": (True, lambda d, st: dfa_walk.value_walk(
            chars, lens, d, staged=st)),
    }
    for label, (values, walk) in walks.items():
        for d in dfas:
            packed = dfa_walk.pack_table(d)
            mode, size = dfa_walk.table_mode(packed, dev, values, staged=True)
            code = dfa_walk.walk_code(values, mode == dfa_walk.FOLDED)
            variants = [False] + [True] * (size <= per_block)
            best = {v: float("inf") for v in variants}
            for _ in range(3):
                for v in variants:
                    best[v] = min(best[v], _ms(lambda: walk(d, v)))
            staged_blocks = lib.dpq_dfa_blocks_per_sm(code, size)
            shared = (f"{best[True]:.4f} ms staged in shared memory "
                      f"({dfa_walk.MODE_NAMES[mode]}, {size} bytes, "
                      f"{staged_blocks} blocks/SM)" if True in best else
                      "too large to stage")
            picked = dfa_walk.table_mode(packed, dev, values)[0]
            print(f"K3 {label}, {d.pattern[:40]!r} table {len(packed.data)} "
                  f"bytes: {best[False]:.4f} ms from device memory "
                  f"({lib.dpq_dfa_blocks_per_sm(code, 0)} blocks/SM), "
                  f"{shared}; the wrapper picks the "
                  f"{dfa_walk.MODE_NAMES[picked]} (least of 3 rounds of 10)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
