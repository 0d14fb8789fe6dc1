"""Probe of kernel K3's per-value walk at the main path's shape, on one GPU.

Times `dfa_walk.value_walk` of the package under `--root` (default: the
checkout this file is in) on `str_padded` of the 2M-row `l_comment` column
under `(furiously|carefully) (express|regular)+ (deposits|requests)`: on
the card alone (the calls queued behind a few ms of other work, so the
host's launch cost hides) and a call (CUDA events around back-to-back
calls), both the least of several rounds; beside it, the page walk
(`stream_walk`) over the larger resident bucket on the card alone.  Every result is checked against `value_walk_plain`.  Run it once a
tree, in turns, to hold two trees against each other in one session on one
card (each tree builds its own kernels under its own `build/`).  `--sweep`
also builds csrc/dfa_walk.cu at 256, 512 and 1,024 threads a block
(DPQ_VALUE_THREADS), all `nvcc` runs at once, and times the wrapper's
variant of each, with its registers; `--ablate` builds it as it is and
without its walk or without its loads of the rows (ABLATIONS) and times
the three; `--sass FILE` writes the per-value kernels' machine code there;
`--diagnose` times the walk on the card alone in set-ups that take one
cost away at a time: a one-state automaton (every lane reads the same
table row), every row the first one (every lane reads the same entry),
and the first sixteenth of the rows (which the 50 MB L2 holds); beside
them, one PyTorch reduction over every byte of the matrix.

Usage: CXX=g++ python3 duckdb_parquet_parser_tpu_torch/utils/probe_value_walk.py
           [--root DIR] [--fixtures DIR] [--rounds N] [--sweep] [--ablate]
           [--sass FILE] [--diagnose]
(needs one CUDA device; prints the card, then one JSON line.)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

PATTERN = "(furiously|carefully) (express|regular)+ (deposits|requests)"
ROWS = 2_000_000


def _ms(fn, reps: int, queued: bool) -> float:
    """ms per call of `fn` over `reps` calls between two CUDA events;
    `queued`: behind three 8192-wide half-precision products, so only
    the device's time is read."""
    import torch

    fn()
    torch.cuda.synchronize()
    if queued:
        a = torch.ones(8192, 8192, device="cuda", dtype=torch.float16)
        b = torch.empty_like(a)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queued:
        for _ in range(3):
            torch.mm(a, a, out=b)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fetch_floor(chars, lens) -> int:
    """Bytes of the 32-byte sectors that hold the walked bytes of each row
    (min(len, pitch) from the row's start): what a walk over the [L, P]
    layout fetches at least."""
    import torch

    pitch = chars.shape[1]
    lim = lens.long().clamp(0, pitch)
    start = chars.data_ptr() + torch.arange(chars.shape[0],
                                            device=lens.device) * pitch
    first, last = start // 32, (start + lim - 1) // 32
    return int(torch.where(lim > 0, last - first + 1, 0).sum()) * 32


def registers(so: Path) -> dict:
    """{kernel: registers} of the per-value kernels in a built library."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import build

    out = subprocess.run([str(build.disassembler()), "-res-usage", str(so)],
                         capture_output=True, text=True, check=True).stdout
    return {m[0][-40:]: int(m[1]) for m in re.findall(
        r"Function (\S*dfa_values_kernel\S*):\s*REG:(\d+)", out)}


def time_builds(texts: dict, chars, lens, dfa, want, rounds: int) -> dict:
    """{label: (ms on the card alone, blocks an SM, registers)} of the
    per-value walk of each source text of `texts`, all built at once; a
    label whose text changes what the walk computes has `want` None there
    (its result is not checked)."""
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import build, dfa_walk

    dev = torch.cuda.current_device()
    paths = dict(zip(texts, build.build_sources(list(texts.values()))))
    packed, table = dfa_walk._device_table(dfa, chars.device)
    mode, nbytes = dfa_walk.value_mode(packed, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(chars.shape[0], dtype=torch.bool, device=chars.device)
    fns, blocks = {}, {}
    for label, text in texts.items():
        lib = build.load_source(text)
        lib.dpq_dfa_values.argtypes = dfa_walk._lib().dpq_dfa_values.argtypes
        lib.dpq_dfa_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        blocks[label] = lib.dpq_dfa_blocks_per_sm(
            2 if mode == dfa_walk.PACKED_SHARED else 1, nbytes)

        def fn(lib=lib, grid=sms * blocks[label]):
            rc = lib.dpq_dfa_values(
                chars.data_ptr(), chars.shape[0], chars.shape[1],
                lens.data_ptr(), table.data_ptr(), table.numel(),
                packed.n_states, packed.n_classes, packed.accept0, mode, grid,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError {rc}")
            return out

        if want[label] is not None and not torch.equal(fn(), want[label]):
            raise AssertionError(f"build {label} differs from the plain walk")
        fns[label] = fn
    best = {label: float("inf") for label in fns}
    for _ in range(rounds):
        for label, fn in fns.items():
            best[label] = min(best[label], _ms(fn, 20, True))
    return {label: (best[label], blocks[label], registers(paths[label]))
            for label in fns}


def sweep(chars, lens, dfa, want, rounds: int) -> dict:
    """The per-value walk built at 256, 512 and 1,024 threads a block."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import build

    src = build.read_csrc("dfa_walk.cu")
    texts = {f"{th} threads": f"#define DPQ_VALUE_THREADS {th}\n" + src
             for th in (256, 512, 1024)}
    return time_builds(texts, chars, lens, dfa, dict.fromkeys(texts, want),
                       rounds)


# Cuts of the per-value kernel that take one cost away each, for the folded
# table the main pattern takes: its walk (each window's bytes are folded
# into one word that picks the state whose accept is read, so the loads
# stay) or its loads of the rows' bytes (it walks zeros; the lengths are
# still read).
ABLATIONS = {
    "loads, no walk": (
        "\n        dpq_walk_window<MODE>(q, lim",
        "\n        st = start + 4 * ((uint32_t)(q[0].lo ^ q[0].hi ^ q[1].lo"
        " ^ q[1].hi ^ q[2].lo ^ q[2].hi ^ q[3].lo ^ q[3].hi) & 255u);"
        "\n        if (0) dpq_walk_window<MODE>(q, lim"),
    "walk, no loads": ("nv < count ? dpq_window_bytes(pitch, nw) : 0", "0"),
}


def ablate(chars, lens, dfa, want, rounds: int) -> dict:
    """The per-value walk as built and under each of ABLATIONS."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import build

    src = build.read_csrc("dfa_walk.cu")
    texts = {"as built": src}
    for label, (old, new) in ABLATIONS.items():
        if src.count(old) != 1:
            raise AssertionError(f"ablation {label!r}: {old!r} is not in the "
                                 "source once")
        texts[label] = src.replace(old, new)
    return time_builds(texts, chars, lens, dfa,
                       {label: want if label == "as built" else None
                        for label in texts}, rounds)


def diagnose(chars, lens, dfa, rounds: int) -> dict:
    """{set-up: ms on the card alone} (see the module's note)."""
    import numpy as np
    import torch

    from duckdb_parquet_parser_tpu_torch.ops.kernels import dfa_walk
    from duckdb_parquet_parser_tpu_torch.ops.regex import DFA

    one = DFA(np.zeros((1, 256), np.int32), np.array([True]), "one state")
    part = chars.shape[0] // 16
    setups = {
        "pattern": (chars, lens, dfa),
        "one state": (chars, lens, one),
        "identical rows": (chars[:1].expand_as(chars).contiguous(), lens,
                           dfa),
        "first sixteenth (x16)": (chars[:part], lens[:part], dfa),
    }
    out: dict = {}
    words = chars.view(torch.int32)
    for _ in range(rounds):
        # a plain read of every byte of chars: what this card's memory
        # gives one pass over the matrix
        ms = _ms(lambda: words.sum(dtype=torch.int32), 20, True)
        out["sum of chars"] = min(out.get("sum of chars", float("inf")), ms)
        for name, (c, ln, d) in setups.items():
            want = dfa_walk.value_walk_plain(c, ln, d)
            scale = 16 if c.shape[0] == part else 1
            if not torch.equal(dfa_walk.value_walk(c, ln, d), want):
                raise AssertionError(f"the walk differs on {name}")
            ms = scale * _ms(lambda: dfa_walk.value_walk(c, ln, d), 20, True)
            out[name] = min(out.get(name, float("inf")), ms)
    return out


def write_sass(path: Path) -> None:
    """The machine code of the per-value kernels of csrc/dfa_walk.cu."""
    from duckdb_parquet_parser_tpu_torch.ops.kernels import build

    so, = build.build_sources([build.read_csrc("dfa_walk.cu")])
    sass = subprocess.run([str(build.disassembler()), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    parts = [p for p in sass.split("Function : ")[1:]
             if "dfa_values_kernel" in p.split()[0]]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join("Function : " + p for p in parts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--fixtures", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sass", default=None)
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_value_walk: no CUDA device", file=sys.stderr)
        return 2
    from duckdb_parquet_parser_tpu_torch.bench import card_line
    from duckdb_parquet_parser_tpu_torch.host.batch import to_tensor
    from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
    from duckdb_parquet_parser_tpu_torch.ops.kernels import dfa_walk
    from duckdb_parquet_parser_tpu_torch.ops.regex import compile_pattern
    from duckdb_parquet_parser_tpu_torch.utils import fixtures

    card = card_line()
    print(f"card: {card}; tree {root}", flush=True)
    fdir = Path(args.fixtures) if args.fixtures else root / "build" / "fixtures"
    path = fixtures.lineitem(fdir / f"lineitem_{ROWS}.parquet", ROWS)
    eng = ScanEngine(str(path))
    batch = eng.reader.prescan("l_comment", pad_strings=8)
    chars = to_tensor(batch.arrays["str_padded"], "cuda")
    lens = to_tensor(batch.arrays["str_lens"], "cuda", dtype=np.int32)
    col = eng.resident("l_comment", device="cuda")
    bk = max(col._buckets, key=lambda b: b["stream"].numel())
    dfa = compile_pattern(PATTERN)
    want = dfa_walk.value_walk_plain(chars, lens, dfa)
    def value():
        return dfa_walk.value_walk(chars, lens, dfa)

    if not torch.equal(value(), want):
        raise AssertionError("value walk differs from the plain one")
    page = lambda: dfa_walk.stream_walk(bk["stream"], bk["walk_plen"],  # noqa: E731
                                        bk["walk_nn"], dfa, bk["steps"])
    out = {"root": str(root), "card": card, "shape": list(chars.shape),
           "walked_bytes": int(lens.clamp(max=chars.shape[1]).sum()),
           "fetch_floor_bytes": fetch_floor(chars, lens)}
    best: dict = {}
    for _ in range(args.rounds):
        for queued in (True, False):
            key = f"value_{'device_' if queued else ''}ms"
            best[key] = min(best.get(key, float("inf")),
                            _ms(value, 20, queued))
        best["page_device_ms"] = min(best.get("page_device_ms", float("inf")),
                                     _ms(page, 20, True))
    out.update(best)
    if args.sweep:
        out["sweep"] = sweep(chars, lens, dfa, want, args.rounds)
    if args.ablate:
        out["ablate"] = ablate(chars, lens, dfa, want, args.rounds)
    if args.sass:
        write_sass(Path(args.sass))
    if args.diagnose:
        out["diagnose"] = diagnose(chars, lens, dfa, args.rounds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
