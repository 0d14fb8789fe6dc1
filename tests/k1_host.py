"""K1's walk built for the host: the C++ that `stream_matcher.render(...,
host=True)` gives for pattern tuples (csrc/stream_matcher.cu.in, the
`host` section), compiled with g++ and called through ctypes over the
kernel's chunked stream.  Shared by the CPU tests of the emitted C
(tests/test_torch_bitprog.py) and of the byte half's table
(tests/test_torch_stream_matcher.py)."""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from duckdb_parquet_parser_tpu_torch.ops.kernels import stream_matcher


def build(tuples, directory) -> ctypes.CDLL:
    """The host walks of the pattern tuples `tuples` in one library, built
    in `directory` (skips the test without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    src, so = directory / "walk.cpp", directory / "walk.so"
    src.write_text(stream_matcher.render(tuples, host=True))
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wall", "-Werror", "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def walk(lib, irs, pm, plen, nn, steps=None):
    """(hits [K, n], seen [n]) of the host walk of `irs` over the page
    matrix `pm` [n, pitch] in the kernel's chunked layout, walking at most
    `steps` bytes (default: all)."""
    n = pm.shape[0]
    pitch = pm.shape[1]
    pt = stream_matcher.chunk_stream(
        torch.from_numpy(np.ascontiguousarray(pm.T))).numpy()
    assert pt.shape == (-(-pitch // 16), n, 16) and pt.flags.c_contiguous
    steps = pitch if steps is None else steps
    hits = np.full((len(irs), n), -7, np.int32)
    seen = np.full(n, -7, np.int32)
    fn = getattr(lib, f"dpq_stream_host_{stream_matcher.tag_of(irs)}")
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 4)
    fn.restype = None
    plen = np.ascontiguousarray(plen, np.int32)
    nn = np.ascontiguousarray(nn, np.int32)
    fn(pt.ctypes.data, n, steps, plen.ctypes.data, nn.ctypes.data,
       hits.ctypes.data, seen.ctypes.data)
    return hits, seen
