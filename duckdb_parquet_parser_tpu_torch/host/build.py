"""Build (and cache) the port's native host library `libdpqhost_torch-*.so`.

The port's own copy of `duckdb_parquet_parser_tpu/host/build.py`.  It
compiles the C++ sources of this package's `host/native/` (a copy of the
reference's) with one g++ call, cached by source digest, at first use.
The library's file name differs from the reference's, so a process that
loads both packages holds two independent libraries.  The cache directory
is `DPQ_BUILD_CACHE` when set, else `build/native_torch/` at the
repository root; the compiler is `CXX` when set, else g++.  Concurrent
processes serialize on a lock file, so one of them builds and the others
load its result.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent / "native"
_DEFAULT_CACHE = Path(__file__).resolve().parents[2] / "build" / "native_torch"

_lock = threading.Lock()
_cached_path: Path | None = None

_LIB_DIRS = [
    Path("/usr/lib/x86_64-linux-gnu"),
    Path("/usr/lib/aarch64-linux-gnu"),
    Path("/usr/lib64"),
    Path("/usr/lib"),
    Path("/usr/local/lib"),
]


def _find_lib(*patterns: str) -> Path | None:
    for d in _LIB_DIRS:
        if not d.is_dir():
            continue
        for pat in patterns:
            hits = sorted(d.glob(pat))
            if hits:
                return hits[0]
    return None


def _codec_flags() -> list[str]:
    """Compile defines + link args for the optional page codecs.

    zlib/zstd ship dev headers in this image; lz4/brotli ship only the
    runtime .so.1 (prototypes are declared in dpq_codec.hpp), so those are
    linked by full path.  Missing libraries simply drop the codec —
    dpq_codec.hpp gates each on its DPQ_HAVE_* define.
    """
    flags: list[str] = []
    inc = Path("/usr/include")
    z = _find_lib("libz.so", "libz.so.*")
    if (inc / "zlib.h").exists() and z is not None:
        flags += ["-DDPQ_HAVE_ZLIB", str(z)]
    zstd = _find_lib("libzstd.so", "libzstd.so.*")
    if (inc / "zstd.h").exists() and zstd is not None:
        flags += ["-DDPQ_HAVE_ZSTD", str(zstd)]
    lz4 = _find_lib("liblz4.so", "liblz4.so.*")
    if lz4 is not None:
        flags += ["-DDPQ_HAVE_LZ4", str(lz4)]
    bdec = _find_lib("libbrotlidec.so", "libbrotlidec.so.*")
    benc = _find_lib("libbrotlienc.so", "libbrotlienc.so.*")
    if bdec is not None and benc is not None:
        flags += ["-DDPQ_HAVE_BROTLI", str(bdec), str(benc)]
    return flags


def _digest(extra: list[str]) -> str:
    h = hashlib.sha256()
    for path in sorted(_NATIVE_DIR.glob("*.hpp")) + sorted(
        _NATIVE_DIR.glob("*.cpp")
    ):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update("\0".join(extra).encode())
    return h.hexdigest()[:16]


def _compile(so_path: Path, codec_flags: list[str]) -> None:
    tmp = so_path.with_suffix(".so.tmp")
    cmd = [
        os.environ.get("CXX", "g++"),
        "-std=c++17",
        "-O3",
        # the library is compiled on the machine that runs it (cached
        # per source digest), so tuning for the local ISA is safe —
        # the value walks vectorize with AVX2 where available
        "-march=native",
        "-fPIC",
        "-shared",
        "-pthread",
        "-Wall",
        "-Wextra",
        str(_NATIVE_DIR / "dpq_capi.cpp"),
        *codec_flags,
        "-o",
        str(tmp),
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, so_path)


def build_library(force: bool = False) -> Path:
    """Compile the library if needed; returns the cached .so path."""
    global _cached_path
    with _lock:
        if _cached_path is not None and not force:
            return _cached_path
        cache_dir = Path(os.environ.get("DPQ_BUILD_CACHE", _DEFAULT_CACHE))
        cache_dir.mkdir(parents=True, exist_ok=True)
        codec_flags = _codec_flags()
        tag = _digest(codec_flags + ["-march=native"])
        so_path = cache_dir / f"libdpqhost_torch-{tag}.so"
        with open(cache_dir / "libdpqhost_torch.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not so_path.exists() or force:
                _compile(so_path, codec_flags)
        _cached_path = so_path
        return so_path
