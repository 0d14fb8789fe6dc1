"""Builds the port's CUDA sources into shared libraries and loads them.

Route: `nvcc` by hand into a `.so` with a plain C interface, loaded with
`ctypes`; the sources include no PyTorch headers, which keeps builds short.
Target `sm_90a` (Hopper).  Sources are the repository's `csrc/` files and
the stream-matcher source the emitter generates from them; a build is
cached by the SHA-256 of its source text and flags under
`build/torch_kernels/` at the repository root.  Nothing builds at import:
the first call that needs a library builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build_source(text: str) -> Path:
    """Compiles CUDA source `text` to `build/torch_kernels/<sha>.so` (once
    per distinct source) and returns the library path."""
    sha = hashlib.sha256(("\0".join(NVCC_FLAGS) + "\0" + text).encode()
                         ).hexdigest()[:20]
    so = BUILD_DIR / f"{sha}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = BUILD_DIR / f"{sha}.cu"
    cu.write_text(text)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load_source(text: str) -> ctypes.CDLL:
    """Builds (if needed) and loads the library for `text`."""
    with _lock:
        so = build_source(text)
        lib = _loaded.get(str(so))
        if lib is None:
            lib = _loaded[str(so)] = ctypes.CDLL(str(so))
        return lib


def read_csrc(name: str) -> str:
    return (CSRC / name).read_text()
