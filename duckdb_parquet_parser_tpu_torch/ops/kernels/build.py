"""Builds the port's CUDA sources into shared libraries and loads them.

Route: `nvcc` by hand into a `.so` with a plain C interface, loaded with
`ctypes`; the sources include no PyTorch headers, which keeps builds short.
Target `sm_90a` (Hopper).  Sources are the repository's `csrc/` files and
the stream-matcher source the emitter generates from them; a build is
cached by the SHA-256 of its source text and flags under
`build/torch_kernels/` at the repository root.  Nothing builds at import:
the first call that needs a library builds it; `build_sources` builds
several at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def _library_path(text: str) -> Path:
    sha = hashlib.sha256(("\0".join(NVCC_FLAGS) + "\0" + text).encode()
                         ).hexdigest()[:20]
    return BUILD_DIR / f"{sha}.so"


def build_sources(texts) -> list[Path]:
    """Compiles each CUDA source of `texts` not built yet to
    `build/torch_kernels/<sha>.so`, one `nvcc` run a source, all started
    together, and returns the library paths in the order of `texts`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for text in dict.fromkeys(texts):
            so = _library_path(text)
            if so.exists():
                continue
            cu = so.with_suffix(f".{os.getpid()}.cu")
            cu.write_text(text)
            tmp = cu.with_suffix(".tmp")
            jobs.append((cu, tmp, so, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for cu, tmp, so, proc in jobs:
            err = proc.communicate()[1]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {cu}:\n{err}")
            os.replace(tmp, so)
            cu.unlink()
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [_library_path(text) for text in texts]


def load_source(text: str) -> ctypes.CDLL:
    """Builds (if needed) and loads the library for `text`."""
    with _lock:
        so, = build_sources([text])
        lib = _loaded.get(str(so))
        if lib is None:
            lib = _loaded[str(so)] = ctypes.CDLL(str(so))
        return lib


_SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", re.M)
_SASS_BRANCH = re.compile(r"\bBRA\b.*\b0x([0-9a-f]+)\s*$")
_SASS_PREDICATE = re.compile(r"^@!?U?P\w+\s+")


def loop_instructions(sass: str, containing: str | None = None
                      ) -> dict[str, int]:
    """Machine instructions of the innermost loop in one function's
    disassembly, counted by opcode: those from the target of the shortest
    backward branch to the branch itself (empty when the function has no
    loop).  With `containing`, the shortest loop whose body holds that
    opcode (a kernel that copies a table in a loop of its own before the
    loop that matters)."""
    lines = [(int(a, 16), text.strip()) for a, text in _SASS_LINE.findall(sass)]
    spans = []
    for addr, text in lines:
        m = _SASS_BRANCH.search(text)
        if m and int(m.group(1), 16) < addr:
            spans.append((addr - int(m.group(1), 16), int(m.group(1), 16), addr))
    for _span, first, last in sorted(spans):
        counts: dict[str, int] = {}
        for addr, text in lines:
            if first <= addr <= last:
                op = _SASS_PREDICATE.sub("", text).split()[0].split(".")[0]
                counts[op] = counts.get(op, 0) + 1
        if containing is None or containing in counts:
            return counts
    return {}


def disassembler() -> Path | None:
    """`cuobjdump` beside `nvcc`, or None where the toolkit lacks it."""
    found = Path(_nvcc()).with_name("cuobjdump")
    return found if found.exists() else None


def inspect_source(text: str, loop_containing: str | None = None
                   ) -> dict[str, dict]:
    """What the compiler made of CUDA source `text`, per kernel (mangled
    name): `registers`, `spill_bytes` (ptxas's report) and
    `loop_instructions` ({opcode: count} of the innermost loop, or of the
    innermost one holding opcode `loop_containing`, from `cuobjdump
    -sass`).  A measuring aid: builds a throw-away cubin beside the cached
    libraries, loads nothing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = BUILD_DIR / f"inspect-{os.getpid()}"
    cu, cubin = stem.with_suffix(".cu"), stem.with_suffix(".cubin")
    cu.write_text(text)
    nvcc = _nvcc()
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o",
                           str(cubin), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    out: dict[str, dict] = {}
    for name, body in re.findall(
            r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)",
            proc.stderr, re.S):
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           body)
        out[name] = {
            "registers": int(re.search(r"Used (\d+) registers", body).group(1)),
            "spill_bytes": int(spills.group(1)) + int(spills.group(2))}
    sass = subprocess.run([str(disassembler()), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        out[part.split()[0]]["loop_instructions"] = loop_instructions(
            part, loop_containing)
    cu.unlink()
    cubin.unlink()
    return out


def read_csrc(name: str) -> str:
    return (CSRC / name).read_text()
