"""The host under a run: when the process started, and what it did over the
window.

- `process_start`: the process's start on the `time.perf_counter` clock,
  from /proc (the kernel's start time in clock ticks against the uptime),
  so that `setup_s` counts the interpreter's start and the imports too.
- `card_present`: whether a CUDA card can be there, without loading
  PyTorch: no device nodes, or CUDA_VISIBLE_DEVICES set empty, says no;
- `die_with_parent`: a child rank is killed when the rank 0 that started
  it ends, however it ends;
- `Reading`: over the window, this process's user and system CPU seconds
  (`getrusage`; its page faults and context switches, and /proc/stat's idle
  and steal ticks, read 0 on the GPU machine, so they are not taken).
"""

from __future__ import annotations

import ctypes
import os
import resource
import signal
import time
from pathlib import Path


def process_start() -> float:
    """This process's start, on the `time.perf_counter` clock."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            # the command may hold spaces: fields count from after its ")"
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except OSError:
        return now
    age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return now - max(age, 0.0)


def card_present() -> bool:
    """False where no CUDA card can be seen: PyTorch then finds none."""
    if os.environ.get("CUDA_VISIBLE_DEVICES", None) == "":
        return False
    return any(Path("/dev").glob("nvidia[0-9]*"))


PR_SET_PDEATHSIG = 1


def die_with_parent() -> None:
    """This process gets SIGKILL when its parent ends (PR_SET_PDEATHSIG)."""
    ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)


class Reading:
    """What this process did from the reading's making to `close()`."""

    def __init__(self):
        self.ru = resource.getrusage(resource.RUSAGE_SELF)
        self.t = time.perf_counter()

    def close(self) -> str:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        fields = {
            "wall_s": time.perf_counter() - self.t,
            "user_s": ru.ru_utime - self.ru.ru_utime,
            "sys_s": ru.ru_stime - self.ru.ru_stime,
        }
        return ", ".join(f"{k} {v:.6g}" for k, v in fields.items())
