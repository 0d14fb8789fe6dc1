"""The yardstick of the kernels' rooflines: the table of peaks and the bytes
a scan kernel's work needs.

A page-walking kernel's work, whatever implements it, is the encoded data
of the pages it answers, as written in the file, plus one 4-byte count a
page out.  Its least time is those bytes over the card's memory bandwidth;
its share of the roofline is that least time over the time the profile
gives it.
"""

from __future__ import annotations

from .datagen import Table

# Published peaks (NVIDIA's data sheet, SXM part, at the full 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
COUNT_BYTES = 4


def page_walk_bytes(table: Table, encoding: str) -> int:
    """The bytes one pass over the table's data pages of `encoding` needs:
    their encoded data and a count out for each (0 when the table has none)."""
    if table.encoding != encoding:
        return 0
    return int(table.page_bytes.sum()) + COUNT_BYTES * table.n_pages


def share_pct(nbytes: float, seconds: float, device_kind: str) -> float | None:
    """The share, in %, of the memory roofline that `nbytes` moved in
    `seconds` reach; None where nothing was timed or the card's peak is
    not in the table."""
    peak = PEAKS.get(device_kind, {}).get("hbm_bytes_per_s")
    if not peak or seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / peak) / seconds


def kernel_share(run, kernel: str, encoding: str) -> float | None:
    """The roofline share of a traced window's kernels whose name holds
    `kernel`, each query walking every data page of `encoding` once."""
    if not run.ops or run.trace is None:
        return None
    seconds = run.trace.seconds_of(lambda n, c: c == "kernel" and kernel in n)
    return share_pct(page_walk_bytes(run.table, encoding) * run.ops, seconds,
                     run.device_kind)
