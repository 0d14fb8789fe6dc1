"""Host-to-device copies a cold scan: the profile's HtoD copies (the column's
page arrays and its byte stream, uploaded each scan by the resident route
that `scan_streaming` takes for pages over the split size), summed over the
window, over the scans."""

LAYER = "resident upload"
UNIT = "ms"
MOVES = "scan_rows_per_s"


def read(run):
    if not run.ops or run.trace is None:
        return None
    return 1e3 * run.trace.seconds_of(
        lambda n, c: c == "gpu_memcpy" and "HtoD" in n) / run.ops
