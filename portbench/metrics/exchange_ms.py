"""The collectives a scan: the program's `dpq.exchange` spans
(`parallel/mesh.all_reduce_sum` and `to_global`, from the staging to the
copy back, so on rank 0 the wait for the slowest rank too), summed over
rank 0's window, over the scans."""

from portbench import spans

LAYER = "collectives"
UNIT = "ms"
MOVES = "device_peak_gb"


def read(run):
    return spans.span_ms_per_op(run, "dpq.exchange")
