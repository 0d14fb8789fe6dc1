"""The resident upload a cold scan, without the split plan: the program's
`dpq.upload` spans (`ops/scan.resident_buckets` after the split plan: host
staging and the copies of the column's arrays and byte stream to the
card), summed over the window, over the scans."""

from portbench import spans

LAYER = "resident upload"
UNIT = "ms"
MOVES = "device_peak_gb"


def read(run):
    return spans.span_ms_per_op(run, "dpq.upload")
