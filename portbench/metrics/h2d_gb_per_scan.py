"""Bytes copied to the card a cold scan, in GB (1e9 bytes): the program's
`h2d_bytes` counter (every host array handed to `.to(device)`) over the
window, over the scans."""

from portbench import spans

LAYER = "resident upload"
UNIT = "GB"
MOVES = "scan_rows_per_s"


def read(run):
    per_op = spans.counter_per_op(run, "h2d_bytes")
    return None if per_op is None else per_op / 1e9
