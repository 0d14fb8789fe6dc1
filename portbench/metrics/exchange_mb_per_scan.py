"""Bytes rank 0 hands to the collectives a scan, in MB (1e6 bytes): the
program's `exchange_bytes` counter (each tensor given to
`parallel/mesh.all_reduce_sum` and `to_global`) over the window, over the
scans.  None where the window holds no `dpq.exchange` span: a program
without them keeps no such counter."""

from portbench import spans

LAYER = "collectives"
UNIT = "MB"
MOVES = "device_peak_gb"


def read(run):
    if spans.span_ms(run, "dpq.exchange") is None:
        return None
    per_op = spans.counter_per_op(run, "exchange_bytes")
    return None if per_op is None else per_op / 1e6
