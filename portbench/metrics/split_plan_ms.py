"""The native split plan a cold scan: the program's `dpq.split_plan` spans
(`ops/scan.split_payload_pages`, which re-chunks big pages at value
boundaries), summed over the window, over the scans."""

from portbench import spans

LAYER = "host layer"
UNIT = "ms"
MOVES = "scan_rows_per_s"


def read(run):
    return spans.span_ms_per_op(run, "dpq.split_plan")
