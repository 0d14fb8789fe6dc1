"""Opening the file a cold scan: the program's `dpq.open` spans
(`host/reader.ParquetReader.__init__`: the native open and the footer
parse of each fresh engine), summed over the window, over the scans."""

from portbench import spans

LAYER = "host layer"
UNIT = "ms"
MOVES = "scan_rows_per_s"


def read(run):
    return spans.span_ms_per_op(run, "dpq.open")
