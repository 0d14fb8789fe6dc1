"""The native prescan a cold scan: the program's `dpq.prescan` spans
(`host/reader.ParquetReader.prescan`, of the first row group and then of
the whole column), summed over the window, over the scans."""

from portbench import spans

LAYER = "host layer"
UNIT = "ms"
MOVES = "device_peak_gb"


def read(run):
    return spans.span_ms_per_op(run, "dpq.prescan")
