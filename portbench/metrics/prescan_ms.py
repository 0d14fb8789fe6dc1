"""The native prescan a cold scan: the spans of `ParquetReader.prescan` (the
first row group's, then the whole column's: at the configuration's page
size `scan_streaming` takes the resident route), summed over the window,
over the scans."""

LAYER = "host layer"
UNIT = "ms"
MOVES = "scan_rows_per_s"


def read(run):
    return 1e3 * run.span_seconds("prescan") / run.ops if run.ops else None
