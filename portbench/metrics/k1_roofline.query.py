"""K1's share of its memory roofline, as a resident query walks its PLAIN pages (`ResidentColumn.scan`): the
encoded bytes of those pages and a 4-byte count a page, over 3.35 TB/s,
against the time of K1's kernels (`dpq_stream_*`) in the profile."""

from portbench import roofline

LAYER = "K1 stream matcher"
UNIT = "%"
MOVES = "query_p95_ms"


def read(run):
    return roofline.kernel_share(run, "dpq_stream_", "PLAIN")
