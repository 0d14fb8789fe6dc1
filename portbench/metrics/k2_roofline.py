"""K2's share of its memory roofline, as a resident query counts the accepted
values of its dictionary pages (`dict_count`): the encoded bytes of those
pages and a 4-byte count a page, over 3.35 TB/s, against the time of
`dict_count_kernel` in the profile."""

from portbench import roofline

LAYER = "K2 dictionary kernel"
UNIT = "%"
MOVES = "query_p95_ms"


def read(run):
    return roofline.kernel_share(run, "dict_count_kernel", "RLE_DICTIONARY")
