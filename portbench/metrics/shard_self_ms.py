"""The sharded scan's front door's own time a scan: the program's
`dpq.query` spans less its `dpq.compile`, `dpq.prescan`, `dpq.shard_plan`,
`dpq.split_plan`, `dpq.upload`, `dpq.step` and `dpq.exchange` spans (what
no span names), summed over rank 0's window, over the scans.  None where
the program has no `dpq.shard_plan` span."""

from portbench import spans

LAYER = "sharded scan"
UNIT = "ms"
MOVES = "device_peak_gb"
INNER = ("dpq.compile", "dpq.prescan", "dpq.shard_plan", "dpq.split_plan",
         "dpq.upload", "dpq.step", "dpq.exchange")


def read(run):
    query = spans.span_ms(run, "dpq.query")
    if query is None or spans.span_ms(run, "dpq.shard_plan") is None \
            or not run.ops:
        return None
    inner = sum(spans.span_ms(run, name) or 0.0 for name in INNER)
    return (query - inner) / run.ops
