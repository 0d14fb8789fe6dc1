"""The device's idle share of the traced window: 100 less the union of its
kernels, copies and fills in the profile over the window, in %."""

LAYER = "device"
UNIT = "%"
MOVES = "device_peak_gb"


def read(run):
    if run.trace is None or not run.seconds:
        return None
    return 100.0 * (1.0 - run.trace.busy_seconds() / run.seconds)
