"""Share of the traced simulation's wall time in which no operation ran
on the device: 1 - (union of the device intervals) / window."""
from portbench import trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["device"]:
        return None
    return 1.0 - trace.busy_s(tr) / trace.window_s(tr)
