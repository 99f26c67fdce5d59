"""The element kernel's share of its roofline, in percent: the frozen
bound of a packed step at the cell's shapes (``portbench/roofline.py``)
over the mean ``element_kernel`` duration in the traced simulation."""
from portbench import roofline, trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    s, n = trace.device_time(tr, lambda name: "element_kernel" in name)
    if not n:
        return None
    bound = roofline.element_bound_s(ctx["E"], ctx["N"], ctx["dtype"],
                                     ctx["fracture"])
    return bound / (s / n) * 100.0
