"""The generic step's element kernel's share of its roofline, in percent:
the frozen bound of one unpacked-entry step with the count at the cell's
shapes (``portbench/roofline_generic.py``) over the mean duration of that
entry's kernel in the traced simulation, matched by its instantiated
name.  None where the trace holds no such kernel."""
from portbench import roofline_generic, trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    s, n = trace.device_time(
        tr, roofline_generic.is_generic_entry(ctx["dtype"]))
    if not n:
        return None
    bound = roofline_generic.generic_element_bound_s(ctx["E"], ctx["N"],
                                                     ctx["dtype"])
    return bound / (s / n) * 100.0
