"""Device microseconds a step of the contact kernels in the traced
simulation: kernel A (``broad_*``), G (``gather_cols_kernel``), N
(``narrow_*``) and S (``scatter_kernel``)."""
from portbench import trace

NAMES = ("broad_", "gather_cols_kernel", "narrow_", "scatter_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    s, n = trace.device_time(tr, lambda name: any(k in name for k in NAMES))
    return s / ctx["steps_per_sim"] * 1e6 if n else None
