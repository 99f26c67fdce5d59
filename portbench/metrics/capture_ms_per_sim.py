"""Milliseconds of graph capture a simulation over the window's untraced
simulations: ``run(timings=...)``'s ``capture_s`` (host seconds of each
graph's warm-up, capture and instantiation in the ``run()``), the mean
over the simulations.  None where the program keeps no such counter."""


def read(ctx):
    t = ctx["timings"]
    if not t or any("capture_s" not in x for x in t):
        return None
    return sum(x["capture_s"] for x in t) / len(t) * 1e3
