"""Microseconds a step of ``run()``'s chunks over the window's untraced
simulations: ``run(timings=...)``'s ``step_s`` over its ``steps`` (each
chunk ends in a device sync; the graph capture inside the first chunk
counts)."""


def read(ctx):
    steps = sum(t["steps"] for t in ctx["timings"])
    return sum(t["step_s"] for t in ctx["timings"]) / steps * 1e6 \
        if steps else None
