"""Host microseconds a step that ``run()``'s loop spends outside its
chunks and frames (the alive count, NaN and energy guards, metrics,
checkpoints and its own code), over the window's untraced simulations:
``run(timings=...)``'s ``loop_s`` over its ``steps``.  None where the
program keeps no such counter."""


def read(ctx):
    t = ctx["timings"]
    steps = sum(x["steps"] for x in t)
    if not steps or any("loop_s" not in x for x in t):
        return None
    return sum(x["loop_s"] for x in t) / steps * 1e6
