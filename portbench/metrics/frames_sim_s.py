"""Wall seconds a simulation that writes frames: the window's wall time
over its simulations (stepping, the graph capture, host checks and every
frame of each)."""


def read(ctx):
    return ctx["window_s"] / len(ctx["timings"])
