"""Device values that ``run()``'s loop reads to the host a chunk, outside
frames, over the window's untraced simulations: ``run(timings=...)``'s
``host_syncs`` over its ``chunks``.  None where the program keeps no
such counter."""


def read(ctx):
    t = ctx["timings"]
    if any("host_syncs" not in x or "chunks" not in x for x in t):
        return None
    chunks = sum(x["chunks"] for x in t)
    return sum(x["host_syncs"] for x in t) / chunks if chunks else None
