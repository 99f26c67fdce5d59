"""Host milliseconds a chunk that ``run()``'s loop spends on the metrics
stream (span ``hakai.metrics``: the record's device reductions, their
reads to the host and the JSONL write), over the window's untraced
simulations: ``run(timings=...)``'s ``metrics_s`` over its ``chunks``.
None where the program keeps no such counter."""


def read(ctx):
    t = ctx["timings"]
    chunks = sum(x["chunks"] for x in t)
    if not chunks or any("metrics_s" not in x for x in t):
        return None
    return sum(x["metrics_s"] for x in t) / chunks * 1e3
