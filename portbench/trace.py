"""The traced simulation: one whole ``run()`` under ``torch.profiler``,
reduced to device intervals, host spans and the breakdown the result line
carries.  The span ``portbench.simulation`` (the benchmark's own, around
the call) sets the traced window."""
from __future__ import annotations

SPAN = "portbench.simulation"


def profile(call):
    """Run ``call()`` under the profiler; returns (its result, trace), the
    trace a dict of ``window`` (start, end ns), ``device`` [(name, start,
    end ns)] and ``host`` [(name, start, end ns)]."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        with record_function(SPAN):
            out = call()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a span's copy on the device timeline is no device work
            if not e.is_user_annotation():
                dev.append(span)
        elif e.name() == SPAN:
            window = span[1:]
        else:
            host.append(span)
    return out, dict(window=window, device=dev, host=host)


def merged(intervals):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    w0, w1 = trace["window"]
    return sum(min(b, w1) - max(a, w0) for a, b in merged(
        (a, b) for _, a, b in trace["device"]) if b > w0 and a < w1) / 1e9


def window_s(trace) -> float:
    w0, w1 = trace["window"]
    return (w1 - w0) / 1e9


def device_time(trace, match) -> tuple:
    """(seconds, launches) of the device operations whose name ``match``
    accepts."""
    hits = [b - a for name, a, b in trace["device"] if match(name)]
    return sum(hits) / 1e9, len(hits)


def breakdown(trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the window, each named by the innermost host span that holds
    its middle."""
    by = {}
    for name, a, b in trace["device"]:
        by[name] = by.get(name, 0.0) + (b - a) / 1e9
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = trace["window"]
    edges = [w0] + [x for a, b in merged(
        (max(a, w0), min(b, w1)) for _, a, b in trace["device"]
        if b > w0 and a < w1) for x in (a, b)] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    named = []
    for size, start in gaps:
        mid = start + size / 2
        holders = [(b - a, name) for name, a, b in trace["host"]
                   if a <= mid <= b]
        named.append([min(holders)[1] if holders else "no host span",
                      size / 1e9])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
