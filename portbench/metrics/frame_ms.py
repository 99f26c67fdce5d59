"""Milliseconds a VTK frame over the window's untraced simulations:
``run(timings=...)``'s ``frame_s`` over its ``frames`` (deck-order
mapping, formatting by the host-IO helper, and the write)."""


def read(ctx):
    frames = sum(t["frames"] for t in ctx["timings"])
    return sum(t["frame_s"] for t in ctx["timings"]) / frames * 1e3 \
        if frames else None
