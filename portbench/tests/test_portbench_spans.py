"""The readers of the program's own counters and spans, on hand-made
timings and traces: ``capture_ms_per_sim``, ``host_loop_us_per_step``,
``host_syncs_per_chunk``, ``idle_share_capture`` and
``idle_share_host_loop``, and the interval arithmetic of
``portbench/idle.py`` under them.  Run from the repository's root:

    python -m pytest portbench/tests -q
"""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import idle, run, trace  # noqa: E402

NAMES = ("capture_ms_per_sim", "host_loop_us_per_step",
         "host_syncs_per_chunk", "idle_share_capture",
         "idle_share_host_loop")
MS = 1_000_000


def _trace():
    """A window of 100 ms: busy 10-20, 30-60, 70-75 and 90-100; idle
    0-10, 20-30, 60-70 and 75-90.  The gap 20-30 straddles the capture's
    end (28) inside the chunk, and 60-70 the chunk's end (65)."""
    spans = [("hakai.run", 5, 95), ("hakai.run.enter", 5, 12),
             ("hakai.chunk", 12, 65), ("hakai.graph.capture", 18, 28),
             ("hakai.graph.replay", 40, 50), ("cudaGraphLaunch", 41, 42),
             ("cudaGraphLaunch", 52, 53),
             ("cudaGraphInstantiate", 25, 27),
             ("cudaStreamBeginCapture", 19, 19.5),
             ("hakai.graph.warm_up", 18.5, 19),
             ("cudaStreamEndCapture", 24, 24.5),
             ("hakai.guard.energy", 66, 69), ("hakai.frame", 76, 85),
             ("hakai.frame.write", 80, 85), ("aten::copy_", 1, 3)]
    return {"window": (0, 100 * MS),
            "device": [(k, a * MS, b * MS) for k, a, b in (
                ("element_kernel", 10, 20), ("element_kernel", 30, 60),
                ("Memcpy DtoD", 70, 75), ("narrow_probe", 90, 100))],
            "host": [(n, a * MS, b * MS) for n, a, b in spans]}


def _ctx(tr=None, timings=None):
    return dict(trace=tr, timings=timings or [
        {"step_s": 1.0, "steps": 10000, "frame_s": 0.0, "frames": 0,
         "chunks": 100, "host_syncs": 301, "loop_s": 0.15,
         "captures": 2, "capture_s": 0.02, "replays": 400},
        {"step_s": 1.1, "steps": 10000, "frame_s": 0.0, "frames": 0,
         "chunks": 100, "host_syncs": 299, "loop_s": 0.05,
         "captures": 2, "capture_s": 0.04, "replays": 400}])


def test_readers_of_the_counters():
    read = {m: run.reader(m) for m in NAMES}
    ctx = _ctx(_trace())
    assert read["capture_ms_per_sim"](ctx) == pytest.approx(30.0)
    assert read["host_loop_us_per_step"](ctx) == pytest.approx(10.0)
    assert read["host_syncs_per_chunk"](ctx) == pytest.approx(3.0)


def test_readers_of_the_spans():
    """Idle in capture: 20-28; in the host loop: 65-70 less the energy
    guard's 66-69 still counts (a guard is the host loop), 75-76 and
    85-90; the frame's 76-85 and the entry's 5-10 are not the loop's."""
    read = {m: run.reader(m) for m in NAMES}
    ctx = _ctx(_trace())
    assert read["idle_share_capture"](ctx) == pytest.approx(0.08)
    assert read["idle_share_host_loop"](ctx) == pytest.approx(0.11)


def test_split_sums_to_the_idle_share():
    """capture 8, the chunk's rest 28-30 and 60-65, frames 76-85, entry
    5-10, host loop 11 ms: 40 ms of idle inside ``hakai.run``; the 5 ms
    before it and the 8 ms inside it in no child span are unheld."""
    tr = _trace()
    s = idle.split(tr)
    assert s == pytest.approx(dict(capture=0.08, chunk=0.07, frames=0.09,
                                   enter=0.05, host_loop=0.11,
                                   unheld=0.13))
    inside = sum(s[k] for k in ("capture", "chunk", "frames", "enter",
                                "host_loop"))
    share = 1.0 - trace.busy_s(tr) / trace.window_s(tr)
    assert share == pytest.approx(0.45)
    assert share - inside == pytest.approx(0.05)      # idle before the run


def test_readers_without_the_programs_counters_or_spans():
    """A program that keeps none of the counters (the timings of an older
    ``run()``) or makes no span reads None, never 0, and never raises."""
    old = [{"step_s": 1.0, "steps": 10000, "frame_s": 0.0, "frames": 0}]
    tr = _trace()
    tr["host"] = [h for h in tr["host"] if not h[0].startswith("hakai.")]
    for name in NAMES:
        reader = run.reader(name)
        assert reader(_ctx(tr, old)) is None, name
        assert reader(_ctx(None, old)) is None, name
    no_device = dict(_trace(), device=[])
    assert run.reader("idle_share_capture")(_ctx(no_device)) is None


def test_graph_events_inside_their_spans():
    tr = _trace()
    assert idle.outside(tr, "cudaGraphLaunch", "hakai.graph.replay") == \
        (2, 1)
    assert idle.outside(tr, "cudaGraphInstantiate",
                        "hakai.graph.capture") == (1, 0)
    assert idle.in_capture(tr) == []
    tr["host"].append(("hakai.metrics", 20 * MS, 21 * MS))
    assert idle.in_capture(tr) == ["hakai.metrics"]


@pytest.mark.parametrize("seed", range(4))
def test_interval_arithmetic_against_a_grid(seed):
    """``union``, ``intersect`` and ``subtract`` against sets of unit
    cells of an integer grid."""
    rng = np.random.default_rng(seed)

    def draw():
        a = rng.integers(0, 200, 30)
        return [(int(x), int(x + w)) for x, w in
                zip(a, rng.integers(0, 15, 30))]

    def cells(xs):
        return {c for a, b in xs for c in range(a, b)}
    xs, ys = draw(), draw()
    ux, uy = idle.union(xs), idle.union(ys)
    assert cells(ux) == cells(xs)
    assert all(b1 < a2 for (_, b1), (a2, _) in zip(ux, ux[1:]))
    assert cells(idle.intersect(ux, uy)) == cells(xs) & cells(ys)
    assert cells(idle.subtract(ux, uy)) == cells(xs) - cells(ys)
    assert idle.total(idle.subtract(ux, uy)) == len(cells(xs) - cells(ys))
