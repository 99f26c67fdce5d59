#!/usr/bin/env python3
"""Where the card's idle time lies among the program's own spans.

A traced simulation (``trace.profile``: the window, device intervals and
host spans) holds the program's ``hakai.*`` spans among its host events.
Each idle stretch of the window (no device interval over it) is put down
to the spans that hold it, by interval intersection:

- ``capture``: inside ``hakai.graph.capture`` (warm-up, capture,
  instantiation of a graph);
- ``chunk``: inside ``hakai.chunk`` and outside ``capture`` (copy-in,
  replays, copy-out, the sync);
- ``frames``: inside ``hakai.frame``;
- ``enter``: inside ``hakai.run.enter`` (the model and state moved to the
  device);
- ``host_loop``: inside ``hakai.run`` and outside the four above (guards,
  metrics, checkpoints, the loop's own code);

each as a share of the window, and ``unheld``: idle inside ``hakai.run``
in none of its ``hakai.*`` spans, plus idle in the window outside
``hakai.run``.  A trace without a ``hakai.run`` span (a program without
spans) has no split.

    python3 portbench/idle.py --workload <cell> --seed <n> [--traced 3]

runs the cell's deck as ``run.py`` does (lowering, a warm-up simulation,
one untraced simulation) and then ``--traced`` simulations under the
profiler, and prints one JSON line for each: the split, the harness's
``device_idle_share``, the count of ``hakai.*`` spans, and the host
events that must lie in a span
(``cudaGraphLaunch`` in ``hakai.graph.replay``, ``cudaGraphInstantiate``
in ``hakai.graph.capture``) with how many do not, and the ``hakai.*``
spans that start inside a stream capture.
"""
from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import trace  # noqa: E402

def union(intervals) -> list:
    """Sorted disjoint (start, end) intervals covering ``intervals``."""
    return [tuple(x) for x in trace.merged(
        (a, b) for a, b in intervals if b > a)]


def intersect(xs, ys) -> list:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys) -> list:
    """``xs`` less ``ys``, both sorted disjoint interval lists."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            c, d = ys[k]
            if c > a:
                out.append((a, c))
            a = max(a, d)
            k += 1
        if a < b:
            out.append((a, b))
    return out


def total(xs) -> float:
    return float(sum(b - a for a, b in xs))


def spans(tr, names) -> list:
    """The union of the host spans named (exactly) one of ``names``."""
    return union((a, b) for n, a, b in tr["host"] if n in names)


def idle(tr) -> list:
    """The window's stretches in which no device interval runs."""
    w = [tuple(tr["window"])]
    return subtract(w, union((max(a, w[0][0]), min(b, w[0][1]))
                             for _, a, b in tr["device"]))


def split(tr) -> dict | None:
    """The idle time of the window by the spans that hold it (module
    docstring), as shares of the window; None without a ``hakai.run``
    span or a device interval."""
    if tr is None or not tr["device"]:
        return None
    run = spans(tr, {"hakai.run"})
    if not run:
        return None
    w0, w1 = tr["window"]
    free = idle(tr)
    held = {"capture": spans(tr, {"hakai.graph.capture"}),
            "chunk": spans(tr, {"hakai.chunk"}),
            "frames": spans(tr, {"hakai.frame"}),
            "enter": spans(tr, {"hakai.run.enter"})}
    held["chunk"] = subtract(held["chunk"], held["capture"])
    out = {k: total(intersect(free, v)) for k, v in held.items()}
    out["host_loop"] = total(subtract(intersect(free, run), union(
        x for v in held.values() for x in v)))
    children = spans(tr, {n for n, _, _ in tr["host"]
                          if n.startswith("hakai.") and n != "hakai.run"})
    out["unheld"] = total(subtract(intersect(free, run), children)) + \
        total(subtract(free, run))
    return {k: v / (w1 - w0) for k, v in out.items()}


def outside(tr, name: str, holder: str) -> tuple:
    """(host events whose name starts with ``name``, how many of them lie
    in no ``holder`` span)."""
    hold = spans(tr, {holder})
    evs = [(a, b) for n, a, b in tr["host"] if n.startswith(name)]
    return len(evs), sum(not any(c <= a and b <= d for c, d in hold)
                         for a, b in evs)


def in_capture(tr) -> list:
    """The ``hakai.*`` spans that start while a stream is captured
    (between ``cudaStreamBeginCapture`` and ``cudaStreamEndCapture``)."""
    begins = sorted(a for n, a, _ in tr["host"]
                    if n.startswith("cudaStreamBeginCapture"))
    ends = sorted(b for n, _, b in tr["host"]
                  if n.startswith("cudaStreamEndCapture"))
    return sorted({n for n, a, _ in tr["host"] if n.startswith("hakai.")
                   and any(s < a < e for s, e in zip(begins, ends))})


def main(argv=None) -> int:
    import argparse
    import json
    import shutil
    import tempfile
    import time

    from portbench import program, run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--traced", type=int, default=3)
    args = ap.parse_args(argv)
    spec = run.cell_spec(args.workload)
    write = bool(spec["traffic"]["write_output"])
    out_dir = tempfile.mkdtemp(prefix="portbench-idle-")
    try:
        model = program.lower(run.deck_of(spec, args.seed),
                              run.solver_of(spec), out_dir, "cuda")
        program.simulate(program.first_chunk(model), write, {})
        program.simulate(model, write, {})
        for i in range(args.traced):
            t = time.perf_counter()
            _, tr = trace.profile(lambda: program.simulate(model, write, {}))
            wall = time.perf_counter() - t
            share = 1.0 - trace.busy_s(tr) / trace.window_s(tr)
            line = dict(workload=args.workload, seed=args.seed, sim=i,
                        wall_s=wall, window_s=trace.window_s(tr),
                        device_idle_share=share, split=split(tr),
                        graph_launch=outside(tr, "cudaGraphLaunch",
                                             "hakai.graph.replay"),
                        graph_instantiate=outside(
                            tr, "cudaGraphInstantiate",
                            "hakai.graph.capture"),
                        spans_in_capture=in_capture(tr),
                        spans=sum(n.startswith("hakai.")
                                  for n, _, _ in tr["host"]))
            print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
