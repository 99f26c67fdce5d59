#!/usr/bin/env python3
"""Where one NCCL rank's step of the contact deck spends its device time,
against one device's step, kernel by kernel (needs one GPU).

    python3 scripts/rank_step_breakdown.py

Lowers ``chip_smoke.py``'s ``[contact]`` deck (``impact_model(n=48,
v0=2e5, d_time=1e-9, end_time=5e-6)``, mixed), steps N0 = 400 steps (past
first contact and deletion) on one NCCL rank (``parallel.dist.launch``)
and on one device, times 128-step graph chunks from there (host clock,
three times), and traces NT = 32 more steps through the graph path and
the eager loop.  Prints each run's graph us/step, device busy and the
span of its device events a step, then the device time a step and the
launch count of the 40 kernels (and copies) of the most time, one column
per run: one device graph, one device eager, rank graph, rank eager.
"""
import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
N0, NT = 400, 32


def agg(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    a = collections.defaultdict(lambda: [0, 0.0])
    span = [1e30, 0]
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            a[e.name[:70]][0] += 1
            a[e.name[:70]][1] += e.time_range.elapsed_us()
            span[0] = min(span[0], e.time_range.start)
            span[1] = max(span[1], e.time_range.end)
    return dict(a), span[1] - span[0]


def timed(fn, reps=3):
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / 128 * 1e6)
    return out


def rank(ctx, model):
    from hakai_tpu_torch.parallel.sharding import (_rank_setup,
                                                   sharded_run_chunk)
    from hakai_tpu_torch.solver.explicit import eager_chunk
    _, comm, lm, ls = _rank_setup(ctx, model, None)
    s = sharded_run_chunk(comm, lm, ls, N0)
    sharded_run_chunk(comm, lm, s, 128)
    out = {"graph us (128-step chunks)": timed(
        lambda: sharded_run_chunk(comm, lm, s, 128))}
    out["graph"] = agg(lambda: sharded_run_chunk(comm, lm, s, NT))
    out["eager"] = agg(lambda: sharded_run_chunk(comm, lm, s, NT,
                                                 eager_chunk))
    return out


def main():
    import torch
    from hakai_tpu_torch import SolverConfig, init_state, lower
    from hakai_tpu_torch.parallel.dist import launch
    from hakai_tpu_torch.pre.synthetic import impact_model
    from hakai_tpu_torch.solver.explicit import eager_chunk, graph_chunk
    m = lower(impact_model(n=48, v0=2e5, d_time=1e-9, end_time=5e-6),
              SolverConfig(dtype="mixed", energy_check=True), device="cpu")
    out = {"rank": launch(rank, 1, "cuda", "nccl", m)}
    md = m.to("cuda")
    s = graph_chunk(md, init_state(md), N0)
    graph_chunk(md, s, 128)
    one = {"graph us (128-step chunks)": timed(lambda: graph_chunk(md, s,
                                                                   128))}
    one["graph"] = agg(lambda: graph_chunk(md, s, NT))
    one["eager"] = agg(lambda: eager_chunk(md, s, NT))
    out["one"] = one
    for who, r in out.items():
        print(who, "graph us/step", r["graph us (128-step chunks)"])
        for k in ("graph", "eager"):
            a, span = r[k]
            print(f"  {who} {k}: busy {sum(v[1] for v in a.values()) / NT:.2f}"
                  f" us/step, span {span / NT:.2f} us/step")
    names = set()
    for r in out.values():
        for k in ("graph", "eager"):
            names |= set(r[k][0])
    rows = []
    for n in names:
        v = [out[w][k][0].get(n, [0, 0.0]) for w in ("one", "rank")
             for k in ("graph", "eager")]
        rows.append((max(x[1] for x in v), n, v))
    print("one graph | one eager | rank graph | rank eager (us/step, count)")
    for _, n, v in sorted(rows, reverse=True)[:40]:
        print("  " + " | ".join(f"{x[1] / NT:8.2f} {x[0]:5d}" for x in v),
              n)


if __name__ == "__main__":
    main()
