#!/usr/bin/env python3
"""Run one cell of the benchmark of ``hakai_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration, whose file holds the deck and the
solver settings, and a traffic mix (``portbench/traffic/<name>.json``);
``portbench/workloads/<cell>.json`` holds the limits of its check.  The
configuration names its deck generator (``portbench/reference/decks.py``'s
or ``portbench/decks/<name>.py``) and may name its plain reference
(``"reference": "<name>"``, ``portbench/reference/<name>.py``; default
``solver``).  From ``--seed`` the deck's nodes are jittered; the program
lowers the deck once, runs one warm-up simulation cut to a chunk, then
whole simulations through ``hakai_tpu_torch.run()`` back to back for
``--seconds`` (the window ends with the simulation that is running when
the time is up).  With
``--trace 1`` one more simulation runs under ``torch.profiler``.  Then the
window's first simulation, whose sampled chunks' states were copied to the
host as it ran, is followed chunk by chunk by the plain reference
(``portbench/reference/``), every simulation's final state is held
against the others, and the last line of standard output is the result:
the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), each read by ``portbench/metrics/<name>.py``, with the
compared numbers and their limits last.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, named, program, trace  # noqa: E402
from portbench.reference import decks, solver  # noqa: E402

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "hakai_tpu")


def _load(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: str = ROOT) -> dict:
    """Everything a run of ``workload`` reads, found by name: its entry in
    ``BENCHMARK.json``, its configuration file, its traffic file, its own
    file, and the metrics it reports."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", cells)]
    reported = {m["name"]: set(m.get("workloads", cells))
                for m in bench["end_to_end"]}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", reported[m["moves"]])]
    own = os.path.join(root, "portbench")
    return dict(name=workload, chips=w["chips"], root=root,
                config=_load(os.path.join(root, entry["file"])),
                traffic=_load(os.path.join(own, "traffic",
                                           w["traffic"] + ".json")),
                cell=_load(os.path.join(own, "workloads",
                                        workload + ".json")),
                end_to_end=e2e, per_layer=layer)


def reader(name: str, root: str = ROOT):
    """``portbench/metrics/<name>.py``'s ``read``."""
    return named.module(root, "metrics", name).read


def deck_of(spec: dict, seed: int) -> decks.Deck:
    """The cell's deck from ``seed``: the configuration's generator, its
    jitter, and the traffic's simulated span where it sets one."""
    cfg = spec["config"]
    deck = decks.build(cfg["deck"], seed, cfg["jitter"], spec["root"])
    if spec["traffic"].get("end_time") is not None:
        deck = dataclasses.replace(deck, end_time=spec["traffic"]["end_time"])
    return deck


def reference_of(spec: dict, deck: decks.Deck,
                 device) -> solver.Reference:
    """The plain reference of ``deck`` on ``device``: the ``Reference`` of
    ``portbench/reference/<name>.py``, ``name`` the configuration's
    ``reference`` (default ``solver``), with contact's accept tests in the
    element dtype of the configuration's precision."""
    name = spec["config"].get("reference", "solver")
    cls = solver.Reference if name == "solver" else \
        named.module(spec["root"], "reference", name).Reference
    return cls(deck, device, contact_dtype=solver.ELEMENT_DTYPE[
        spec["config"]["solver"]["dtype"]])


def chunk_sample(chunks: int, extra: int, seed: int, within=None) -> set:
    """The chunks of the checked simulation that the check follows: the
    first (from the reference's own initial state), the last, and
    ``extra`` more drawn from ``seed``, from the chunks ``within`` (a
    [first, last) pair of indices, default every chunk between the two)."""
    rng = np.random.default_rng(seed % 2**64)
    lo, hi = within or (1, chunks - 1)
    middle = np.arange(max(lo, 1), min(hi, chunks - 1))
    pick = rng.choice(middle, min(extra, len(middle)), replace=False)
    return {0, chunks - 1} | {int(j) for j in pick}


def check_chunks(ref: solver.Reference, rec: dict, sample, d_out: int,
                 frames_dir, rows_out=None) -> dict:
    """The worst numbers over the sampled chunks: the reference follows
    each from the program's state at its start (the first from its own
    initial state) for the chunk's steps and is held against the
    program's state at its end and, with ``frames_dir``, the frame written
    there (and frame 0), and each such frame against the program's own
    state at its step.  ``chunk_steps_differ`` counts the chunks that did
    not start and end at their steps.  ``rows_out``, a list, receives
    each chunk's numbers with its index under ``chunk``."""
    rows = [{"chunk_steps_differ": sum(
        (rec[j, "start"]["step"], rec[j, "end"]["step"])
        != (j * d_out, min((j + 1) * d_out, ref.steps)) for j in sample)}]
    for j in sorted(sample):
        if j == 0:
            s0 = ref.initial_state()
            start = {k: v.cpu().numpy() for k, v in s0.items()}
            if frames_dir:
                path = os.path.join(frames_dir, "file000.vtk")
                rows += [check.frame(path, ref, s0),
                         check.frame_vs_state(path, rec[0, "start"])]
        else:
            start = rec[j, "start"]
            s0 = ref.state_of(start)
        end = rec[j, "end"]
        r = ref.run(s0, steps=min(d_out, ref.steps - j * d_out))
        rows.append(check.chunk(start, end, r, ref.deck.elem.T))
        if rows_out is not None:
            rows_out.append(dict(rows[-1], chunk=j))
        if frames_dir:
            path = os.path.join(frames_dir, f"file{j + 1:03d}.vtk")
            rows += [check.frame(path, ref, r),
                     check.frame_vs_state(path, end)]
    return check.worst(rows)


def solver_of(spec: dict, **kw) -> dict:
    """``SolverConfig`` fields of the cell: the configuration's, the
    traffic's ``output_num`` (frames a simulation, so its chunk length),
    and ``kw``."""
    return dict(spec["config"]["solver"],
                output_num=spec["traffic"]["output_num"], **kw)


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(spec: dict, seed: int, seconds: float, traced: bool,
            device: str = "cuda", start: float | None = None,
            out_root: str | None = None) -> dict:
    """One run of the cell on ``device``: the result line as a dict.
    ``start`` is the process's start (set-up counts from it); frames go
    to a fresh directory under ``out_root`` (default: the temporary
    directory), removed at the end."""
    import torch
    start = T0 if start is None else start
    cuda = torch.device(device).type == "cuda"
    write = bool(spec["traffic"]["write_output"])
    deck = deck_of(spec, seed)
    out_dir = tempfile.mkdtemp(prefix="portbench-", dir=out_root)
    try:
        t = time.perf_counter()
        model = program.lower(deck, solver_of(spec), out_dir, device)
        _sync(device)
        lower_s = time.perf_counter() - t
        program.simulate(program.first_chunk(model), write, {})
        _sync(device)
        setup_s = time.perf_counter() - start
        setup_peak = torch.cuda.max_memory_allocated() if cuda else None
        if cuda:
            torch.cuda.reset_peak_memory_stats()

        steps = model.time_num
        d_out = max(steps // model.config.output_num, 1)
        chunks = -(-steps // d_out)
        sample = chunk_sample(chunks, spec["cell"]["check_chunks"], seed,
                              spec["cell"].get("check_within"))
        checked_dir = out_dir + ".checked"
        timings, prints = [], []
        t_start = time.perf_counter()
        while True:
            tm = {}
            if timings:
                state = program.simulate(model, write, tm)
            else:                       # the simulation that is checked
                with program.recorded_chunks(sample) as rec:
                    state = program.simulate(model, write, tm)
                returned = program.host_copy(state)
                if write:
                    os.rename(out_dir, checked_dir)
            prints.append(program.fingerprint(state))
            timings.append(tm)
            if time.perf_counter() - t_start >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t_start
        window_peak = torch.cuda.max_memory_allocated() if cuda else None

        tr = None
        if traced:
            state, tr = trace.profile(
                lambda: program.simulate(model, write, {}))
            prints.append(program.fingerprint(state))
        mem_peak = torch.cuda.max_memory_allocated() if cuda else None
        ctx = dict(setup_s=setup_s, lower_s=lower_s, window_s=window_s,
                   elem_steps=sum(t["steps"] for t in timings)
                   * model.n_element, mem_window_peak=window_peak,
                   timings=timings, trace=tr, E=model.E, N=model.N,
                   dtype=spec["config"]["solver"]["dtype"],
                   fracture=model.fracture_enabled, steps_per_sim=steps)
        metrics = {}
        for m in (spec["per_layer"] if traced else spec["end_to_end"]):
            v = reader(m["name"], spec["root"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        numbers = dict(sims_differ=sum(p != prints[-1] for p in prints),
                       final_differs=program.differ(
                           returned, rec[chunks - 1, "end"]))
        rec = {k: program.deck_order(model, v) for k, v in rec.items()}
        del state, model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t = time.perf_counter()
        ref = reference_of(spec, deck, device)
        numbers["steps_differ"] = sum(t["steps"] != ref.steps
                                      for t in timings)
        numbers.update(check_chunks(ref, rec, sample, d_out,
                                    checked_dir if write else None))
        print(f"portbench: set-up {setup_s:.2f} s (lowering {lower_s:.2f}),"
              f" {len(timings)} simulations in {window_s:.2f} s, check of "
              f"chunks {sorted(sample)} {time.perf_counter() - t:.2f} s",
              file=sys.stderr)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(out_dir + ".checked", ignore_errors=True)

    limits = spec["cell"]["limits"]
    numbers = {k: v for k, v in numbers.items() if k in limits}
    correct = check.judge(numbers, limits)
    attempted = len(prints)
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else attempted, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda
                         else "cpu",
                         "count": 1,
                         "memory_peak_bytes": max(setup_peak, mem_peak)
                         if cuda else 0}}
    if tr is not None:
        result["device"]["busy_s"] = trace.busy_s(tr)
        result["device"]["window_s"] = trace.window_s(tr)
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = {k: {"value": v, "limit": limits.get(k)}
                        for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's caches stay inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    spec = cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {spec['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = measure(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print("portbench: the run imported " + ", ".join(found),
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
