#!/usr/bin/env python3
"""Readings that set the limits of a cell's check.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--control 3] [--fault <name> ...] [--faulted 3] [--device cuda]

For each seed: one whole simulation of the cell's deck through the program
as the configuration states it; for the first ``--control`` seeds, one
through the program's own float32 path (``dtype="float32"``, the
precision below the configuration's mixed float64/float32: the control);
and for the first ``--faulted`` seeds, one with each ``--fault`` planted
(``portbench/faults.py``).  Each is checked over the cell's sampled chunks
against the plain reference, as the benchmark checks the window's first
simulation.  One JSON line a seed: the numbers of each simulation, and
each sampled chunk's under ``<name>_chunks``.  The lower reading of a
number is the largest the program gives over the seeds, the upper one the
smallest the control or a fault gives; the limit lies between them.  No
run of the benchmark runs this.
"""
import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import faults, program  # noqa: E402
from portbench.run import (cell_spec, check_chunks, chunk_sample,  # noqa: E402
                           deck_of, reference_of, solver_of)


def readings(spec, seed, control: bool, device="cuda", out_root=None,
             planted=()) -> dict:
    """The numbers of the program (and of the control, and of the program
    with each fault in ``planted``) on ``seed``: one simulation each,
    checked over the cell's sampled chunks as a run of the benchmark
    checks the window's first simulation."""
    deck = deck_of(spec, seed)
    write = bool(spec["traffic"]["write_output"])
    dtype = spec["config"]["solver"]["dtype"]
    runs = [("program", dtype, None)] + \
        ([("control", "float32", None)] if control else []) + \
        [(f"fault_{f}", dtype, f) for f in planted]
    out = {"seed": seed}
    for name, dt, fault in runs:
        out_dir = tempfile.mkdtemp(prefix="portbench-", dir=out_root)
        try:
            model = program.lower(deck, solver_of(spec, dtype=dt), out_dir,
                                  device)
            steps = model.time_num
            d_out = max(steps // model.config.output_num, 1)
            sample = chunk_sample(-(-steps // d_out),
                                  spec["cell"]["check_chunks"], seed,
                                  spec["cell"].get("check_within"))
            tm = {}
            with contextlib.ExitStack() as stack:
                if fault:
                    stack.enter_context(faults.planted(fault))
                rec = stack.enter_context(program.recorded_chunks(sample))
                state = program.simulate(model, write, tm)
            rec = {k: program.deck_order(model, v) for k, v in rec.items()}
            del model, state
            ref = reference_of(spec, deck, device)
            rows = []
            nums = check_chunks(ref, rec, sample, d_out,
                                out_dir if write else None, rows)
            nums["steps_differ"] = int(tm["steps"] != ref.steps)
            nums["alive"] = int(rec[max(sample), "end"]["alive"].sum())
            out[name] = nums
            out[name + "_chunks"] = rows
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", nargs="*", default=[],
                    choices=sorted(faults.FAULTS))
    ap.add_argument("--faulted", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    for k, seed in enumerate(args.seeds):
        t = time.perf_counter()
        out = readings(spec, seed, k < args.control, args.device,
                       planted=args.fault if k < args.faulted else ())
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
