#!/usr/bin/env python3
"""The full-width impact deck of ``chip_smoke.py``'s ``[contact]`` phase
(``impact_model(n=48, d_time=1e-9, end_time=5e-6)``, mixed precision) at
the impact speeds given, on one GPU, without frames: for each ``v0`` the
first contact and the first deletion (to the chunk), the largest
equivalent plastic strain, and the elements alive at the deck's last step.

    python3 scripts/impact_v0_probe.py [v0 ...]        (default: 8e4)

It tells whether a speed erodes the cube by the end of the deck
(the fracture strain of its ductile table is 0.3).
"""
import os
import subprocess
import sys
import time

CHUNK = 50                         # steps between two reads of the state


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("impact_v0_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hakai_tpu_torch import SolverConfig, init_state, lower, run_chunk
    from hakai_tpu_torch.pre.synthetic import impact_model
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for v0 in [float(a) for a in argv] or [8.0e4]:
        m = lower(impact_model(n=48, v0=v0, d_time=1e-9, end_time=5e-6),
                  SolverConfig(dtype="mixed"), device="cuda")
        s = init_state(m)
        contact = deleted = None
        t0 = time.perf_counter()
        for step in range(CHUNK, m.time_num + 1, CHUNK):
            s = run_chunk(m, s, CHUNK)
            if contact is None and bool(s.contact_force.abs().max() > 0):
                contact = step
            if deleted is None and int(s.element_flag.sum()) < m.n_element:
                deleted = step
        torch.cuda.synchronize()
        print(f"[v0 {v0:g}] {m.time_num} steps in "
              f"{time.perf_counter() - t0:.2f} s; first contact by step "
              f"{contact}, first deletion by step {deleted} ({CHUNK}-step "
              f"chunks); eq_ps max {float(s.eq_ps.max()):.4f}; "
              f"{int(s.element_flag.sum())} of {m.n_element} alive at step "
              f"{int(s.t)}; finite {bool(torch.isfinite(s.disp).all())} "
              f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
