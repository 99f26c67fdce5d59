#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``hakai_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
without its last line):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (nvidia-smi) and the torch/CUDA versions;
2. build: compiles ``hakai_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernels: each kernel instantiation against its plain PyTorch version on
   the card, at the main paths' shapes (the 32x32x128 bar), with random
   inputs that engage the plastic branch, a dead element and padding
   lanes: the element kernel in float32, float32 with the triaxiality
   output, float64, and mixed precision with the triaxiality output; the
   assembly in float32 and float32 -> float64 (mixed).  Kernel, plain and
   (assembly) ``index_add_`` times and the least time the card could take;
4. trajectory: 100 steps of a plastic 16x16x64 bar on the card (kernels)
   and on the CPU (plain versions), compared;
5. main path of the first slice: the 32x32x128 bar (131,072 elements,
   float32) stepped with ``run_chunk`` for 50 and 400 steps (slope timing,
   as bench.py times the JAX package), counting kernel launches, checking
   that repeat runs from one state are bitwise equal; then a profiler trace;
6. fracture: the ductile 8x8x32 bar in mixed precision, 500 steps one at a
   time on the card and on the CPU; the deletion histories compared;
7. main path of the second slice: the ductile 32x32x128 bar in mixed
   precision through ``run()`` on the card for 10,000 steps with 5 VTK
   frames, a checkpoint every other frame, the energy balance and the metrics
   stream; launches counted, frames checked against the alive count, the
   first deletion located exactly from the checkpoints; then a trace.

The line before the last is nvidia-smi's name and power limit; the one
before that the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

SEED = 20261016
NX, NY, NZ = 32, 32, 128          # bench.py's bar
N1, N2 = 50, 400                  # bench.py's chunk sizes
REPEATS = 5                       # slope pairs and kernel timing batches
# kernel vs plain version, normwise: max|kernel - plain| <= tol * max|plain|.
# Both evaluate the same formulas in another association order (FMA
# contraction, einsum order, Gauss-point sum order): ~100 dependent f32
# operations give ~1e-6, so 1e-5 keeps a 10x margin and stays orders below
# the error of any wrong term.  The assembly sums <= 8 terms.  Mixed
# precision runs the float32 math on the same float32 inputs (both take
# the float64 differences before one cast), so it keeps the float32 bound.
TOL = {("element", "float32"): 1e-5, ("element", "float64"): 1e-12,
       ("element", "mixed"): 1e-5,
       ("assemble", "float32"): 1e-6, ("assemble", "float64"): 1e-14,
       ("assemble", "mixed"): 1e-6}
# the triaxiality mean/vm is a quotient of two rounded sums whose
# deviatoric differences cancel: 10x the element bound
TRIAX_TOL = {"float32": 1e-4, "float64": 1e-11, "mixed": 1e-4}
# card (kernels, f32) vs CPU (plain versions, f32) after 100 plastic steps,
# normwise.  Two f32 runs that round differently part at the rate an f32
# run parts from an f64 one: 2.4e-6 (disp) and 7.1e-4 (stress) at 200
# steps on this bar, measured on the card and on a CPU; the limits are
# about 10x that.
TRAJ_STEPS = 100
TRAJ_TOL = {"disp": 2e-5, "P": 5e-3}
# [fracture]: card vs CPU deletion histories of the mixed ductile bar.
# The two runs take the same float32 math in another rounding order and
# part at the f32 rate, ~1e-3 relative in stress after a few hundred
# plastic steps (the trajectory phase).  Erosion compares mean eq_ps with
# the fracture strain, so only an element within that band of its
# threshold can be deleted some steps apart, or on one side only.  Rule:
# the first deletion steps differ by at most FRAC_STEPS; every element
# deleted by step FRAC_N on one side only is, on the side that keeps it,
# within FRAC_BAND (10x the band) of its fracture strain; and such
# elements are at most FRAC_SHARE of the deleted set.
FRAC_N, FRAC_STEPS, FRAC_BAND, FRAC_SHARE = 500, 5, 1e-2, 0.05
# [run]: the second slice's main path
RUN_END = 1e-4                    # 10,000 steps at d_time = 1e-8
RUN_FRAMES = 5
RUN_CKPT_EVERY = 2                # a checkpoint at frames 2 and 4
RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke_run")
# H100 SXM peaks (NVIDIA data sheet, dense, no tensor cores): HBM
# 3.35 TB/s; 67 TFLOP/s float32, 34 TFLOP/s float64.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "mixed": 67e12}
# element-kernel operations per element, counted from csrc/element.cu (an
# FMA counts 2): per Gauss-point thread J and Gdu 270, det/inverse 55,
# g 45, B-bar and trial 60, return map 45, strain and sums 30, force
# moments 100, Qe fold 144, triaxiality 20 -> ~770, x 8 threads
ELEMENT_FLOP = 6200


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def relerr(a, b) -> float:
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / (scale if scale > 0 else 1.0)


def time_ms(fn, reps=20, warm=3) -> float:
    """Median over REPEATS batches of the mean device time of one call.

    Before each call a 256 MB memset evicts the L2 cache (50 MB on an
    H100), so the call reads its inputs from device memory, as it does
    inside a step, where the element kernel streams ~110 MB between two
    assemblies; CUDA events on either side of the call time it alone.
    Each batch is queued behind a sleep kernel that outlasts the host's
    queueing of the batch, so no host launch cost enters the events (it
    exceeds the run time of the shorter kernels)."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def one(ev):
        flush.zero_()
        ev[0].record()
        fn()
        ev[1].record()

    def events():
        return [(torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = events()
    t = time.perf_counter()
    one(evs[0])                         # host time to queue one call
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    # cycles at up to 2 GHz: 1.5x the queueing time plus 1 ms, at most 1 s
    cycles = int(min(1.5 * reps * host_s + 1e-3, 1.0) * 2e9)
    out = []
    for _ in range(REPEATS):
        evs = events()
        torch.cuda._sleep(cycles)
        for ev in evs:
            one(ev)
        torch.cuda.synchronize()
        out.append(statistics.fmean(a.elapsed_time(b) for a, b in evs))
    return statistics.median(out)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, n_flop, kind):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_b, t_f = n_bytes / HBM_BPS, n_flop / PEAK_FLOPS[kind]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def kind_of(model) -> str:
    import torch
    if model.dtype != model.edtype:
        return "mixed"
    return "float32" if model.dtype == torch.float32 else "float64"


def with_padding(model, n_pad):
    """The model with its last ``n_pad`` elements turned into padding
    lanes (node ids 0, zero coordinates, no plasticity)."""
    elem = model.elem.clone()
    elem[:, -n_pad:] = 0
    coord_e = model.coord_e.clone()
    coord_e[..., -n_pad:] = 0
    hasp = model.has_plastic_e.clone()
    hasp[-n_pad:] = False
    return dataclasses.replace(model, elem=elem, coord_e=coord_e,
                               has_plastic_e=hasp)


def element_inputs(model, rng, device):
    """Random state that engages both return-map branches: stress ~300 MPa,
    yield in [755, 1055) around the trial von Mises stress, eq_ps across the
    hardening table, one dead element and 128 padding lanes.  P in the
    element dtype, disp/dprev in the nodal dtype."""
    import numpy as np
    import torch
    E, N = model.E, model.N
    disp = rng.normal(scale=1e-3, size=(3, N))
    dprev = disp + rng.normal(scale=2e-4, size=(3, N))
    P = np.concatenate([rng.normal(scale=300.0, size=(48, E)),
                        rng.normal(scale=1e-3, size=(6, E)),
                        np.zeros((2, E)),
                        rng.uniform(0.0, 0.3, size=(8, E)),
                        755.0 + rng.uniform(0.0, 300.0, size=(8, E))])
    flag = np.ones(E, bool)
    flag[3] = False
    flag[-128:] = False

    def t(a, dt):
        return torch.as_tensor(a, device=device).to(dt).contiguous()
    return (t(P, model.edtype), torch.as_tensor(flag, device=device),
            t(disp, model.dtype), t(dprev, model.dtype))


def check_element(model, rng, name, want_triax=False):
    """Kernel vs plain version on one random state; returns the JSON
    record's numbers."""
    import torch
    from hakai_tpu_torch.ops.element import element_core_packed_plain
    from hakai_tpu_torch.ops.element_cuda import element_core_packed
    P, flag, disp, dprev = element_inputs(model, rng, model.device)
    out_k = element_core_packed(model, P, flag, disp, dprev, want_triax)
    out_p = element_core_packed_plain(model, P, flag, disp, dprev, want_triax)
    torch.cuda.synchronize()
    (Pk, qk), (Pp, qp) = out_k[:2], out_p[:2]
    kind = kind_of(model)
    tol = TOL[("element", kind)]
    errs = {"stress": relerr(Pk[:48], Pp[:48]),
            "strain": relerr(Pk[48:54], Pp[48:54]),
            "eq_ps": relerr(Pk[56:64], Pp[56:64]),
            "yield": relerr(Pk[64:72], Pp[64:72]),
            "qe": relerr(qk, qp)}
    max_abs = max((Pk - Pp).abs().max().item(), (qk - qp).abs().max().item())
    msg = ""
    if want_triax:
        terr = relerr(out_k[2], out_p[2])
        max_abs = max(max_abs, (out_k[2] - out_p[2]).abs().max().item())
        msg = f" triax={terr:.3e} (tol {TRIAX_TOL[kind]:g})"
        if not terr <= TRIAX_TOL[kind]:
            raise AssertionError(f"element kernel triax disagrees: {terr}")
    plastic = (Pp[56:64] != P[56:64]).double().mean().item()
    log(f"[kernels] element {name} {kind} E={model.E}: rel errs "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {tol:g}){msg}; max_abs={max_abs:.3e}; plastic GP share "
        f"{plastic:.3f}")
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"element kernel disagrees: {bad}")
    if not 0.05 < plastic < 0.95:
        raise AssertionError(f"inputs do not engage both branches: {plastic}")
    if Pk[54:56].abs().max().item() != 0.0:
        raise AssertionError("P rows 54:56 are not zero")
    if qk[:, ~flag].abs().max().item() != 0.0:
        raise AssertionError("dead/padding lanes carry force")
    rec = {"max_abs_err": max_abs}
    rec["ms"] = time_ms(lambda: element_core_packed(model, P, flag, disp,
                                                    dprev, want_triax))
    rec["plain_ms"] = time_ms(lambda: element_core_packed_plain(
        model, P, flag, disp, dprev, want_triax), reps=5)
    moved = nbytes(model.elem, model.coord_e, disp, dprev, P, model.G_e,
                   model.lam_e, model.mat_id, model.has_plastic_e, flag,
                   model.hard_strain, model.hard_slope, model.hard_n,
                   *out_k)
    rec["bound_ms"], rec["bound_by"] = bound(moved, ELEMENT_FLOP * model.E,
                                             kind)
    rec["library_ms"] = None
    log(f"[kernels] element {name} {kind}{' +triax' if want_triax else ''}: "
        f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {moved / 1e6:.1f} MB,"
        f" {ELEMENT_FLOP * model.E / 1e9:.2f} GFLOP)")
    return rec


def check_assemble(model, rng, name, out_dtype=None):
    import torch
    from hakai_tpu_torch.ops.assemble_cuda import assemble_internal_force
    from hakai_tpu_torch.ops.element import assemble_internal_force_plain
    qe = torch.as_tensor(rng.normal(scale=100.0, size=(24, model.E)),
                         device=model.device).to(model.edtype).contiguous()
    out_dtype = qe.dtype if out_dtype is None else out_dtype
    Qk = assemble_internal_force(model, qe, out_dtype)
    Qp = assemble_internal_force_plain(model, qe).to(out_dtype)
    torch.cuda.synchronize()
    kind = kind_of(model)
    tol = TOL[("assemble", kind)]
    err = relerr(Qk, Qp)
    max_abs = (Qk - Qp).abs().max().item()
    log(f"[kernels] assemble {name} {kind} N={model.N}: {qe.dtype} -> "
        f"{Qk.dtype}, rel err {err:.3e} (tol {tol:g}); max_abs={max_abs:.3e}")
    if Qk.dtype != out_dtype:
        raise AssertionError(f"assembly wrote {Qk.dtype}, not {out_dtype}")
    if not err <= tol:
        raise AssertionError(f"assembly kernel disagrees: {err}")
    if not torch.equal(Qk, assemble_internal_force(model, qe, out_dtype)):
        raise AssertionError("assembly kernel is not deterministic")
    rec = {"max_abs_err": max_abs}
    rec["ms"] = time_ms(lambda: assemble_internal_force(model, qe,
                                                        out_dtype))
    rec["plain_ms"] = time_ms(
        lambda: assemble_internal_force_plain(model, qe).to(out_dtype),
        reps=10)
    # one PyTorch call for the same sum (another order): index_add_ of the
    # (3, 8E) qe columns into the nodes of elem, in qe's dtype
    idx = model.elem.flatten().long()
    src = qe.view(3, 8 * model.E)
    Q0 = torch.zeros((3, model.N), dtype=qe.dtype, device=qe.device)
    lib = Q0.clone().index_add_(1, idx, src)
    rec["library_err"] = relerr(lib.to(out_dtype), Qp)
    rec["library_ms"] = time_ms(lambda: Q0.clone().index_add_(1, idx, src))
    moved = nbytes(qe, model.inc_idx, model.inc_mask, Qk)
    rec["bound_ms"], rec["bound_by"] = bound(moved, 24 * model.E, kind)
    log(f"[kernels] assemble {name} {kind}: kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, index_add_ {rec['library_ms']:.4f} ms "
        f"(rel err {rec['library_err']:.1e}), bound {rec['bound_ms']:.4f} ms"
        f" ({rec['bound_by']}: {moved / 1e6:.1f} MB)")
    return rec


def trajectory():
    import torch
    from hakai_tpu_torch import SolverConfig, init_state, lower, run_chunk
    from hakai_tpu_torch.pre.synthetic import bar_model
    from hakai_tpu_torch.solver.explicit import pack_gauss_state
    bar = bar_model(16, 16, 64, d_time=5e-8, end_time=1e-4)
    out = {}
    for dev, dt in (("cuda", "float32"), ("cpu", "float32"),
                    ("cpu", "float64")):
        m = lower(bar, SolverConfig(dtype=dt), device=dev)
        t0 = time.perf_counter()
        s = run_chunk(m, init_state(m), TRAJ_STEPS)
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"[trajectory] {dev} {dt}: {TRAJ_STEPS} steps in "
            f"{time.perf_counter() - t0:.2f} s")
        out[(dev, dt)] = (s.disp.cpu().double(),
                          pack_gauss_state(s).cpu().double(), s)
    (dg, Pg, sg), (dc, Pc, _), (d64, P64, _) = (
        out[("cuda", "float32")], out[("cpu", "float32")],
        out[("cpu", "float64")])
    errs = {"disp": relerr(dg, dc), "P": relerr(Pg, Pc)}
    env = {"disp": relerr(dc, d64), "P": relerr(Pc, P64)}
    eq_max = sg.eq_ps.max().item()
    log(f"[trajectory] cuda vs cpu (f32): disp {errs['disp']:.3e} "
        f"P {errs['P']:.3e} (tol {TRAJ_TOL}); cpu f32 vs f64: disp "
        f"{env['disp']:.3e} P {env['P']:.3e}; eq_ps max {eq_max:.4f}")
    if not all(torch.isfinite(x).all() for x in (dg, Pg)):
        raise AssertionError("trajectory is not finite")
    if not eq_max > 0:
        raise AssertionError("trajectory did not engage plasticity")
    bad = {k: v for k, v in errs.items() if not v <= TRAJ_TOL[k]}
    if bad:
        raise AssertionError(f"card and CPU trajectories part: {bad}")


def reset_counts():
    from hakai_tpu_torch.ops.assemble_cuda import assemble_internal_force
    from hakai_tpu_torch.ops.element_cuda import element_core_packed
    for fn in (element_core_packed, assemble_internal_force):
        fn.launches = 0
        for k in fn.launches_by:
            fn.launches_by[k] = 0


def read_counts() -> dict:
    from hakai_tpu_torch.ops.assemble_cuda import assemble_internal_force
    from hakai_tpu_torch.ops.element_cuda import element_core_packed
    return {"element": element_core_packed.launches,
            "assemble": assemble_internal_force.launches,
            **{f"element[{k}]": v
               for k, v in element_core_packed.launches_by.items() if v},
            **{f"assemble[{k}]": v
               for k, v in assemble_internal_force.launches_by.items() if v}}


def main_path(model, smi_line):
    import torch
    from hakai_tpu_torch import init_state, run_chunk
    state0 = init_state(model)

    def run_sync(k):
        t0 = time.perf_counter()
        s = run_chunk(model, state0, k)
        _ = float(s.disp.sum())         # scalar readback forces completion
        return s, time.perf_counter() - t0

    run_sync(N1)                        # warm-up (allocator, first launches)
    reset_counts()
    per_step, runs = [], []
    for _ in range(REPEATS):
        s1, t1 = run_sync(N1)
        s2, t2 = run_sync(N2)
        per_step.append((t2 - t1) / (N2 - N1))
        runs.append(s2)
    launches = read_counts()
    steps = REPEATS * (N1 + N2)
    log(f"[main] launches {launches} for {steps} steps")
    if (launches["element"] != steps or launches["assemble"] != steps
            or launches.get("element[float32]") != steps):
        raise AssertionError(f"kernel launches {launches} != steps {steps}")
    fields = ("disp", "velo", "Q", "stress", "strain", "eq_ps", "yield_s",
              "triax")
    for name, s in (("n1", s1), ("n2", s2)):
        for f in fields:
            if not torch.isfinite(getattr(s, f)).all():
                raise AssertionError(f"{name} run: {f} is not finite")
    if int(s2.t) != N2 or tuple(s2.disp.shape) != (3, model.N):
        raise AssertionError("main path state has the wrong step or shape")
    if not all(torch.equal(getattr(runs[0], f), getattr(s, f))
               for s in runs[1:] for f in fields):
        raise AssertionError("runs from one state are not bitwise equal")
    top = s2.disp[2][model.bcd_amp[2] == 0].mean().item()
    us = sorted(x * 1e6 for x in per_step)
    med = statistics.median(us)
    log(f"[main] {model.n_element} elements, N={model.N}, slope of "
        f"T({N2}) - T({N1}) over {REPEATS} pairs: median {med:.2f} us/step "
        f"(min {us[0]:.2f}, max {us[-1]:.2f}) -> "
        f"hex8_element_steps_per_sec={model.n_element / med * 1e6:.6e}; "
        f"{REPEATS} runs bitwise equal; pulled-face uz {top:.6e} "
        f"[{smi_line}]")
    return launches, s2, med


def trace(model, state, smi_line, tag, n=40):
    """Device time per step by kernel, from torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hakai_tpu_torch import run_chunk
    run_chunk(model, state, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_chunk(model, state, n)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / n
    by_name = {}
    for e in dev:
        key = "element_kernel" if "element_kernel" in e.name else \
            "assemble_kernel" if "assemble_kernel" in e.name else "PyTorch ops"
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / n
    log(f"[trace] {tag}: {n} steps: {len(dev) / n:.1f} device kernels/step, "
        f"device busy {busy:.2f} us/step: "
        + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(by_name.items()))
        + f" [{smi_line}]")
    return busy


def fracture_margin(model, state):
    """(E,) mean eq_ps over the fracture strain at the mean triaxiality
    (1 = at the threshold; 0 where the triaxiality is negative)."""
    import torch
    from hakai_tpu_torch.ops.erosion import element_means, fracture_strain
    v_e, t_e = element_means(state.eq_ps, state.triax)
    return torch.where(t_e >= 0, v_e / fracture_strain(model, t_e), 0.0)


def fracture():
    """The ductile 8x8x32 bar in mixed precision, one step at a time to
    step FRAC_N on the card and on the CPU: the deletion histories."""
    import numpy as np
    import torch
    from hakai_tpu_torch import SolverConfig, init_state, lower, run_chunk
    from hakai_tpu_torch.pre.synthetic import bar_model
    from hakai_tpu_torch.solver.explicit import pack_gauss_state
    bar = bar_model(8, 8, 32, d_time=5e-8, end_time=1e-4, ductile=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = lower(bar, SolverConfig(dtype="mixed"), device=dev)
        s = init_state(m)
        died = np.full(m.E, -1)
        exists = m.elem_exists.cpu().numpy()
        t0 = time.perf_counter()
        for step in range(1, FRAC_N + 1):
            s = run_chunk(m, s, 1)
            flag = s.element_flag.cpu().numpy()
            died[(died < 0) & ~flag & exists] = step
        log(f"[fracture] {dev}: {FRAC_N} steps in "
            f"{time.perf_counter() - t0:.2f} s; first deletion at step "
            f"{died[died > 0].min() if (died > 0).any() else None}, "
            f"{(died > 0).sum()} of {m.n_element} deleted")
        runs[dev] = (m, s, died)
    (mg, sg, dg), (mc, sc, dc) = runs["cuda"], runs["cpu"]
    if not (dc > 0).any():
        raise AssertionError("the CPU run deleted no element")
    errs = {"disp": relerr(sg.disp.cpu(), sc.disp),
            "P": relerr(pack_gauss_state(sg).cpu().double(),
                        pack_gauss_state(sc).double())}
    only = np.nonzero((dg > 0) != (dc > 0))[0]
    margin = {"cuda": fracture_margin(mg, sg).cpu().numpy(),
              "cpu": fracture_margin(mc, sc).numpy()}
    # on the side that keeps the element, how close it is to its threshold
    keep = [margin["cuda"][e] if dg[e] < 0 else margin["cpu"][e]
            for e in only]
    same_step = ((dg > 0) & (dc > 0) & (dg == dc)).sum()
    first = (dg[dg > 0].min() if (dg > 0).any() else -1, dc[dc > 0].min())
    log(f"[fracture] card vs cpu at step {FRAC_N}: disp {errs['disp']:.3e} "
        f"P {errs['P']:.3e}; first deletion {first[0]} vs {first[1]}; "
        f"deleted {(dg > 0).sum()} vs {(dc > 0).sum()}, {same_step} at the "
        f"same step, {len(only)} on one side only (margins on the keeping "
        f"side: {[round(float(x), 5) for x in keep]}); rule: first steps "
        f"within {FRAC_STEPS}, one-sided elements within {FRAC_BAND:g} of "
        f"their fracture strain and <= {FRAC_SHARE:g} of the deleted set")
    if not torch.isfinite(sg.disp).all():
        raise AssertionError("card fracture run is not finite")
    if abs(int(first[0]) - int(first[1])) > FRAC_STEPS:
        raise AssertionError(f"first deletions part: {first}")
    if any(not x >= 1.0 - FRAC_BAND for x in keep) or \
            len(only) > FRAC_SHARE * (dc > 0).sum():
        raise AssertionError(f"deleted sets part beyond the f32 band: "
                             f"{only.tolist()} margins {keep}")


def vtk_cells(path) -> int:
    with open(path) as f:
        for line in f:
            if line.startswith("CELLS "):
                return int(line.split()[1])
    raise AssertionError(f"{path} has no CELLS line")


def second_path(model, smi_line):
    """run() on the card: the ductile bar, mixed, RUN_FRAMES frames, a
    checkpoint every RUN_CKPT_EVERY frames, energy balance and metrics."""
    import torch
    from hakai_tpu_torch import init_state, run, run_chunk
    from hakai_tpu_torch.utils.checkpoint import load_checkpoint
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    os.makedirs(RUN_DIR)
    timings = {}
    reset_counts()
    t0 = time.perf_counter()
    final = run(model, timings=timings)
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps = model.time_num
    log(f"\n[run] launches {launches} for {steps} steps")
    if (launches["element"] != steps or launches["assemble"] != steps
            or launches.get("element[mixed+triax]") != steps
            or launches.get("assemble[hk_assemble_f32_f64]") != steps):
        raise AssertionError(f"kernel launches {launches} != steps {steps}")
    for f in ("disp", "velo", "Q", "stress", "eq_ps", "triax"):
        if not torch.isfinite(getattr(final, f)).all():
            raise AssertionError(f"[run] {f} is not finite")
    alive = int(final.element_flag.sum())
    frames = sorted(p for p in os.listdir(RUN_DIR) if p.endswith(".vtk"))
    cells = [vtk_cells(os.path.join(RUN_DIR, p)) for p in frames]
    with open(os.path.join(RUN_DIR, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    d_out = steps // RUN_FRAMES
    by_step = {r["step"]: int(r["alive_elements"]) for r in recs}
    want = [model.n_element] + [by_step[i * d_out]
                                for i in range(1, len(frames))]
    log(f"[run] frames {frames} + collection.pvd "
        f"{os.path.exists(os.path.join(RUN_DIR, 'collection.pvd'))}; "
        f"CELLS {cells}, alive by metrics {want}; energy_rel_error "
        f"{recs[-1]['energy_rel_error']:.3e}; eq_ps max "
        f"{recs[-1]['eq_plastic_strain_max']:.4f}")
    if len(frames) != RUN_FRAMES + 1 or cells != want:
        raise AssertionError(f"frames {frames} with CELLS {cells} != {want}")
    if cells[-1] != alive or alive >= model.n_element:
        raise AssertionError(f"no element deleted ({alive} alive)")
    # the first deletion, exactly: from the last checkpoint before the
    # first frame with a deletion, one step at a time (chunks compose
    # bitwise, so this retraces the run)
    k = next(i for i, c in enumerate(cells) if c < model.n_element)
    ckpts = sorted(p for p in os.listdir(RUN_DIR) if p.startswith("ckpt_"))
    if ckpts != [f"ckpt_{i:03d}.npz" for i in range(
            RUN_CKPT_EVERY, RUN_FRAMES + 1, RUN_CKPT_EVERY)]:
        raise AssertionError(f"checkpoints {ckpts}")
    ck = (k - 1) // RUN_CKPT_EVERY * RUN_CKPT_EVERY
    s = (init_state(model) if ck == 0 else load_checkpoint(
        os.path.join(RUN_DIR, f"ckpt_{ck:03d}.npz"), init_state(model)))
    while int(s.element_flag.sum()) == model.n_element:
        s = run_chunk(model, s, 1)
    first = int(s.t)
    if not (k - 1) * d_out < first <= k * d_out:
        raise AssertionError(f"first deletion {first} outside frame {k}")
    us = timings["step_s"] / timings["steps"] * 1e6
    log(f"[run] {model.n_element} elements mixed ductile, {steps} steps: "
        f"step loop {timings['step_s']:.2f} s = {us:.2f} us/step "
        f"({model.n_element / us * 1e6:.6e} elem-steps/s) without frame "
        f"output; {timings['frames']} frames in {timings['frame_s']:.2f} s; "
        f"run() wall {wall:.2f} s; first deletion at step {first}, "
        f"{alive} of {model.n_element} alive at step {steps} "
        f"[{smi_line}]")
    return launches, final, us


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import hakai_tpu_torch  # noqa: F401  (fails outside a checkout)
    from hakai_tpu_torch import SolverConfig, _build, lower
    from hakai_tpu_torch.pre.synthetic import bar_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi_line = smi()
    log(f"[device] {smi_line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {_build.BUILD_INFO['path']} built="
        f"{_build.BUILD_INFO['built']} in {time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")

    rng = np.random.default_rng(SEED)
    models = {}
    for kind, ductile, end in (("float32", False, 1.0),
                               ("float64", False, 1.0),
                               ("mixed", True, RUN_END)):
        t0 = time.perf_counter()
        cfg = SolverConfig(dtype=kind, node_pad=128, elem_pad=128)
        if kind == "mixed":
            cfg = SolverConfig(dtype=kind, output_num=RUN_FRAMES,
                               energy_check=True,
                               checkpoint_every=RUN_CKPT_EVERY,
                               out_dir=RUN_DIR,
                               metrics_path=os.path.join(RUN_DIR,
                                                         "metrics.jsonl"))
        models[kind] = m = lower(bar_model(nx=NX, ny=NY, nz=NZ, d_time=1e-8,
                                           end_time=end, ductile=ductile),
                                 cfg, device="cuda")
        torch.cuda.synchronize()
        log(f"[lower] {NX}x{NY}x{NZ} bar {kind} ductile={ductile}: E={m.E} "
            f"N={m.N} V={m.inc_idx.shape[0]} renumbered="
            f"{m.node_new2old is not None} in "
            f"{time.perf_counter() - t0:.2f} s")
    bench, bench64, mixed = (models[k] for k in ("float32", "float64",
                                                 "mixed"))

    rec = {
        "f32": check_element(with_padding(bench, 128), rng, "bench"),
        "f32_triax": check_element(with_padding(bench, 128), rng, "bench",
                                   want_triax=True),
        "f64": check_element(with_padding(bench64, 128), rng, "bench"),
        "mixed": check_element(with_padding(mixed, 128), rng, "bench",
                               want_triax=True),
        "asm_f32": check_assemble(bench, rng, "bench"),
        "asm_f64": check_assemble(bench64, rng, "bench"),
        "asm_mixed": check_assemble(mixed, rng, "bench", torch.float64),
    }
    del bench64, models

    trajectory()
    launches1, final, step_us = main_path(bench, smi_line)
    busy_us = trace(bench, final, smi_line, "float32 elastic")
    log(f"[trace] float32 elastic: device idle share "
        f"{1.0 - busy_us / step_us:.4f} of the median untraced step "
        f"({busy_us:.2f} of {step_us:.2f} us)")

    fracture()
    launches2, final2, run_us = second_path(mixed, smi_line)
    busy2 = trace(mixed, final2, smi_line, "mixed ductile")
    log(f"[trace] mixed ductile: device idle share "
        f"{1.0 - busy2 / run_us:.4f} of the run() step ({busy2:.2f} of "
        f"{run_us:.2f} us)")

    if any(k.split(".")[0] in ("jax", "jaxlib", "hakai_tpu")
           for k in sys.modules):
        raise AssertionError("the port's smoke run imported jax or the JAX "
                             "package")
    src = "hakai_tpu/ops/element_pallas.py"

    def entry(name, source, replaces, count, r):
        # launches: the variant's launches in the two main-path runs
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": launches1.get(count, 0) + launches2.get(count, 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
    el, asm = ("hakai_tpu_torch/csrc/element.cu",
               "hakai_tpu_torch/csrc/assemble.cu")
    # the instantiations the two main paths run, and the float64 element
    # one, which neither runs (its launches are 0); the float32+triax
    # element and float64 assembly instantiations are checked and timed in
    # [kernels] and reported on its lines
    kernels = [
        entry("element_core_packed[float32]", el, f"{src}:210",
              "element[float32]", rec["f32"]),
        entry("element_core_packed[float64]", el,
              "hakai_tpu/ops/element.py:389 (XLA; no TPU kernel takes f64)",
              "element[float64]", rec["f64"]),
        entry("element_core_packed[mixed+triax]", el,
              f"{src}:561 and {src}:93", "element[mixed+triax]",
              rec["mixed"]),
        entry("assemble_internal_force[float32]", asm,
              "hakai_tpu/ops/gather_pallas.py:413",
              "assemble[hk_assemble_f32]", rec["asm_f32"]),
        entry("assemble_internal_force[float32->float64]", asm,
              "hakai_tpu/ops/gather_pallas.py:413",
              "assemble[hk_assemble_f32_f64]", rec["asm_mixed"]),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
