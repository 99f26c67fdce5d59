#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``hakai_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
without its last line):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (nvidia-smi) and the torch/CUDA versions;
2. build: compiles ``hakai_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (the 32x32x128 bar), with random inputs that
   engage the plastic branch, a dead element and padding lanes; plus a
   float64 case;
4. trajectory: 200 steps of a plastic 16x16x64 bar on the card (kernels)
   and on the CPU (plain versions), compared;
5. main path: the 32x32x128 bar (131,072 elements, float32) lowered on the
   card and stepped with ``run_chunk`` for 50 and 400 steps (slope timing,
   as bench.py times the JAX package), counting kernel launches, checking
   that two runs from one state are bitwise equal.

The line before the last is nvidia-smi's name and power limit; the one
before that the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""
import dataclasses
import json
import os
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
# the error of any wrong term.  The assembly sums <= 8 terms.
TOL = {("element", "float32"): 1e-5, ("element", "float64"): 1e-12,
       ("assemble", "float32"): 1e-6, ("assemble", "float64"): 1e-14}
# card (kernels, f32) vs CPU (plain versions, f32) after 200 plastic steps,
# normwise.  Two f32 runs that round differently part at the rate an f32
# run parts from an f64 one: 2.4e-6 (disp) and 5.2e-4 (stress) on this bar,
# measured with the plain versions on a CPU; the limits are 10x that.
TRAJ_TOL = {"disp": 2e-5, "P": 5e-3}


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
    """Median over REPEATS batches of the mean time of ``reps`` launches,
    by CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    out = []
    for _ in range(REPEATS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1) / reps)
    return statistics.median(out)


def with_padding(model, n_pad):
    """The bench model with its last ``n_pad`` elements turned into
    padding lanes (node ids 0, zero coordinates, no plasticity)."""
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
    hardening table, one dead element and 128 padding lanes."""
    import numpy as np
    import torch
    E, N = model.E, model.N
    dt = model.dtype

    def t(a):
        return torch.as_tensor(a, device=device).to(dt)
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
    return (t(P).contiguous(), torch.as_tensor(flag, device=device),
            t(disp).contiguous(), t(dprev).contiguous())


def check_element(model, rng, name, plain_too=True):
    import torch
    from hakai_tpu_torch.ops.element import element_core_packed_plain
    from hakai_tpu_torch.ops.element_cuda import element_core_packed
    P, flag, disp, dprev = element_inputs(model, rng, model.device)
    Pk, qk = element_core_packed(model, P, flag, disp, dprev)
    Pp, qp = element_core_packed_plain(model, P, flag, disp, dprev)
    torch.cuda.synchronize()
    dt = str(model.dtype).split(".")[-1]
    tol = TOL[("element", dt)]
    errs = {"stress": relerr(Pk[:48], Pp[:48]),
            "strain": relerr(Pk[48:54], Pp[48:54]),
            "eq_ps": relerr(Pk[56:64], Pp[56:64]),
            "yield": relerr(Pk[64:72], Pp[64:72]),
            "qe": relerr(qk, qp)}
    max_abs = max((Pk - Pp).abs().max().item(), (qk - qp).abs().max().item())
    plastic = (Pp[56:64] != P[56:64]).double().mean().item()
    log(f"[kernels] element {name} {dt} E={model.E}: rel errs "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {tol:g}); max_abs={max_abs:.3e}; plastic GP share "
        f"{plastic:.3f}")
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"element kernel disagrees: {bad}")
    if not 0.05 < plastic < 0.95:
        raise AssertionError(f"inputs do not engage both branches: {plastic}")
    if Pk[54:56].abs().max().item() != 0.0:
        raise AssertionError("P rows 54:56 are not zero")
    dead = ~flag
    if qk[:, dead].abs().max().item() != 0.0:
        raise AssertionError("dead/padding lanes carry force")
    out = {"max_abs_err": max_abs}
    if plain_too:
        out["ms"] = time_ms(lambda: element_core_packed(model, P, flag, disp,
                                                        dprev))
        out["plain_ms"] = time_ms(lambda: element_core_packed_plain(
            model, P, flag, disp, dprev), reps=5)
        log(f"[kernels] element {name}: kernel {out['ms']:.4f} ms, plain "
            f"{out['plain_ms']:.4f} ms")
    return out


def check_assemble(model, rng, name, plain_too=True):
    import torch
    from hakai_tpu_torch.ops.assemble_cuda import assemble_internal_force
    from hakai_tpu_torch.ops.element import assemble_internal_force_plain
    qe = torch.as_tensor(rng.normal(scale=100.0, size=(24, model.E)),
                         device=model.device).to(model.dtype).contiguous()
    Qk = assemble_internal_force(model, qe)
    Qp = assemble_internal_force_plain(model, qe)
    torch.cuda.synchronize()
    dt = str(model.dtype).split(".")[-1]
    tol = TOL[("assemble", dt)]
    err = relerr(Qk, Qp)
    max_abs = (Qk - Qp).abs().max().item()
    log(f"[kernels] assemble {name} {dt} N={model.N}: rel err {err:.3e} "
        f"(tol {tol:g}); max_abs={max_abs:.3e}")
    if not err <= tol:
        raise AssertionError(f"assembly kernel disagrees: {err}")
    out = {"max_abs_err": max_abs}
    if plain_too:
        out["ms"] = time_ms(lambda: assemble_internal_force(model, qe))
        out["plain_ms"] = time_ms(
            lambda: assemble_internal_force_plain(model, qe), reps=10)
        log(f"[kernels] assemble {name}: kernel {out['ms']:.4f} ms, plain "
            f"{out['plain_ms']:.4f} ms")
    return out


def trajectory():
    import torch
    from hakai_tpu.config import SolverConfig
    from hakai_tpu.pre.synthetic import bar_model
    from hakai_tpu_torch import init_state, lower, run_chunk
    from hakai_tpu_torch.solver.explicit import pack_gauss_state
    bar = bar_model(16, 16, 64, d_time=5e-8, end_time=1e-4)
    out = {}
    for dev, dt in (("cuda", "float32"), ("cpu", "float32"),
                    ("cpu", "float64")):
        m = lower(bar, SolverConfig(dtype=dt), device=dev)
        t0 = time.perf_counter()
        s = run_chunk(m, init_state(m), 200)
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"[trajectory] {dev} {dt}: 200 steps in "
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


def main_path(model, smi_line):
    import torch
    from hakai_tpu_torch import init_state, run_chunk
    from hakai_tpu_torch.ops.assemble_cuda import assemble_internal_force
    from hakai_tpu_torch.ops.element_cuda import element_core_packed
    state0 = init_state(model)

    def run_sync(k):
        t0 = time.perf_counter()
        s = run_chunk(model, state0, k)
        _ = float(s.disp.sum())         # scalar readback forces completion
        return s, time.perf_counter() - t0

    run_sync(N1)                        # warm-up (allocator, first launches)
    element_core_packed.launches = 0
    assemble_internal_force.launches = 0
    per_step, runs = [], []
    for _ in range(REPEATS):
        s1, t1 = run_sync(N1)
        s2, t2 = run_sync(N2)
        per_step.append((t2 - t1) / (N2 - N1))
        runs.append(s2)
    launches = {"element": element_core_packed.launches,
                "assemble": assemble_internal_force.launches}
    steps = REPEATS * (N1 + N2)
    log(f"[main] launches {launches} for {steps} steps")
    if launches != {"element": steps, "assemble": steps}:
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


def trace(model, state, smi_line, n=40):
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
    log(f"[trace] {n} steps: {len(dev) / n:.1f} device kernels/step, device "
        f"busy {busy:.2f} us/step: "
        + ", ".join(f"{k} {v:.2f} us" for k, v in sorted(by_name.items()))
        + f" [{smi_line}]")
    return busy


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import hakai_tpu_torch  # noqa: F401  (fails outside a checkout)
    from hakai_tpu.config import SolverConfig
    from hakai_tpu.pre.synthetic import bar_model
    from hakai_tpu_torch import _build, lower

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    t0 = time.perf_counter()
    bench = lower(bar_model(nx=NX, ny=NY, nz=NZ, d_time=1e-8, end_time=1.0),
                  SolverConfig(dtype="float32", node_pad=128, elem_pad=128),
                  device="cuda")
    torch.cuda.synchronize()
    log(f"[lower] {NX}x{NY}x{NZ} bar: E={bench.E} N={bench.N} "
        f"V={bench.inc_idx.shape[0]} renumbered="
        f"{bench.node_new2old is not None} in "
        f"{time.perf_counter() - t0:.2f} s")

    rec_el = check_element(with_padding(bench, 128), rng, "bench")
    rec_as = check_assemble(bench, rng, "bench")
    log(f"[kernels] at bench shape on {smi_line}: element kernel "
        f"{rec_el['ms']:.4f} ms vs plain {rec_el['plain_ms']:.4f} ms; "
        f"assembly kernel {rec_as['ms']:.4f} ms vs plain "
        f"{rec_as['plain_ms']:.4f} ms")
    small64 = lower(bar_model(8, 8, 32, d_time=1e-8, end_time=1.0),
                    SolverConfig(dtype="float64"), device="cuda")
    check_element(small64, rng, "8x8x32", plain_too=False)
    check_assemble(small64, rng, "8x8x32", plain_too=False)

    trajectory()
    launches, final, step_us = main_path(bench, smi_line)
    busy_us = trace(bench, final, smi_line)
    log(f"[trace] device idle share {1.0 - busy_us / step_us:.4f} of the "
        f"median untraced step ({busy_us:.2f} of {step_us:.2f} us)")

    if "jax" in sys.modules:
        raise AssertionError("the port's smoke run imported jax")
    kernels = [
        {"name": "element_core_packed", "route": "cuda",
         "source": "hakai_tpu_torch/csrc/element.cu",
         "replaces": "hakai_tpu/ops/element_pallas.py:210",
         "launches": launches["element"],
         "max_abs_err": rec_el["max_abs_err"], "ms": rec_el["ms"],
         "plain_ms": rec_el["plain_ms"]},
        {"name": "assemble_internal_force", "route": "cuda",
         "source": "hakai_tpu_torch/csrc/assemble.cu",
         "replaces": "hakai_tpu/ops/gather_pallas.py:413",
         "launches": launches["assemble"],
         "max_abs_err": rec_as["max_abs_err"], "ms": rec_as["ms"],
         "plain_ms": rec_as["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
