"""Times the design variants of TPU kernel #12's replacement
(``scripts/interleave_variants.cu``) in the four modes at the TPU probe's
512 tiles x 60 builds, each bitwise against the plain version.

    python3 scripts/interleave_variants.py

On a machine with an H100: builds the variants with nvcc into
``build/interleave_variants.so``; holds every variant and mode bit for bit
against ``interleave_plain`` at 1, 131, 133 and 512 tiles and 8, 60 and
100 builds of a (64, 8, 128) window (100: past the window, the wrap);
then times each at 512 x 60 by the probe's slope (T(120) - T(20) chained
passes, CUDA events behind a sleep kernel, ``probes.interleave``) and
alone (cold L2, chip_smoke.time_ms).  About 30 s.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import smi, time_ms  # noqa: E402
from hakai_tpu_torch import _build  # noqa: E402
from hakai_tpu_torch.ops.interleave_cuda import (LANES, MODES, OFFSETS,  # noqa: E402
                                                 ROWS, interleave_plain)
from hakai_tpu_torch.probes.interleave import (W, chain, timed_chain,  # noqa: E402
                                               window)

# name -> (C entry, cluster size for iv_cluster)
VARIANTS = {"first": ("iv_first", None),
            "shipped": ("hk_interleave_f32", None),
            "tma 1": ("iv_tma", 1), "tma 2": ("iv_tma", 2),
            "tma 4": ("iv_tma", 4), "ring 1": ("iv_ring", 1),
            "ring 4": ("iv_ring", 4)}
# the fixed cost against the cost a build: alone-times at these builds
SWEEP = (1, 16, 60)
CHECK_TILES, CHECK_BUILDS = (1, 131, 133, 512), (8, 60, 100)
TILES, BUILDS, N1, N2 = 512, 60, 20, 120


def build_lib():
    nvcc = _build.nvcc_path()
    out = os.path.join(ROOT, "build", "interleave_variants.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", out,
           os.path.join(ROOT, "scripts", "interleave_variants.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    print(r.stdout + r.stderr, flush=True)
    r.check_returncode()
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, cl in VARIANTS.values():
        getattr(lib, fn).argtypes = [P, I, I, I, I, P, P, P] + (
            [I] if cl else [])
        getattr(lib, fn).restype = I
    lib.hk_interleave_resources.argtypes = [I, I, I, I, P, P]
    lib.hk_interleave_resources.restype = I
    lib.iv_error_string.argtypes = [I]
    lib.iv_error_string.restype = ctypes.c_char_p
    return lib


def main():
    lib = build_lib()
    dev = torch.device("cuda")
    src = window(dev)
    offs = (ctypes.c_int * ROWS)(*OFFSETS)
    line = smi()

    def call(fn, s, mode, tiles, builds, out):
        fn, cl = fn
        err = getattr(lib, fn)(s.data_ptr(), W, builds, tiles, MODES[mode],
                               ctypes.addressof(offs), out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream,
                               *([cl] if cl else []))
        if err:
            raise RuntimeError(f"{fn} {mode}: "
                               f"{lib.iv_error_string(err).decode()}")
        return out

    def measure(name, fn, mode):
        for tiles in CHECK_TILES:
            for builds in CHECK_BUILDS:
                out = torch.full((tiles * ROWS, LANES), float("nan"),
                                 device=dev)
                call(fn, src, mode, tiles, builds, out)
                ref = interleave_plain(src, mode, tiles, builds)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name} {mode} {tiles} tiles "
                                         f"{builds} builds differs")
        buf = torch.empty((TILES * ROWS, LANES), device=dev)

        def step(s):
            return call(fn, s, mode, TILES, BUILDS, buf)
        chain(step, src, N2)
        t = {n: timed_chain(step, src, n, dev, 0.02) for n in (N1, N2)}
        per = (t[N2] - t[N1]) / (N2 - N1)
        ms = time_ms(lambda: step(src))
        sweep = [time_ms(lambda: call(fn, src, mode, TILES, b, buf))
                 for b in SWEEP]
        print(f"{name:10s} {mode:9s} {per * 1e6:8.3f} us/pass by slope, "
              f"{ms:.4f} ms alone (cold L2); alone at {SWEEP} builds "
              + ", ".join(f"{t:.4f}" for t in sweep) + " ms; bitwise the "
              f"plain version at {CHECK_TILES} tiles x {CHECK_BUILDS} builds "
              f"[{line}]", flush=True)
    for name, fn in VARIANTS.items():
        for mode in MODES:
            try:
                measure(name, fn, mode)
            except RuntimeError as e:
                print(f"{name:10s} {mode:9s} failed: {e}", flush=True)
    res = (ctypes.c_int * 5)()
    for mode, code in MODES.items():
        err = lib.hk_interleave_resources(W, BUILDS, TILES, code,
                                          ctypes.addressof(offs), res)
        if err:
            raise RuntimeError(lib.iv_error_string(err).decode())
        print(f"shipped {mode}: {res[1]} registers, {res[3]} B local, "
              f"{res[2]} B static + {res[4]} B dynamic shared, {res[0]} "
              f"blocks/SM", flush=True)


if __name__ == "__main__":
    main()
