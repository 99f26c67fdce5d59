"""The port's interleave probe (the counterpart of
``benchmarks/interleave_microbench.py``): the four builds of an (8, 128)
float32 value from a (64, 8, 128) window (``csrc/interleave.cu``), summed
over ``builds`` builds a tile, slope-timed.

    python -m hakai_tpu_torch.probes.interleave [--tiles 512 --builds 60
                                                 --n1 20 --n2 120
                                                 --device cuda]

Per mode, a chain of n passes as the TPU probe's ``loop2`` chains them:
each pass runs the kernel on the window and then moves the window by
1e-30 times the output's first value, so that every pass waits for the one
before.  On the card each chain is queued behind a sleep kernel that
outlasts the host's queueing of it and timed by CUDA events around it, so
the host's launch rate does not enter (the TPU ran its chain inside one
jitted loop); on the CPU the host clock times it.  The slope of T(n2) -
T(n1) over n2 - n1 passes gives microseconds a pass and nanoseconds a
build, as the TPU probe prints them, beside where the kernel kept the
window and the least time a pass could take.  The window is random, from
a seed (the TPU probe's was ones).  After the timed runs the chain of n2
passes is run again with the kernel's plain version: the last window and
output must be the kernel chain's bit for bit, or the probe raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops.interleave_cuda import (LANES, ROWS, interleave, interleave_plain,
                                   window_place, window_slabs)
from . import HBM_BPS, PEAK_FLOPS

W = 64                       # window slabs, the TPU probe's W
SEED = 20261017


def window(device, seed=SEED):
    """The (W, 8, 128) float32 window, normal values from ``seed``."""
    x = np.random.default_rng(seed).normal(size=(W, ROWS, LANES))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def chain(step, src, n):
    """``n`` passes: ``out = step(src)``, then ``src = src + 1e-30 *
    out[:1, :1]`` (the TPU probe's ``loop2`` body); (last src, last out)."""
    out = None
    for _ in range(n):
        out = step(src)
        src = src + 1e-30 * out[:1, :1]
    return src, out


def timed_chain(step, src, n, device, queue_s=0.0):
    """Seconds of a chain of ``n`` passes: on the card the device time
    between CUDA events around it, the chain queued behind a sleep kernel
    of about ``queue_s`` seconds (the host's time to queue it); on the CPU
    the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        chain(step, src, n)
        return time.perf_counter() - t0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize(device)
    torch.cuda._sleep(int(min(1.5 * queue_s + 1e-3, 1.0) * 2e9))
    ev[0].record()
    chain(step, src, n)
    ev[1].record()
    torch.cuda.synchronize(device)
    return ev[0].elapsed_time(ev[1]) / 1e3


def bound_s(mode: str, tiles: int, builds: int) -> tuple[float, str]:
    """(least seconds a pass could take, what bounds it): the window's
    bytes the mode reads, once, and the output's, at the nominal HBM rate,
    against the float32 adds at the float32 peak (the chain's own window
    update left out)."""
    if mode == "gatherrow":          # one value a row; (slab, lane) period 128
        read = 4 * ROWS * min(builds, 128)
    elif mode in ("stackrows", "selrows"):      # row i of 16 slabs a row
        read = 4 * ROWS * LANES * min(builds, 16)
    else:
        read = 4 * ROWS * LANES * window_slabs(mode, W, builds)
    t_b = (read + 4 * tiles * ROWS * LANES) / HBM_BPS
    t_f = tiles * builds * ROWS * LANES / PEAK_FLOPS["float32"]
    return max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def probe(tiles=512, builds=60, n1=20, n2=120, device="cuda",
          out=print, place=True) -> dict:
    """Run the probe; returns {mode: seconds a pass}.  ``place``: name
    where the kernel keeps the window (off for a kernel of another
    design)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for the plain "
                           "version")
    if not 0 < n1 < n2:
        raise ValueError(f"need 0 < n1 < n2, not n1={n1}, n2={n2}")
    src = window(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    out(f"interleave probe on {name}: {tiles} tiles x {builds} builds of "
        f"(8, 128) float32 from a ({W}, 8, 128) window, slope of T({n2}) - "
        f"T({n1}) passes" + (" (CUDA events, chains queued behind a sleep "
                             "kernel)" if device.type == "cuda" else
                             " (host clock)"))
    res = {}
    for mode in ("copy", "selrows", "stackrows", "gatherrow"):
        buf = torch.empty((tiles * ROWS, LANES), dtype=torch.float32,
                          device=device)

        def step(s, mode=mode, buf=buf):
            return interleave(s, mode, tiles, builds, out=buf)
        t0 = time.perf_counter()
        chain(step, src, n2)                    # warm; the host's queue time
        queue_s = time.perf_counter() - t0
        t = {n: timed_chain(step, src, n, device, queue_s) for n in (n1, n2)}
        per = (t[n2] - t[n1]) / (n2 - n1)
        got = chain(step, src, n2)
        ref = chain(lambda s, mode=mode: interleave_plain(
            s, mode, tiles, builds), src, n2)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{mode}: the chain of {n2} passes differs "
                                 "from its plain version's")
        res[mode] = per
        b_s, by = bound_s(mode, tiles, builds)
        ns = per / (tiles * builds) * 1e9
        where = (window_place(mode, W, builds) if device.type == "cuda"
                 else "the plain version's")
        where = f"  window: {where};" if place else ";"
        out(f"{mode:10s}{per * 1e6:9.3f} us/pass {ns:8.4f} ns/build{where}"
            f" bound {b_s * 1e6:.3f} us "
            f"({by}); chain of {n2} bitwise its plain version's")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m hakai_tpu_torch.probes.interleave",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, default=512)
    ap.add_argument("--builds", type=int, default=60)
    ap.add_argument("--n1", type=int, default=20)
    ap.add_argument("--n2", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return probe(a.tiles, a.builds, a.n1, a.n2, a.device)


if __name__ == "__main__":
    main()
