"""The port's bandwidth probe (the counterpart of
``benchmarks/dma_microbench.py``): the streaming kernel ``o = x + 1.0``
(``csrc/stream.cu``) over a (72, E) float32 array, the packed Gauss
state's shape, in its three tile layouts, slope-timed.

    python -m hakai_tpu_torch.probes.dma [--E 1048576 --TE 2048 --n1 20
                                          --n2 120 --device cuda]

Per layout, n passes chained from zeros (two buffers ping-ponged, as the
JAX probe's ``fori_loop(0, n, f)`` chains them) run for n = n1 and n2 on
the host clock, each run ending in a device sync; the slope over n2 - n1
passes gives microseconds a pass and the read+write rate.  The same slope
of one PyTorch call, ``torch.add(x, 1.0, out=o)``, is printed beside them
as the yardstick (the port calls it nowhere else), and the least time a
pass could take at the nominal 3.35 TB/s.  After n passes every value must
equal float(n) exactly: the probe raises if one does not.  With
``--device cpu`` the kernel's plain version runs (a rehearsal; its times
are the CPU's).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..ops.stream_cuda import LAYOUTS, layout_shape, stream_add1

ROWS = 72
HBM_BPS = 3.35e12            # H100 SXM nominal device-memory rate


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chain(step, shape, n, device):
    """``n`` passes of ``step(src, dst)`` from zeros, ping-ponging two
    buffers; (the last output, host seconds ending in a sync)."""
    a = torch.zeros(shape, dtype=torch.float32, device=device)
    b = torch.empty_like(a)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        step(a, b)
        a, b = b, a
    _sync(device)
    return a, time.perf_counter() - t0


def slope(step, shape, n1, n2, device):
    """Seconds a pass from T(n2) - T(n1) after one warm run of n1; checks
    that n passes leave float(n) everywhere."""
    chain(step, shape, n1, device)
    out = {}
    for n in (n1, n2):
        r, out[n] = chain(step, shape, n, device)
        if not bool((r == float(n)).all()):
            raise AssertionError(f"{n} passes did not give {float(n)} "
                                 "everywhere")
    return (out[n2] - out[n1]) / (n2 - n1)


def probe(E=1048576, TE=2048, n1=20, n2=120, device="cuda",
          out=print) -> dict:
    """Run the probe; returns {layout: seconds a pass} with the yardstick
    under ``"torch.add"`` and the bound under ``"bound"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for the plain "
                           "version")
    if not 0 < n1 < n2:
        raise ValueError(f"need 0 < n1 < n2, not n1={n1}, n2={n2}")
    moved = 2 * ROWS * E * 4                # bytes read + written a pass
    res = {}
    for layout in LAYOUTS:
        shape = layout_shape(layout, E, TE, ROWS)
        res[layout] = slope(lambda a, b, lay=layout: stream_add1(
            a, lay, out=b, TE=TE, rows=ROWS), shape, n1, n2, device)
    res["torch.add"] = slope(lambda a, b: torch.add(a, 1.0, out=b),
                             (ROWS, E), n1, n2, device)
    res["bound"] = moved / HBM_BPS
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    out(f"dma probe on {name}: ({ROWS}, {E}) float32, TE={TE}, "
        f"{moved / 1e6:.1f} MB read+write a pass, slope of T({n2}) - "
        f"T({n1})")
    for k, s in res.items():
        out(f"{k:10s}{s * 1e6:11.3f} us/pass {moved / s / 1e9:9.1f} GB/s "
            "(r+w)" + ("  (nominal 3.35 TB/s)" if k == "bound" else ""))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m hakai_tpu_torch.probes.dma",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--E", type=int, default=1048576)
    ap.add_argument("--TE", type=int, default=2048)
    ap.add_argument("--n1", type=int, default=20)
    ap.add_argument("--n2", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return probe(a.E, a.TE, a.n1, a.n2, a.device)


if __name__ == "__main__":
    main()
