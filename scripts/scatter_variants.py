"""Times the design variants of kernel S (``scripts/scatter_variants.cu``)
on the force table of chip_smoke.py's contact deck, in float32 -> float64
and in float64, each bitwise against the first design.

    python3 scripts/scatter_variants.py [--n 48]

On a machine with an H100: builds the variants with nvcc into
``build/scatter_variants.so``, lowers ``impact_model(n, v0=2e5,
d_time=1e-9, end_time=5e-6)`` in mixed precision on the card (N = 137,216
and 4,449,555 table entries at n = 48), fills a (3, W) pair-force buffer
with normal values from a seed, and prints each variant's time (cold L2,
chip_smoke.time_ms), its share of the bound and the table's row lengths.
``--device cpu`` builds the tables alone (a rehearsal; no kernel runs).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import bound, nbytes, smi, time_ms  # noqa: E402
from hakai_tpu_torch import SolverConfig, _build, lower  # noqa: E402
from hakai_tpu_torch.pre.synthetic import impact_model  # noqa: E402

VARIANTS = ("csr", "csr8", "slot8", "slot16", "sorted8", "lanes8", "lanes4",
            "lanes16", "bsort32", "bsort64", "bsort128", "bsort32u8",
            "bsort32p", "bsort16", "bsort32pu2", "bsort32pu1", "diag-gather",
            "diag-place")
BSORT = (32, 64, 128, 32, 16)     # the fourth: packed words
SEED = 20261017


def tables(ptr, mid, col):
    """(slot (V, N), word (N,)) over the CSR: slot v of node n at [v, n]
    (zero past the row), word = length << 16 | adds; and the same with the
    rows dealt by length (longest first, node order within a length) and
    the permutation (row -> node)."""
    N = ptr.shape[0] - 1
    ln = (ptr[1:] - ptr[:-1]).long()
    adds = (mid - ptr[:-1]).long()
    V = int(ln.max())
    v = torch.arange(V, device=ptr.device)
    q = ptr[:-1].long()[None, :] + v[:, None]
    live = v[:, None] < ln[None, :]
    slot = torch.where(live, col.long()[q.clamp_max(col.shape[0] - 1)], 0)
    word = (ln << 16) | adds
    order = torch.argsort(-ln * (N + 1) + torch.arange(N, device=ptr.device))
    return (slot.int().contiguous(), word.int(), slot[:, order].int()
            .contiguous(), word[order].int(), order.int(), V)


def bsort_tables(ptr, col, nb):
    """(sc, sd, maxE): the CSR's entries sorted by column within each
    block of ``nb`` nodes (stable), each one's place in its block's range
    (uint16), and the most entries a block has."""
    N = ptr.shape[0] - 1
    p = ptr.long()
    ln = p[1:] - p[:-1]
    node = torch.repeat_interleave(torch.arange(N, device=ptr.device), ln)
    blk = node // nb
    pos = torch.arange(col.shape[0], device=ptr.device)
    start = p[torch.clamp(blk * nb, max=N)]
    key = blk * (1 << 32) + col.long()
    # stable sort by (block, column), then place in the block's range
    order = torch.sort(key, stable=True).indices
    sc = col[order].contiguous()
    sd = (pos - start)[order]
    bounds = p[torch.clamp(torch.arange(0, N + nb, nb, device=ptr.device),
                           max=N)]
    maxE = int((bounds[1:] - bounds[:-1]).max())
    assert int(sd.max()) < 65536
    return sc, sd.to(torch.int32).to(torch.int16).contiguous(), maxE


def build_lib():
    nvcc = _build.nvcc_path()
    out = os.path.join(ROOT, "build", "scatter_variants.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", out,
           os.path.join(ROOT, "scripts", "scatter_variants.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    print(r.stdout + r.stderr, flush=True)
    r.check_returncode()
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sv_scatter.argtypes = [I, I, P, I] + [P] * 11 + [I, I, P, P]
    lib.sv_scatter.restype = I
    lib.sv_error_string.argtypes = [I]
    lib.sv_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    m = lower(impact_model(n=a.n, v0=2.0e5, d_time=1e-9, end_time=5e-6),
              SolverConfig(dtype="mixed"), device=dev)
    ptr, mid, col = m.fs_ptr, m.fs_mid, m.fs_col
    slot, word, sslot, sword, perm, V = tables(ptr, mid, col)
    bs = [bsort_tables(ptr, col, nb) for nb in BSORT]
    sc, sd, mx = bs[3]
    assert m.fs_width < 1 << 21 and mx <= 2048
    packed = ((sc.long() << 11) | (sd.long() & 0xffff)).to(torch.int64)
    bs[3] = (torch.where(packed >= 1 << 31, packed - (1 << 32), packed)
             .to(torch.int32).contiguous(), sd, mx)
    for nb, (sc, sd, mx) in zip(BSORT, bs):    # each block's entries, back
        if sc is bs[3][0]:
            sc = ((sc.long() & 0xffffffff) >> 11).int()
        back = torch.empty_like(col)
        node = torch.repeat_interleave(torch.arange(m.N, device=dev),
                                       (ptr[1:] - ptr[:-1]).long())
        blk_of_sorted = torch.sort(node // nb, stable=True).values
        back[ptr.long()[blk_of_sorted * nb] + (sd.long() & 0xffff)] = sc
        assert torch.equal(back, col), f"bsort{nb} table differs"
        print(f"bsort{nb}: most entries a block {mx}", flush=True)
    ln = (ptr[1:] - ptr[:-1]).cpu().numpy()
    lens, counts = np.unique(ln, return_counts=True)
    print(f"N={m.N} W={m.fs_width} entries={col.shape[0]} adds="
          f"{int((mid - ptr[:-1]).sum())} V={V}; rows by length "
          f"{dict(zip(lens.tolist(), counts.tolist()))}", flush=True)
    # the tables give back the CSR
    back = slot[:, :].T[torch.arange(V, device=dev)[None, :]
                        < torch.as_tensor(ln, device=dev)[:, None]]
    assert torch.equal(back, col), "slot table differs from the CSR"
    if dev.type != "cuda":
        return
    lib = build_lib()
    rng = np.random.default_rng(SEED)
    force64 = torch.from_numpy(rng.normal(size=(3, m.fs_width))).to(dev)
    line = smi()
    for kind, force in ((0, force64.float()), (1, force64)):
        name = "f32->f64" if kind == 0 else "f64"
        outs = {}

        scs = (ctypes.c_void_p * 5)(*[b[0].data_ptr() for b in bs])
        sds = (ctypes.c_void_p * 5)(*[b[1].data_ptr() for b in bs])
        mxs = (ctypes.c_int * 5)(*[b[2] for b in bs])

        def call(v, out):
            err = lib.sv_scatter(
                v, kind, force.data_ptr(), m.fs_width, ptr.data_ptr(),
                mid.data_ptr(), col.data_ptr(), slot.data_ptr(),
                word.data_ptr(), sslot.data_ptr(), sword.data_ptr(),
                perm.data_ptr(), ctypes.addressof(scs), ctypes.addressof(sds),
                ctypes.addressof(mxs), m.N, V, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{VARIANTS[v]}: "
                                   f"{lib.sv_error_string(err).decode()}")
        g = torch.empty((3, m.N), dtype=torch.float64, device=dev)
        b_ms, _ = bound(nbytes(ptr, mid, col, force, g), 0, "float64")
        for v, vname in enumerate(VARIANTS):
            out = torch.full((3, m.N), float("nan"), dtype=torch.float64,
                             device=dev)
            try:
                call(v, out)
            except RuntimeError as e:
                print(f"{name:8s} {vname:8s} failed: {e}", flush=True)
                continue
            torch.cuda.synchronize()
            outs[v] = out
            diag = vname.startswith("diag")
            same = diag or torch.equal(out, outs[0])
            ms = time_ms(lambda: call(v, out))
            print(f"{name:8s} {vname:8s} {ms:.4f} ms  {b_ms / ms:.3f} of the "
                  f"bound {b_ms:.4f} ms; " + ("a diagnostic, not the "
                  "function" if diag else f"bitwise the first design: "
                  f"{same}") + f" [{line}]", flush=True)
            if not same:
                raise AssertionError(f"{vname} differs from the first design")


if __name__ == "__main__":
    main()
