"""Wrapper of the interleave probe's kernel (``csrc/interleave.cu``), which
replaces the TPU's ``kernel`` of ``benchmarks/interleave_microbench.py:33``
(call ``:62``): per tile, ``builds`` (8, 128) float32 values built from a
(W, 8, 128) window in one of four ways (``MODES``) and summed in build
order into the tile's 8 output rows.  The port's interleave probe
(:mod:`hakai_tpu_torch.probes.interleave`) drives it; no stepping path
does.

For tensors on the CPU the wrapper runs the plain version,
:func:`interleave_plain`; for CUDA tensors it launches the kernel on the
current stream, or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

# mode name -> the kernel's mode code
MODES = {"copy": 0, "stackrows": 1, "selrows": 2, "gatherrow": 3}
ROWS, LANES = 8, 128
# the TPU probe's row offsets, arange(8) % 4, held in its SMEM
OFFSETS = (0, 1, 2, 3, 0, 1, 2, 3)
# window slabs the kernel keeps in a block's shared memory (its kMaxSlabs)
# and, for copy and gatherrow, the next ones in registers (kRegSlabs)
SMEM_SLABS, REG_SLABS = 56, 8


def _check(mode: str, W: int, builds: int, off) -> tuple:
    """The eight offsets as ints; raises on an unknown mode or a build that
    would read outside the window."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {list(MODES)}")
    off = tuple(int(x) for x in off)
    if len(off) != ROWS or min(off) < 0:
        raise ValueError(f"off takes {ROWS} non-negative row offsets, not "
                         f"{off}")
    if W < 1 or builds < 0:
        raise ValueError(f"need W >= 1 and builds >= 0, not W={W}, "
                         f"builds={builds}")
    if mode in ("stackrows", "selrows") and max(off) + min(builds, 16) > W:
        raise ValueError(f"{mode} reads slab {max(off) + min(builds, 16) - 1}"
                         f" of a {W}-slab window")
    return off


def window_slabs(mode: str, W: int, builds: int, off=OFFSETS) -> int:
    """The window slabs ``mode``'s builds read: 0 .. n - 1."""
    off = _check(mode, W, builds, off)
    if mode in ("stackrows", "selrows"):
        return max(off) + min(builds, 16) if builds else 0
    return min(builds, W)


def window_place(mode: str, W: int, builds: int, off=OFFSETS) -> str:
    """Where the kernel keeps the window ``mode`` reads: shared memory,
    then (copy, gatherrow) registers, then L1/L2.  A gatherrow build reads
    one lane of the row that depends on the build, so its registers serve
    the first pass over the window only."""
    n = window_slabs(mode, W, builds, off)
    if n <= SMEM_SLABS:
        return f"slabs 0-{n - 1} in shared memory"
    regs = min(n, SMEM_SLABS + REG_SLABS)
    where = (f"slabs 0-{SMEM_SLABS - 1} in shared memory, {SMEM_SLABS}-"
             f"{regs - 1} in registers")
    if mode == "gatherrow" and builds > W:
        where += " (on the first pass; later passes through L1/L2)"
    if n > regs:
        where += f", {regs}-{n - 1} through L1/L2"
    return where


def builds_plain(src, mode: str, builds: int, off=OFFSETS):
    """(builds, 8, 128): build b of ``mode`` from the (W, 8, 128) window
    ``src``, for every b (the TPU kernel's per-build value, batched)."""
    W = src.shape[0]
    off = _check(mode, W, builds, off)
    dev = src.device
    b = torch.arange(builds, device=dev)
    i = torch.arange(ROWS, device=dev)
    offs = torch.tensor(off, device=dev)
    if mode == "copy":
        return src[b % W]
    if mode == "stackrows":
        return src[offs[None, :] + (b % 16)[:, None], i[None, :]]
    if mode == "selrows":
        v = src.new_zeros((builds, ROWS, LANES))
        row = i[None, :, None]
        for k in range(ROWS):
            r = src[off[k] + b % 16, k]                      # (builds, 128)
            v = torch.where(row == k, r[:, None, :], v)
        return v
    lane = (7 * i[None, :] + b[:, None]) % LANES             # (builds, 8)
    val = src[(b % W)[:, None], i[None, :], lane]
    return val[:, :, None].expand(builds, ROWS, LANES)


def interleave_plain(src, mode: str, n_tiles: int, builds: int,
                     off=OFFSETS):
    """The (n_tiles * 8, 128) output: every tile's sum of the builds, from
    zero, in build order (each tile reads the same window)."""
    v = builds_plain(src, mode, builds, off)
    acc = src.new_zeros((ROWS, LANES))
    for b in range(builds):
        acc = acc + v[b]
    return acc.repeat(n_tiles, 1)


def interleave(src, mode: str, n_tiles: int, builds: int, off=OFFSETS,
               out=None):
    """``out`` (default a new tensor) = the probe's (n_tiles * 8, 128)
    float32 output of ``mode`` over the (W, 8, 128) float32 window ``src``
    with row offsets ``off`` (eight ints, on the host).  Returns ``out``."""
    W = src.shape[0]
    off = _check(mode, W, builds, off)
    if src.device.type == "cpu":
        y = interleave_plain(src, mode, n_tiles, builds, off)
        return y if out is None else out.copy_(y)
    if src.device.type != "cuda":
        raise ValueError(f"no interleave kernel for device {src.device}")
    if mode in ("stackrows", "selrows") and \
            window_slabs(mode, W, builds, off) > SMEM_SLABS:
        raise ValueError(f"the kernel keeps {mode}'s slabs in shared memory:"
                         f" at most {SMEM_SLABS}, not "
                         f"{window_slabs(mode, W, builds, off)}")
    if n_tiles < 1 or n_tiles * ROWS * LANES >= 2**31:
        raise ValueError(f"n_tiles={n_tiles} out of range")
    out = (torch.empty((n_tiles * ROWS, LANES), dtype=torch.float32,
                       device=src.device) if out is None else out)
    _build.check_inputs(src.device, {
        "src": (src, (W, ROWS, LANES), torch.float32),
        "out": (out, (n_tiles * ROWS, LANES), torch.float32)})
    if src.data_ptr() % 16:
        raise ValueError("the interleave kernel needs a 16-byte aligned src")
    offs = (ctypes.c_int * ROWS)(*off)
    _build.launch("hk_interleave_f32", src.device, src, W, builds, n_tiles,
                  MODES[mode], ctypes.addressof(offs), out)
    return out
