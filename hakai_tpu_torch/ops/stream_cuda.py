"""Wrapper of the streaming kernel (``csrc/stream.cu``), which replaces
the TPU's HBM streaming probe ``copy_kernel``
(``benchmarks/dma_microbench.py:35``, call ``:42``): ``o = x + 1.0`` over
a (rows, E) float32 array, one (rows, TE) tile per block, in one of three
layouts (``LAYOUTS``).  The port's bandwidth probe
(:mod:`hakai_tpu_torch.probes.dma`) drives it; no stepping path does.

For tensors on the CPU the wrapper runs the plain version,
:func:`stream_add1_plain`; for CUDA tensors it launches the kernel on the
current stream, or raises.
"""
from __future__ import annotations

import torch

from .. import _build

# layout name -> the kernel's layout code
LAYOUTS = {"strided": 0, "tilemajor": 1, "flat": 2}


def layout_shape(layout: str, E: int, TE: int, rows: int = 72) -> tuple:
    """The array shape of ``layout`` for ``rows`` x ``E`` values in tiles of
    TE columns: strided (rows, E), tilemajor (E/TE, rows, TE), flat
    (rows * E/TE, TE)."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}: one of "
                         f"{sorted(LAYOUTS)}")
    if layout == "strided":
        return (rows, E)
    if E % TE:
        raise ValueError(f"the {layout} layout needs E={E} to be a multiple "
                         f"of TE={TE}")
    return ((E // TE, rows, TE) if layout == "tilemajor"
            else (rows * (E // TE), TE))


def stream_add1_plain(x):
    """``x + 1.0``."""
    return x + 1.0


def stream_add1(x, layout: str, out=None, TE: int = 2048, rows: int = 72):
    """``out = x + 1.0`` for a float32 ``x`` in ``layout`` (see
    :func:`layout_shape`; the strided layout takes its tile width ``TE``
    and the flat layout its row count ``rows`` from the arguments, the
    others from ``x``'s shape); ``out`` (default a new tensor) has ``x``'s
    shape.  Returns ``out``."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}: one of "
                         f"{sorted(LAYOUTS)}")
    if x.device.type == "cpu":
        y = stream_add1_plain(x)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"no streaming kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the streaming kernel takes float32, not {x.dtype}")
    if layout == "strided":
        if x.dim() != 2:
            raise ValueError(f"strided takes (rows, E), not {tuple(x.shape)}")
        rows, E = x.shape
    elif layout == "tilemajor":
        if x.dim() != 3:
            raise ValueError(f"tilemajor takes (n_tiles, rows, TE), not "
                             f"{tuple(x.shape)}")
        n_tiles, rows, TE = x.shape
        E = n_tiles * TE
    else:
        if x.dim() != 2 or x.shape[0] % rows:
            raise ValueError(f"flat takes (rows * n_tiles, TE) with rows="
                             f"{rows}, not {tuple(x.shape)}")
        TE = x.shape[1]
        E = x.shape[0] // rows * TE
    if rows * E >= 2**31 or E <= 0 or TE <= 0:
        raise ValueError(f"rows={rows}, E={E}, TE={TE} out of range")
    out = torch.empty_like(x) if out is None else out
    _build.check_inputs(x.device, {"x": (x, tuple(x.shape), torch.float32),
                                   "out": (out, tuple(x.shape),
                                           torch.float32)})
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("the streaming kernel needs 16-byte aligned x and "
                         "out")
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.hk_stream_add1_f32(
            x.data_ptr(), out.data_ptr(), rows, E, TE, LAYOUTS[layout],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "streaming kernel")
    stream_add1.launches += 1
    stream_add1.launches_by[layout] += 1
    return out


stream_add1.launches = 0
stream_add1.launches_by = {k: 0 for k in LAYOUTS}
