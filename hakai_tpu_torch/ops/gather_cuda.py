"""Wrapper of the column-gather kernel (``csrc/gather.cu``), which replaces
the TPU's ``hakai_tpu/ops/gather_pallas.py:blocked_gather`` (its diagonal,
merged and chunk-select kernels are three tilings of this one gather).

For tensors on the CPU the wrapper runs the plain version,
:func:`gather_cols_plain`; for CUDA tensors it launches the kernel on the
current stream, or raises.
"""
from __future__ import annotations

import torch

from .. import _build

_ENTRIES = {torch.float32: "hk_gather_cols_f32",
            torch.float64: "hk_gather_cols_f64"}


def gather_cols_plain(src, idx):
    """``src[:, idx]``."""
    return src[:, idx.long()]


def gather_cols(src, idx):
    """(C, R) = ``src[:, idx]`` for ``src`` (C, S) and int32 ``idx`` (R,)."""
    if src.device.type == "cpu":
        return gather_cols_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {src.device}")
    entry = _ENTRIES.get(src.dtype)
    if entry is None:
        raise TypeError(f"no gather kernel for {src.dtype}")
    C, S = src.shape
    R = idx.shape[0]
    _build.check_inputs(src.device, {"src": (src, (C, S), src.dtype),
                                     "idx": (idx, (R,), torch.int32)})
    out = torch.empty((C, R), dtype=src.dtype, device=src.device)
    _build.launch(entry, src.device, src, C, S, idx, R, out)
    return out
