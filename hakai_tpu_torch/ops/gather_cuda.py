"""Wrapper of the column-gather kernel (``csrc/gather.cu``), which replaces
the TPU's ``hakai_tpu/ops/gather_pallas.py:blocked_gather`` (its diagonal,
merged and chunk-select kernels are three tilings of this one gather).

:func:`gather_listed` is the contact step's gather in a chunk that carries
the activity masks (``ops/activity.py``): only the columns its readers
read, of the listed (active) triangles and of the nodes.

For tensors on the CPU each wrapper runs its plain version
(:func:`gather_cols_plain`, :func:`gather_listed_plain`); for CUDA tensors
it launches the kernel on the current stream, or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build

_ENTRIES = {torch.float32: "hk_gather_cols_f32",
            torch.float64: "hk_gather_cols_f64"}
_LISTED = {torch.float32: "hk_gather_listed_f32",
           torch.float64: "hk_gather_listed_f64"}


class Listed(NamedTuple):
    """What :func:`gather_listed` gathers, over the merged kinematics
    columns (device tensors, made once per model)."""
    dense: torch.Tensor     # (nd,) int32 columns gathered whole: first the
    nd6: int                # nd6 of all six rows, then position rows only
    pairs: torch.Tensor     # (P, 4) int32 per carried pair: its list's
    #                         offset in ids, its q0, q1 and q2 column offsets
    ids: torch.Tensor       # int32 the pairs' lists of active triangles
    counts: torch.Tensor    # (P,) int32 the lists' counts
    most: int               # nd plus three columns a triangle slot


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


def gather_listed_plain(src, idx, listed: Listed):
    """The (6, R) gather of :func:`gather_listed`, NaN where it writes
    nothing (the columns of unlisted triangles; the velocity rows of j-side
    nodes and of q1 and q2): a reader of such an entry shows NaN."""
    out = src.new_full((src.shape[0], idx.shape[0]), float("nan"))
    cols = [(listed.dense[:listed.nd6], 6), (listed.dense[listed.nd6:], 3)]
    for (off, *a), n in zip(listed.pairs.tolist(), listed.counts.tolist()):
        k = listed.ids[off:off + n]
        cols += [(a[0] + k, 6), (a[1] + k, 3), (a[2] + k, 3)]
    for r, rows in cols:
        r = r.long()
        out[:rows, r] = src[:rows, idx[r].long()]
    return out


def gather_listed(src, idx, listed: Listed):
    """(6, R) = ``src[:, idx]`` on the columns and rows that a step's
    contact kernels read, for ``src`` (6, S) position and velocity rows,
    int32 ``idx`` (R,) and ``listed`` (the carry's :class:`Listed`); the
    other entries hold whatever the buffer held (NaN on the CPU)."""
    if src.device.type == "cpu":
        return gather_listed_plain(src, idx, listed)
    if src.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {src.device}")
    entry = _LISTED.get(src.dtype)
    if entry is None:
        raise TypeError(f"no gather kernel for {src.dtype}")
    S, R, P = src.shape[1], idx.shape[0], listed.pairs.shape[0]
    _build.check_inputs(src.device, {
        "src": (src, (6, S), src.dtype), "idx": (idx, (R,), torch.int32),
        "dense": (listed.dense, tuple(listed.dense.shape), torch.int32),
        "pairs": (listed.pairs, (P, 4), torch.int32),
        "ids": (listed.ids, tuple(listed.ids.shape), torch.int32),
        "counts": (listed.counts, (P,), torch.int32)})
    out = torch.empty((6, R), dtype=src.dtype, device=src.device)
    _build.launch(entry, src.device, src, S, idx, R, out, listed.dense,
                  listed.nd6, listed.dense.shape[0], listed.pairs, P,
                  listed.ids, listed.counts, listed.most)
    return out
