"""Wrappers of the deterministic assembly kernel (``csrc/assemble.cu``),
which replaces the TPU assembly path: ``hakai_tpu/ops/gather_pallas.py``
``_make_diag_kernel`` on ``plan_asm`` plus the masked sum below 400k
elements, and ``_make_phys_asm_kernel`` at and above it; and of its grouped
entry, which replaces ``blocked_assemble`` (``_make_diag_asm_kernel`` and
``_make_asm_kernel``), the gather-and-accumulate that
``assemble_internal_force`` takes on a model carrying a grouped
``plan_asm``.

For tensors on the CPU each wrapper runs its plain version; for CUDA
tensors it launches the kernel on the current stream, or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..core.lowering import AssemblePlan, LoweredModel
from .element import assemble_internal_force_plain

# (qe dtype, Q dtype) -> C entry; float32 -> float64 is mixed precision
_ENTRIES = {(torch.float32, torch.float32): "hk_assemble_f32",
            (torch.float64, torch.float64): "hk_assemble_f64",
            (torch.float32, torch.float64): "hk_assemble_f32_f64"}
_GROUPED = {(torch.float32, torch.float32): "hk_blocked_assemble_f32",
            (torch.float64, torch.float64): "hk_blocked_assemble_f64",
            (torch.float32, torch.float64): "hk_blocked_assemble_f32_f64"}


def assemble_internal_force(model: LoweredModel, qe24, out_dtype=None):
    """Q (3, N) from qe (24, E): each node sums its incident (slot,
    element) entries in the fixed order of the incidence table, in qe's
    dtype; the sum is stored in ``out_dtype`` (default qe's dtype), as
    the JAX package's ``assemble_internal_force(...).astype(model.dtype)``
    rounds it.  A model carrying a grouped ``plan_asm`` assembles through
    :func:`blocked_assemble` instead (``hakai_tpu/ops/element.py:
    619-621``)."""
    out_dtype = qe24.dtype if out_dtype is None else out_dtype
    E, N = model.E, model.N
    if model.plan_asm is not None:
        if model.plan_asm.r_pad // model.plan_asm.vl < N:
            raise ValueError("plan_asm has fewer output columns than nodes")
        return blocked_assemble(qe24.reshape(3, 8 * E), model.plan_asm,
                                out_dtype)[:, :N]
    if qe24.device.type == "cpu":
        return assemble_internal_force_plain(model, qe24).to(out_dtype)
    if qe24.device.type != "cuda":
        raise ValueError(f"no assembly kernel for device {qe24.device}")
    V = model.inc_idx.shape[0]
    entry = _ENTRIES.get((qe24.dtype, out_dtype))
    if entry is None:
        raise TypeError(f"no assembly kernel for {qe24.dtype} -> "
                        f"{out_dtype}")
    _build.check_inputs(qe24.device, {
        "qe": (qe24, (24, E), qe24.dtype),
        "inc_idx": (model.inc_idx, (V, N), torch.int32),
        "inc_mask": (model.inc_mask, (V, N), torch.bool)})
    Q = torch.empty((3, N), dtype=out_dtype, device=qe24.device)
    _build.launch(entry, qe24.device, qe24, model.inc_idx, model.inc_mask,
                  V, N, E, Q)
    return Q


def plan_assemble(idx_grouped, mask_grouped, source_len: int, vl: int,
                  r_tile: int = 2048) -> AssemblePlan:
    """The NumPy counterpart of ``hakai_tpu/ops/gather_pallas.py:
    plan_assemble``: ``idx_grouped`` is ordered so that ``vl`` consecutive
    tiles of ``r_tile`` entries target one output tile; padded with masked
    entries to whole tiles.  Masked entries point at column 0.  Builds no
    window plan (a TPU matter).  Returns an :class:`AssemblePlan` on the
    CPU (``.to(device)`` moves it)."""
    idx = np.asarray(idx_grouped, np.int64).reshape(-1)
    mask = np.asarray(mask_grouped, bool).reshape(-1)
    if idx.shape != mask.shape:
        raise ValueError("idx_grouped and mask_grouped differ in length")
    if ((idx[mask] < 0) | (idx[mask] >= source_len)).any():
        raise ValueError(f"an unmasked index lies outside [0, {source_len})")
    if vl < 1 or r_tile < 1:
        raise ValueError(f"vl={vl} and r_tile={r_tile} must be positive")
    r_pad = -(-max(len(idx), 1) // r_tile) * r_tile
    if (r_pad // r_tile) % vl:
        raise ValueError(f"{r_pad // r_tile} tiles do not group by vl={vl}")
    idx_p = np.zeros(r_pad, np.int32)
    idx_p[:len(idx)] = np.where(mask, idx, 0)
    mask_p = np.zeros(r_pad, bool)
    mask_p[:len(mask)] = mask
    return AssemblePlan(idx=torch.from_numpy(idx_p),
                        mask=torch.from_numpy(mask_p), vl=int(vl),
                        r_tile=int(r_tile))


def blocked_assemble_plain(src, plan: AssemblePlan):
    """Plain version of the grouped entry: gather, mask, and the sum over
    each output tile's ``vl`` tiles in the order l = 0..vl-1, from zero,
    in ``src``'s dtype; (C, r_pad // vl)."""
    C = src.shape[0]
    vals = torch.where(plan.mask, src[:, plan.idx.long()], 0.0)
    vals = vals.view(C, -1, plan.vl, plan.r_tile)
    acc = torch.zeros_like(vals[:, :, 0])
    for lane in range(plan.vl):
        acc = acc + vals[:, :, lane]
    return acc.reshape(C, -1)


def blocked_assemble(src, plan: AssemblePlan, out_dtype=None):
    """Gather-and-accumulate ``src (3, S) -> (3, plan.r_pad // plan.vl)``
    (``hakai_tpu/ops/gather_pallas.py:blocked_assemble`` on the assembly's
    three force components; the caller slices the true output length),
    summed in ``src``'s dtype and stored in ``out_dtype`` (default
    ``src``'s dtype)."""
    out_dtype = src.dtype if out_dtype is None else out_dtype
    if src.dim() != 2 or src.shape[0] != 3:
        raise ValueError(f"the grouped assembly takes a (3, S) source, not "
                         f"{tuple(src.shape)}")
    if src.device.type == "cpu":
        return blocked_assemble_plain(src, plan).to(out_dtype)
    if src.device.type != "cuda":
        raise ValueError(f"no grouped assembly kernel for device "
                         f"{src.device}")
    entry = _GROUPED.get((src.dtype, out_dtype))
    if entry is None:
        raise TypeError(f"no grouped assembly kernel for {src.dtype} -> "
                        f"{out_dtype}")
    S = src.shape[1]
    r_pad, n_out = plan.r_pad, plan.r_pad // plan.vl
    _build.check_inputs(src.device, {
        "src": (src, (3, S), src.dtype),
        "idx": (plan.idx, (r_pad,), torch.int32),
        "mask": (plan.mask, (r_pad,), torch.bool)})
    out = torch.empty((3, n_out), dtype=out_dtype, device=src.device)
    _build.launch(entry, src.device, src, S, plan.idx, plan.mask, plan.vl,
                  plan.r_tile, n_out, out)
    return out
