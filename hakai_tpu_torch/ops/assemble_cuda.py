"""Wrapper of the deterministic assembly kernel (``csrc/assemble.cu``),
which replaces the TPU assembly path: ``hakai_tpu/ops/gather_pallas.py``
``_make_diag_kernel`` on ``plan_asm`` plus the masked sum below 400k
elements, and ``_make_phys_asm_kernel`` at and above it.

For tensors on the CPU the wrapper runs the plain version,
:func:`~hakai_tpu_torch.ops.element.assemble_internal_force_plain`; for
CUDA tensors it launches the kernel on the current stream, or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from ..core.lowering import LoweredModel
from .element import assemble_internal_force_plain

# (qe dtype, Q dtype) -> C entry; float32 -> float64 is mixed precision
_ENTRIES = {(torch.float32, torch.float32): "hk_assemble_f32",
            (torch.float64, torch.float64): "hk_assemble_f64",
            (torch.float32, torch.float64): "hk_assemble_f32_f64"}


def assemble_internal_force(model: LoweredModel, qe24, out_dtype=None):
    """Q (3, N) from qe (24, E): each node sums its incident (slot,
    element) entries in the fixed order of the incidence table, in qe's
    dtype; the sum is stored in ``out_dtype`` (default qe's dtype), as
    the JAX package's ``assemble_internal_force(...).astype(model.dtype)``
    rounds it."""
    out_dtype = qe24.dtype if out_dtype is None else out_dtype
    if qe24.device.type == "cpu":
        return assemble_internal_force_plain(model, qe24).to(out_dtype)
    if qe24.device.type != "cuda":
        raise ValueError(f"no assembly kernel for device {qe24.device}")
    E, N = model.E, model.N
    V = model.inc_idx.shape[0]
    entry = _ENTRIES.get((qe24.dtype, out_dtype))
    if entry is None:
        raise TypeError(f"no assembly kernel for {qe24.dtype} -> "
                        f"{out_dtype}")
    _build.check_inputs(qe24.device, {
        "qe": (qe24, (24, E), qe24.dtype),
        "inc_idx": (model.inc_idx, (V, N), torch.int32),
        "inc_mask": (model.inc_mask, (V, N), torch.bool)})
    lib = _build.library()
    Q = torch.empty((3, N), dtype=out_dtype, device=qe24.device)
    with torch.cuda.device(qe24.device):
        err = getattr(lib, entry)(
            qe24.data_ptr(), model.inc_idx.data_ptr(),
            model.inc_mask.data_ptr(), V, N, E, Q.data_ptr(),
            torch.cuda.current_stream(qe24.device).cuda_stream)
    _build.check(lib, err, "assembly kernel")
    assemble_internal_force.launches += 1
    assemble_internal_force.launches_by[entry] += 1
    return Q


assemble_internal_force.launches = 0
assemble_internal_force.launches_by = {v: 0 for v in _ENTRIES.values()}
