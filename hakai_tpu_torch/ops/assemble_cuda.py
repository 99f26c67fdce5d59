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


def assemble_internal_force(model: LoweredModel, qe24):
    """Q (3, N) from qe (24, E): each node sums its incident (slot,
    element) entries in the fixed order of the incidence table."""
    if qe24.device.type == "cpu":
        return assemble_internal_force_plain(model, qe24)
    if qe24.device.type != "cuda":
        raise ValueError(f"no assembly kernel for device {qe24.device}")
    E, N = model.E, model.N
    V = model.inc_idx.shape[0]
    if qe24.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"no assembly kernel for dtype {qe24.dtype}")
    _build.check_inputs(qe24.device, {
        "qe": (qe24, (24, E), qe24.dtype),
        "inc_idx": (model.inc_idx, (V, N), torch.int32),
        "inc_mask": (model.inc_mask, (V, N), torch.bool)})
    lib = _build.library()
    Q = torch.empty((3, N), dtype=qe24.dtype, device=qe24.device)
    fn = (lib.hk_assemble_f32 if qe24.dtype == torch.float32
          else lib.hk_assemble_f64)
    with torch.cuda.device(qe24.device):
        err = fn(qe24.data_ptr(), model.inc_idx.data_ptr(),
                 model.inc_mask.data_ptr(), V, N, E, Q.data_ptr(),
                 torch.cuda.current_stream(qe24.device).cuda_stream)
    _build.check(lib, err, "assembly kernel")
    assemble_internal_force.launches += 1
    return Q


assemble_internal_force.launches = 0
