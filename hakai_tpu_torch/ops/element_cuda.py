"""Wrapper of the fused element kernel (``csrc/element.cu``), which
replaces the TPU kernel ``hakai_tpu/ops/element_pallas.py:_make_mxu_kernel``
on the fused-gather path.

For tensors on the CPU the wrapper runs the plain version,
:func:`~hakai_tpu_torch.ops.element.element_core_packed_plain`; for CUDA
tensors it launches the kernel on the current stream, or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from hakai_tpu.ops.shape import pusai_hexa

from .. import _build
from ..core.lowering import LoweredModel
from .element import element_core_packed_plain

_pusai_ready: set = set()     # devices whose constant table is loaded


def _ensure_pusai(lib, device: torch.device) -> None:
    """Load the float64 shape-gradient table into the device's constant
    memory (the C side rounds its float copy from it)."""
    if device.index in _pusai_ready:
        return
    table = np.ascontiguousarray(pusai_hexa(8), np.float64)
    _build.check(lib, lib.hk_set_pusai(table.ctypes.data), "hk_set_pusai")
    _pusai_ready.add(device.index)


def _check(model: LoweredModel, P, flag, disp, disp_prev) -> None:
    E, N, dt = model.E, model.N, model.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"no element kernel for dtype {dt}")
    M, W = model.hard_strain.shape
    _build.check_inputs(P.device, {
        "P": (P, (72, E), dt), "flag": (flag, (E,), torch.bool),
        "disp": (disp, (3, N), dt), "disp_prev": (disp_prev, (3, N), dt),
        "elem": (model.elem, (8, E), torch.int32),
        "coord_e": (model.coord_e, (3, 8, E), dt),
        "G_e": (model.G_e, (E,), dt), "lam_e": (model.lam_e, (E,), dt),
        "mat_id": (model.mat_id, (E,), torch.int32),
        "has_plastic_e": (model.has_plastic_e, (E,), torch.bool),
        "hard_strain": (model.hard_strain, (M, W), dt),
        "hard_slope": (model.hard_slope, (M, W - 1), dt),
        "hard_n": (model.hard_n, (M,), torch.int32)})


def element_core_packed(model: LoweredModel, P, flag, disp, disp_prev):
    """One element update on the packed state: (P_new (72, E), qe (24, E)).

    ``P`` (72, E) packed Gauss state, ``flag`` (E,) bool life mask,
    ``disp``/``disp_prev`` (3, N) new and previous nodal displacement."""
    if P.device.type == "cpu":
        return element_core_packed_plain(model, P, flag, disp, disp_prev)
    if P.device.type != "cuda":
        raise ValueError(f"no element kernel for device {P.device}")
    _check(model, P, flag, disp, disp_prev)
    lib = _build.library()
    E, N = model.E, model.N
    P_out = torch.empty_like(P)
    qe = torch.empty((24, E), dtype=P.dtype, device=P.device)
    fn = lib.hk_element_f32 if P.dtype == torch.float32 else lib.hk_element_f64
    with torch.cuda.device(P.device):
        _ensure_pusai(lib, P.device)
        err = fn(model.elem.data_ptr(), model.coord_e.data_ptr(),
                 disp.data_ptr(), disp_prev.data_ptr(), P.data_ptr(),
                 model.G_e.data_ptr(), model.lam_e.data_ptr(),
                 model.mat_id.data_ptr(), model.has_plastic_e.data_ptr(),
                 flag.data_ptr(), model.hard_strain.data_ptr(),
                 model.hard_slope.data_ptr(), model.hard_n.data_ptr(),
                 model.hard_strain.shape[1], E, N,
                 P_out.data_ptr(), qe.data_ptr(),
                 torch.cuda.current_stream(P.device).cuda_stream)
    _build.check(lib, err, "element kernel")
    element_core_packed.launches += 1
    return P_out, qe


element_core_packed.launches = 0
