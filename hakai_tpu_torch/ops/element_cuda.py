"""Wrappers of the fused element kernel (``csrc/element.cu``): the packed
chunk loop's entry with its dispatch and fracture epilogue (mirrors
``hakai_tpu/ops/element_pallas.py:packed_element_step`` and
``_fracture_epilogue``), and the generic step's unpacked entry
:func:`element_update` (mirrors ``hakai_tpu/ops/element.py:
element_update``).

The one CUDA kernel replaces four TPU kernels of
``hakai_tpu/ops/element_pallas.py``: ``_make_mxu_kernel`` in its fused-gather
call (float32) and its plain call on pos/du rows (the mixed-precision path),
``_make_packed_kernel`` (``element_kernel="pallas"``) and, through its
unpacked entry, ``_make_kernel`` (``element_core_pallas``, the generic
step's).  The MXU/VPU split between them and the XLA/Pallas choice are TPU
matters, so ``"auto"``, ``"pallas_mxu"``, ``"pallas"`` and ``"xla"`` all
reach it, on both loops.

For tensors on the CPU the wrappers run the plain versions
(:func:`~hakai_tpu_torch.ops.element.element_core_packed_plain`,
:func:`~hakai_tpu_torch.ops.element.element_core_plain`); for CUDA tensors
they launch the kernel on the current stream, or raise.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..core.lowering import LoweredModel
from .element import (ElementResult, element_core_packed_plain,
                      element_core_plain, gather_element_nodes,
                      triax_stress)
from .erosion_cuda import erosion_walk
from .shape import pusai_hexa

# (nodal dtype, element dtype) -> C entry
_ENTRIES = {(torch.float32, torch.float32): "hk_element_f32",
            (torch.float64, torch.float64): "hk_element_f64",
            (torch.float64, torch.float32): "hk_element_mixed"}
# element dtype -> C entry of the unpacked update (the generic step hands
# it positions and increments in the element dtype, mixed mode included)
_UPDATE_ENTRIES = {torch.float32: "hk_element_update_f32",
                   torch.float64: "hk_element_update_f64"}
ELEMENT_KERNELS = ("auto", "pallas_mxu", "pallas", "xla")

_pusai_ready: set = set()     # devices whose constant table is loaded


def _ensure_pusai(device: torch.device) -> None:
    """Load the float64 shape-gradient table into the device's constant
    memory (the C side rounds its float copy from it)."""
    if device.index in _pusai_ready:
        return
    lib = _build.library()
    table = np.ascontiguousarray(pusai_hexa(8), np.float64)
    with torch.cuda.device(device):
        _build.check(lib, lib.hk_set_pusai(table.ctypes.data),
                     "hk_set_pusai")
    _pusai_ready.add(device.index)


def _model_spec(model: LoweredModel) -> dict:
    """The model arrays every entry of the kernel reads."""
    E, edt = model.E, model.edtype
    M, W = model.hard_strain.shape
    return {"elem": (model.elem, (8, E), torch.int32),
            "G_e": (model.G_e, (E,), edt), "lam_e": (model.lam_e, (E,), edt),
            "mat_id": (model.mat_id, (E,), torch.int32),
            "has_plastic_e": (model.has_plastic_e, (E,), torch.bool),
            "hard_strain": (model.hard_strain, (M, W), edt),
            "hard_slope": (model.hard_slope, (M, W - 1), edt),
            "hard_n": (model.hard_n, (M,), torch.int32)}


def _check(model: LoweredModel, P, flag, disp, disp_prev) -> None:
    E, N, kdt, edt = model.E, model.N, model.dtype, model.edtype
    if (kdt, edt) not in _ENTRIES:
        raise TypeError(f"no element kernel for dtypes {kdt}/{edt}")
    if model.coord_e is None:
        raise ValueError("the packed element kernel needs model.coord_e "
                         "(lowered without window plans: use the generic "
                         "step)")
    _build.check_inputs(P.device, {
        "P": (P, (72, E), edt), "flag": (flag, (E,), torch.bool),
        "disp": (disp, (3, N), kdt), "disp_prev": (disp_prev, (3, N), kdt),
        "coord_e": (model.coord_e, (3, 8, E), edt), **_model_spec(model)})


def element_core_packed(model: LoweredModel, P, flag, disp, disp_prev,
                        want_triax=False):
    """One element update on the packed state: (P_new (72, E), qe (24, E))
    and, with ``want_triax``, the (8, E) triaxiality of the final stress.

    ``P`` (72, E) packed Gauss state in the element dtype, ``flag`` (E,)
    bool life mask, ``disp``/``disp_prev`` (3, N) new and previous nodal
    displacement in the nodal dtype."""
    if P.device.type == "cpu":
        return element_core_packed_plain(model, P, flag, disp, disp_prev,
                                         want_triax)
    if P.device.type != "cuda":
        raise ValueError(f"no element kernel for device {P.device}")
    _check(model, P, flag, disp, disp_prev)
    E, N = model.E, model.N
    P_out = torch.empty_like(P)
    qe = torch.empty((24, E), dtype=P.dtype, device=P.device)
    triax = (torch.empty((8, E), dtype=P.dtype, device=P.device)
             if want_triax else None)
    _ensure_pusai(P.device)
    _build.launch(
        _ENTRIES[(model.dtype, model.edtype)], P.device, model.elem,
        model.coord_e, disp, disp_prev, P, model.G_e, model.lam_e,
        model.mat_id, model.has_plastic_e, flag, model.hard_strain,
        model.hard_slope, model.hard_n, *model.hard_strain.shape, E, N,
        P_out, qe, triax)
    if want_triax:
        return P_out, qe, triax
    return P_out, qe


def _element_kernel(model: LoweredModel):
    """Raise unless ``config.element_kernel`` names one of the settings
    that all reach the kernel."""
    if model.config.element_kernel not in ELEMENT_KERNELS:
        raise ValueError(f"element_kernel={model.config.element_kernel!r}:"
                         f" expected one of {ELEMENT_KERNELS}")


def element_update(model: LoweredModel, position, d_disp, stress, strain,
                   eq_ps, yield_s, element_flag, want_triax=False):
    """The generic step's element update: an :class:`ElementResult` and,
    with ``want_triax``, the (8, E) triaxiality of the final stress.

    ``position`` and ``d_disp`` (3, N) are the new nodal positions
    (coord + disp) and the step's increment in the element dtype;
    ``stress`` (6, 8, E), ``strain`` (6, E), ``eq_ps``/``yield_s`` (8, E)
    the Gauss-point state in the element dtype and ``element_flag`` (E,)
    bool.  The kernel gathers both nodal fields through ``model.elem`` and
    centres the positions on each element's node 0 in the element dtype.

    ``neg_jacobian``, the Gauss points of live elements whose Jacobian
    determinant is negative, is counted only when the config streams
    metrics (``metrics_path``), as the JAX package counts it beside its TPU
    kernel; else it is 0.  On the card the kernel counts it from the
    ``detJ`` it forms (a zeroed int32 that it adds to), on the CPU
    :func:`~hakai_tpu_torch.ops.element.neg_jacobian_count` does.  The two
    form J in other summation orders, so they can disagree only on points
    whose ``|detJ|`` is at rounding level."""
    _element_kernel(model)
    if position.device.type == "cpu":
        pos_e, du = gather_element_nodes(model, position, d_disp)
        res = element_core_plain(model, pos_e, du, stress, strain, eq_ps,
                                 yield_s, element_flag)
        return (res, triax_stress(res.stress)) if want_triax else res
    if position.device.type != "cuda":
        raise ValueError(f"no element kernel for device {position.device}")
    E, N, edt = model.E, model.N, model.edtype
    if edt not in _UPDATE_ENTRIES:
        raise TypeError(f"no element kernel for dtype {edt}")
    _build.check_inputs(position.device, {
        "position": (position, (3, N), edt), "d_disp": (d_disp, (3, N), edt),
        "stress": (stress, (6, 8, E), edt), "strain": (strain, (6, E), edt),
        "eq_ps": (eq_ps, (8, E), edt), "yield_s": (yield_s, (8, E), edt),
        "element_flag": (element_flag, (E,), torch.bool),
        **_model_spec(model)})
    out = [torch.empty_like(x) for x in (stress, strain, eq_ps, yield_s)]
    qe = torch.empty((3, 8, E), dtype=edt, device=position.device)
    triax = (torch.empty((8, E), dtype=edt, device=position.device)
             if want_triax else None)
    count = model.config.metrics_path is not None
    neg = torch.zeros((), dtype=torch.int32, device=position.device)
    _ensure_pusai(position.device)
    _build.launch(
        _UPDATE_ENTRIES[edt], position.device, model.elem, position, d_disp,
        stress, strain, eq_ps, yield_s, model.G_e, model.lam_e, model.mat_id,
        model.has_plastic_e, element_flag, model.hard_strain,
        model.hard_slope, model.hard_n, *model.hard_strain.shape, E, N, *out,
        qe, triax, neg if count else None)
    res = ElementResult(qe, *out, neg)
    return (res, triax) if want_triax else res


def packed_element_step(model: LoweredModel, P, flag, disp, disp_prev,
                        carry=None):
    """The packed element update plus the fracture bookkeeping of one
    chunk-loop step: ``(P_new, qe, triax, flag)``.

    On fracture decks the kernel also returns the triaxiality of the final
    stress, and the erosion walk (kernel E on the card) masks it by the
    pre-erosion ``flag`` (a dead element's stale stress counts as zero) and
    walks the table on the new eq_ps, giving the post-erosion flag (and,
    with a chunk's activity ``carry``, whether any element died).
    ``triax`` is None on fracture-free decks (the chunk loop forms it once
    at its exit)."""
    _element_kernel(model)
    out = element_core_packed(model, P, flag, disp, disp_prev,
                              want_triax=model.fracture_enabled)
    P_new, qe = out[0], out[1]
    triax = None
    if model.fracture_enabled:
        w = erosion_walk(model, P_new[56:64], out[2], flag, mask_triax=True,
                         carry=carry)
        triax, flag = w.triax, w.element_flag
    return P_new, qe, triax, flag
