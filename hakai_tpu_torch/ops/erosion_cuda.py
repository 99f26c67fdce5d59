"""Wrapper of kernel E (``csrc/erosion.cu``): the erosion walk, the
counterpart of the XLA fusion of ``hakai_tpu/ops/erosion.py:29-74`` with the
packed step's triaxiality mask (``hakai_tpu/ops/element_pallas.py:
607-624``).

For tensors on the CPU the wrapper runs the plain versions
(``ops/erosion.py``); for CUDA tensors it launches the kernel on the
current stream, or raises.  On the card the triaxiality mask and the
zeroing of dead elements' stress and strain are written in place into the
tensors given (the element kernel's fresh outputs on the step's paths).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from .erosion import erosion_delete_mask_plain

_ENTRIES = {torch.float32: "hk_erosion_f32", torch.float64: "hk_erosion_f64"}


class Walk(NamedTuple):
    """The walk's results; ``stress``/``strain`` None unless given."""
    element_flag: torch.Tensor  # (E,) bool after erosion
    deleted: torch.Tensor       # (E,) bool, deleted this step
    triax: torch.Tensor         # (8, E), masked by the pre-erosion flag
    stress: torch.Tensor | None  # (6, 8, E) zeroed where dead
    strain: torch.Tensor | None  # (6, E) zeroed where dead


def erosion_walk(model, eq_ps, triax, flag, mask_triax=False, stress=None,
                 strain=None, carry=None) -> Walk:
    """The ductile-table walk on the (8, E) ``eq_ps`` and ``triax`` and the
    (E,) life mask ``flag``.  With ``mask_triax`` (the packed step) a dead
    element's triaxiality counts as zero (and is returned so); with
    ``stress``/``strain`` (the generic step) they come back zeroed where
    the element is dead after the walk; with ``carry`` (an
    :class:`~hakai_tpu_torch.ops.activity.ActivityCarry`) whether any
    element died is left in ``carry.flags[2]``, on the device."""
    dev = eq_ps.device
    if dev.type == "cpu":
        if mask_triax:
            triax = torch.where(flag[None, :], triax, 0.0)
        new_flag, delete = erosion_delete_mask_plain(model, eq_ps, triax,
                                                     flag)
        if stress is not None:
            stress = torch.where(new_flag[None, None, :], stress, 0.0)
            strain = torch.where(new_flag[None, :], strain, 0.0)
        if carry is not None:
            carry.flags[2] = delete.any()
        return Walk(new_flag, delete, triax, stress, strain)
    if dev.type != "cuda":
        raise ValueError(f"no erosion kernel for device {dev}")
    edt, E = eq_ps.dtype, eq_ps.shape[-1]
    if edt not in _ENTRIES:
        raise TypeError(f"no erosion kernel for dtype {edt}")
    M, K, _ = model.du_knots.shape
    spec = {"eq_ps": (eq_ps, (8, E), edt), "triax": (triax, (8, E), edt),
            "flag": (flag, (E,), torch.bool),
            "mat_id": (model.mat_id, (E,), torch.int32),
            "du_knots": (model.du_knots, (M, K, 2), torch.float64),
            "du_n": (model.du_n, (M,), torch.int32)}
    if stress is not None:
        spec.update(stress=(stress, (6, 8, E), edt),
                    strain=(strain, (6, E), edt))
    if carry is not None:
        spec["carry"] = (carry.flags, (3,), torch.int32)
    _build.check_inputs(dev, spec)
    new_flag = torch.empty(E, dtype=torch.bool, device=dev)
    deleted = torch.empty(E, dtype=torch.bool, device=dev)
    _build.launch(_ENTRIES[edt], dev, eq_ps, triax, int(mask_triax), flag,
                  model.mat_id, model.du_knots, model.du_n, M, K, E,
                  new_flag, deleted, stress, strain,
                  None if carry is None else carry.flags)
    return Walk(new_flag, deleted, triax, stress, strain)
