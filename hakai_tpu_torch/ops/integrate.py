"""The central-difference update in plain PyTorch (mirrors
``amplitude_values``, ``apply_bc`` and ``_integrate`` of
``hakai_tpu/solver/explicit.py``, which XLA fuses on the TPU): the plain
version of kernel I (``ops/integrate_cuda.py``), and the CPU path."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lowering import LoweredModel


class Update(NamedTuple):
    """One step's central-difference update (device tensors)."""
    t: torch.Tensor              # () int32, the step after this one
    disp_new: torch.Tensor       # (3, N)
    velo: torch.Tensor           # (3, N)
    dwork: torch.Tensor | None   # (2,) [dW_ext, dW_int], with energy_check
    position: torch.Tensor | None  # (3, N) coord + disp_new, element dtype
    d_disp: torch.Tensor | None    # (3, N) disp_new - disp, element dtype


def amplitude_values(model: LoweredModel, current_time):
    """Piecewise-linear amplitude interpolation, one value per table.  The
    first segment holding ``current_time`` wins; outside every segment the
    first segment is extrapolated."""
    T, V, n = model.amp_time, model.amp_value, model.amp_n
    t0, t1 = T[:, 0], T[:, 1]
    v0, v1 = V[:, 0], V[:, 1]
    found = torch.zeros(T.shape[0], dtype=torch.bool, device=T.device)
    for j in range(T.shape[1] - 1):
        inside = ((current_time >= T[:, j]) & (current_time <= T[:, j + 1])
                  & (j < n - 1) & ~found)
        t0 = torch.where(inside, T[:, j], t0)
        t1 = torch.where(inside, T[:, j + 1], t1)
        v0 = torch.where(inside, V[:, j], v0)
        v1 = torch.where(inside, V[:, j + 1], v1)
        found = found | inside
    return v0 + (v1 - v0) * (current_time - t0) / (t1 - t0)


def apply_bc(model: LoweredModel, disp_new, current_time):
    """Prescribed displacements: disp_new[dof] = value * amplitude (BC
    entries were deduplicated last-wins at lowering)."""
    ampv = amplitude_values(model, current_time)
    fac = torch.ones_like(disp_new)
    for a in range(ampv.shape[0]):
        fac = torch.where(model.bcd_amp == a, ampv[a], fac)
    return torch.where(model.bcd_mask, model.bcd_value * fac, disp_new)


def central_difference_plain(model: LoweredModel, state, external=None,
                             element_inputs: bool = False) -> Update:
    """The step's update from ``state`` and the contact force ``external``
    (3, N) or None.  Time and a1 = M/dt^2 are formed in the model dtype, as
    the JAX step forms them; ``dwork`` only with ``config.energy_check``,
    the element-dtype inputs of the element kernel only with
    ``element_inputs`` (the nodal difference taken first)."""
    dt = model.dt_t
    t = state.t + 1
    current_time = t.to(model.dtype) * dt
    a1 = model.diag_M / dt**2
    a2 = model.diag_M * model.config.damping_C / (2.0 * dt)
    force = -state.Q if external is None else external - state.Q
    numer = (force + a1 * (2.0 * state.disp - state.disp_pre)
             + a2 * state.disp_pre)
    disp_new = numer / (a1 + a2)
    disp_new = apply_bc(model, disp_new, current_time)
    disp_new = torch.where(model.node_exists, disp_new, 0.0)
    velo = (disp_new - state.disp) / dt
    dwork = None
    if model.config.energy_check:
        # discrete energy balance: with du_mid = (u_new - u_prev)/2,
        # dKE = (F_ext + F_c - Q) . du_mid exactly in real arithmetic, F_c
        # the constraint force realizing the prescribed motion at BC dofs
        du_mid = 0.5 * (disp_new - state.disp_pre)
        f_c = torch.where(model.bcd_mask, (a1 + a2) * disp_new - numer, 0.0)
        w_ext = f_c if external is None else external + f_c
        dwork = torch.stack([torch.sum(w_ext * du_mid),
                             torch.sum(state.Q * du_mid)])
    position = d_disp = None
    if element_inputs:
        edt = model.edtype
        position = (model.coord + disp_new).to(edt)
        d_disp = (disp_new - state.disp).to(edt)
    return Update(t, disp_new, velo, dwork, position, d_disp)
