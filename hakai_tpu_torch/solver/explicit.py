"""Explicit central-difference time integration on the packed Gauss state
(mirrors the fused packed chunk loop of ``hakai_tpu/solver/explicit.py``).

A step is three things: the central-difference update with
amplitude-scaled boundary conditions (plain PyTorch), the fused element
kernel, and the assembly kernel.  The step counter and the current time
stay on the device: nothing in the loop reads a value back to the host.
"""
from __future__ import annotations

import torch

from ..core.lowering import LoweredModel
from ..core.state import SimState
from ..ops.assemble_cuda import assemble_internal_force
from ..ops.element import triax_components
from ..ops.element_cuda import element_core_packed


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


def _integrate(model: LoweredModel, state: SimState):
    """Central difference + BCs.  Returns (t, disp_new, velo, dwork); dwork
    is the [dW_ext, dW_int] increment pair, or None unless
    ``config.energy_check``.  Time and a1 = M/dt^2 are formed in the model
    dtype, as the JAX step forms them."""
    dt = model.dt_t
    t = state.t + 1
    current_time = t.to(model.dtype) * dt
    a1 = model.diag_M / dt**2
    a2 = model.diag_M * model.config.damping_C / (2.0 * dt)
    # no contact: the external force is zero
    numer = (-state.Q + a1 * (2.0 * state.disp - state.disp_pre)
             + a2 * state.disp_pre)
    disp_new = numer / (a1 + a2)
    disp_new = apply_bc(model, disp_new, current_time)
    disp_new = torch.where(model.node_exists, disp_new, 0.0)
    velo = (disp_new - state.disp) / dt
    dwork = None
    if model.config.energy_check:
        # discrete energy balance: with du_mid = (u_new - u_prev)/2,
        # dKE = (F_c - Q) . du_mid exactly in real arithmetic, F_c the
        # constraint force realizing the prescribed motion at BC dofs
        du_mid = 0.5 * (disp_new - state.disp_pre)
        f_c = torch.where(model.bcd_mask, (a1 + a2) * disp_new - numer, 0.0)
        dwork = torch.stack([torch.sum(f_c * du_mid),
                             torch.sum(state.Q * du_mid)])
    return t, disp_new, velo, dwork


def step_fast_packed_fused(model: LoweredModel, state: SimState, P):
    """One step on the packed Gauss state ``P`` (72, E): returns the new
    state (its stress fields stale until :func:`unpack_gauss_state`) and
    the new P.  The element kernel gathers disp and the previous disp
    itself, so no element-node copy of either is formed."""
    t, disp_new, velo, dwork = _integrate(model, state)
    P_new, qe = element_core_packed(model, P, state.element_flag, disp_new,
                                    state.disp)
    Q = assemble_internal_force(model, qe).to(model.dtype)
    work = state.work if dwork is None else state.work + dwork
    return state.replace(t=t, disp=disp_new, disp_pre=state.disp, velo=velo,
                         Q=Q, work=work), P_new


def pack_gauss_state(state: SimState):
    """(72, E) packed Gauss state: stress 0:48, GP-mean strain 48:54, zero
    pad 54:56, eq_ps 56:64, yield 64:72."""
    E = state.eq_ps.shape[1]
    return torch.cat([state.stress.reshape(48, E), state.strain,
                      state.strain.new_zeros((2, E)), state.eq_ps,
                      state.yield_s])


def unpack_gauss_state(state: SimState, P) -> SimState:
    E = P.shape[1]
    return state.replace(stress=P[:48].reshape(6, 8, E), strain=P[48:54],
                         eq_ps=P[56:64], yield_s=P[64:72])


def run_chunk(model: LoweredModel, state: SimState, n_steps: int) -> SimState:
    """Advance ``n_steps`` steps.  Dead elements keep stale stress inside
    the chunk and are zeroed once at its exit; the triaxiality is formed
    once at exit from the final stress."""
    P = pack_gauss_state(state)
    for _ in range(n_steps):
        state, P = step_fast_packed_fused(model, state, P)
    P = torch.cat([torch.where(state.element_flag[None, :], P[:56], 0.0),
                   P[56:]])
    state = state.replace(
        triax=triax_components([P[8 * c:8 * (c + 1)] for c in range(6)]))
    return unpack_gauss_state(state, P)
