"""Hex8 element update in plain PyTorch: B-bar kinematics, elastic trial,
J2 radial return with piecewise-linear hardening, and the internal-force
fold (mirrors ``hakai_tpu/ops/element.py:_element_math``, direct form).

These functions are the plain versions of the port's CUDA kernels: the
kernel wrappers (``element_cuda``, ``assemble_cuda``) run them for tensors
on the CPU, the tests hold them against the JAX package, and the card's
smoke run holds the kernels against them.  They run in float32 and
float64, and in mixed mode (float64 nodal fields, float32 element math).

Layouts: nodal fields (3, N); element-node fields (3, 8, E) indexed
[axis, node slot, element]; Gauss-point fields (8, E); packed Gauss state
P (72, E) with stress rows c*8+k (0:48), GP-mean strain 48:54, zero pad
54:56, eq_ps 56:64 and yield 64:72; qe (24, E) with rows b*8+i.  The
generic step's unpacked state is stress (6, 8, E), strain (6, E), eq_ps and
yield (8, E), with qe (3, 8, E).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lowering import LoweredModel


def _det3(J):
    return (J[0][0] * J[1][1] * J[2][2] + J[0][1] * J[1][2] * J[2][0]
            + J[0][2] * J[1][0] * J[2][1] - J[0][0] * J[1][2] * J[2][1]
            - J[0][1] * J[1][0] * J[2][2] - J[0][2] * J[1][1] * J[2][0])


def _inv3(J, inv_det):
    """inv[b][a] = cofactor(a, b) * inv_det."""
    inv = [[None] * 3 for _ in range(3)]
    for a in range(3):
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        for b in range(3):
            b1, b2 = (b + 1) % 3, (b + 2) % 3
            inv[b][a] = (J[a1][b1] * J[a2][b2]
                         - J[a1][b2] * J[a2][b1]) * inv_det
    return inv


def hardening_slope(pl_tables, mat_id, eq_ps):
    """Slope H of the piecewise-linear hardening curve at eq_ps (8, B):
    the segment index counts table strains j >= 1 strictly below eq_ps,
    capped at npp-2; H = 0 for materials with fewer than two rows."""
    H = torch.zeros_like(eq_ps)
    for m, tab in enumerate(pl_tables):
        npp = len(tab)
        if npp < 2:
            continue
        Hd = [(tab[j + 1][0] - tab[j][0]) / (tab[j + 1][1] - tab[j][1])
              for j in range(npp - 1)]
        cnt = torch.zeros(eq_ps.shape, dtype=torch.int32,
                          device=eq_ps.device)
        for j in range(1, npp):
            cnt = cnt + (eq_ps > tab[j][1]).to(torch.int32)
        pidx = torch.clamp(cnt, max=npp - 2)
        Hm = torch.full_like(eq_ps, Hd[npp - 2])
        for j in range(npp - 3, -1, -1):
            Hm = torch.where(pidx == j, Hd[j], Hm)
        H = torch.where((mat_id == m)[None, :], Hm, H)
    return H


def element_math(pl_tables, mat_id, G_e, lam_e, has_plastic_e, pus, pos_e,
                 du, stress, strain, eq_ps, yield_s, element_flag):
    """B-bar + radial return + internal force on (..., B) tensors.

    ``pos_e`` (3, 8, B) must be centred on each element's node 0 (row 0
    zero); ``du`` (3, 8, B) is the displacement increment; ``pus`` (8, 3, 8)
    the shape gradients.  ``stress`` is 6 x (8, B), ``strain`` 6 x (B,)
    GP-mean accumulators.  Returns (Qe (3, 8, B), stress 6 x (8, B),
    strain 6 x (B,), eq_ps (8, B), yield_s (8, B))."""
    # J[a][b] = sum_i pus[k,a,i] pos[b,i]; Gdu[c][b] = sum_i pus[k,c,i] du[b,i]
    J = torch.einsum("kai,bie->abke", pus, pos_e)
    Gdu = torch.einsum("kai,bie->abke", pus, du)
    detJ = _det3(J)                                   # (8, B), signed
    # V and volbar use |detJ|; the Qe weight uses the signed detJ
    detJ_abs = detJ.abs()
    inv_det = 1.0 / torch.where(detJ == 0, 1.0, detJ)
    invJ = _inv3(J, inv_det)
    V = detJ_abs.sum(dim=0)                           # (B,)
    inv_V = 1.0 / torch.where(V == 0, 1.0, V)

    # displacement gradient g[a][b] = sum_c invJ[a][c] Gdu[c][b]
    g = [[invJ[a][0] * Gdu[0][b] + invJ[a][1] * Gdu[1][b]
          + invJ[a][2] * Gdu[2][b] for b in range(3)] for a in range(3)]
    tr = g[0][0] + g[1][1] + g[2][2]
    volbar = ((detJ_abs * tr).sum(dim=0) * inv_V / 3.0)[None, :]
    de = [g[0][0] - tr / 3.0 + volbar,
          g[1][1] - tr / 3.0 + volbar,
          g[2][2] - tr / 3.0 + volbar,
          g[0][1] + g[1][0], g[1][2] + g[2][1], g[0][2] + g[2][0]]
    tr_de = 3.0 * volbar
    dsig = [lam_e * tr_de + 2.0 * G_e * de[c] for c in range(3)] + \
           [G_e * de[c] for c in range(3, 6)]
    trial = [stress[c] + dsig[c] for c in range(6)]
    mean_s = (trial[0] + trial[1] + trial[2]) / 3.0
    dev = [trial[0] - mean_s, trial[1] - mean_s, trial[2] - mean_s,
           trial[3], trial[4], trial[5]]
    vm = torch.sqrt(1.5 * (dev[0]**2 + dev[1]**2 + dev[2]**2
                           + 2.0 * (dev[3]**2 + dev[4]**2 + dev[5]**2)))

    # J2 radial return with piecewise-linear isotropic hardening
    H = hardening_slope(pl_tables, mat_id, eq_ps)
    is_plastic = (has_plastic_e[None, :] & (vm > yield_s)
                  & element_flag[None, :])
    safe_vm = torch.where(vm == 0, 1.0, vm)
    d_ep = torch.where(is_plastic, (vm - yield_s) / (3.0 * G_e + H), 0.0)
    scale = torch.where(is_plastic, (yield_s + H * d_ep) / safe_vm, 1.0)
    final = [torch.where(is_plastic,
                         dev[c] * scale + mean_s if c < 3 else dev[c] * scale,
                         trial[c]) for c in range(6)]
    new_eq = torch.where(is_plastic, eq_ps + d_ep, eq_ps)
    new_y = torch.where(is_plastic, yield_s + H * d_ep, yield_s)
    new_strain = [strain[c] + 0.125 * de[c].sum(dim=0) for c in range(6)]

    # internal force: Qe[b,i] = sum_c sum_k pus[k,c,i] M[c][b][k] with
    #   M[c][b] = w*(sum_a invJ[a][c] s[a][b] - invJ[b][c] sig_m)
    #             + wdet*invJ[b][c]*sum_w_sig_m
    sig_m = (final[0] + final[1] + final[2]) / 3.0
    s_t = [[final[0], final[3], final[5]],
           [final[3], final[1], final[4]],
           [final[5], final[4], final[2]]]
    sum_w_sig_m = (detJ * sig_m).sum(dim=0)
    wdet = detJ_abs * inv_V
    M = torch.stack([torch.stack([
        detJ * (invJ[0][c] * s_t[0][b] + invJ[1][c] * s_t[1][b]
                + invJ[2][c] * s_t[2][b] - invJ[b][c] * sig_m)
        + wdet * (invJ[b][c] * sum_w_sig_m[None, :])
        for b in range(3)]) for c in range(3)])       # (3 c, 3 b, 8, B)
    Qe = torch.einsum("kci,cbke->bie", pus, M)
    Qe = torch.where(element_flag[None, None, :], Qe, 0.0)
    return Qe, final, new_strain, new_eq, new_y


class ElementResult(NamedTuple):
    """The unpacked element update (``hakai_tpu/ops/element.py``)."""
    Qe: torch.Tensor            # (3, 8, E) nodal internal forces
    stress: torch.Tensor        # (6, 8, E) updated Cauchy stress
    strain: torch.Tensor        # (6, E) GP-mean strain accumulator
    eq_ps: torch.Tensor         # (8, E)
    yield_s: torch.Tensor       # (8, E)
    neg_jacobian: torch.Tensor  # () int32 count of negative detJ


def gather_element_nodes(model: LoweredModel, position, d_disp):
    """(3, N) nodal fields -> per-element (3, 8, E) copies."""
    return position[:, model.elem], d_disp[:, model.elem]


def neg_jacobian_count(model: LoweredModel, pos_e, element_flag):
    """() int32: Gauss points of live elements whose Jacobian determinant
    is negative (``_det_sign_negative``; a diagnostic).  J is an ``einsum``
    over the node-0-centred positions in their dtype.  This is the count's
    CPU path and the oracle of the unpacked kernel's own count, whose J
    sums in another order: the two can differ only on points whose
    ``|detJ|`` is at rounding level."""
    J = torch.einsum("kai,bie->abke", model.pusai.to(pos_e.dtype),
                     pos_e - pos_e[:, 0:1, :])
    neg = (_det3(J) < 0) & element_flag[None, :]
    return neg.sum(dtype=torch.int32)


def element_core_plain(model: LoweredModel, pos_e, du, stress, strain,
                       eq_ps, yield_s, element_flag) -> ElementResult:
    """Plain version of the unpacked element kernel (TPU kernel #3,
    ``element_core_pallas``): the element math on (3, 8, E) positions and
    increments in the element dtype, centred on node 0 here, in that dtype
    (``_element_math(pre_centered=False)``).  ``neg_jacobian`` is counted
    when the config streams metrics (``metrics_path``), else 0, as
    ``element_core`` fills it."""
    qe, s, e, eq, y = element_math(
        model.pl_tables, model.mat_id, model.G_e, model.lam_e,
        model.has_plastic_e, model.pusai, pos_e - pos_e[:, 0:1, :], du,
        [stress[c] for c in range(6)], [strain[c] for c in range(6)],
        eq_ps, yield_s, element_flag)
    neg = (neg_jacobian_count(model, pos_e, element_flag)
           if model.config.metrics_path is not None
           else torch.zeros((), dtype=torch.int32, device=pos_e.device))
    return ElementResult(qe, torch.stack(s), torch.stack(e), eq, y, neg)


def element_core_packed_plain(model: LoweredModel, P, flag, disp, disp_prev,
                              want_triax=False):
    """Plain version of the fused element kernel: one step of the element
    update on the packed state.

    ``P`` (72, E) packed Gauss state and the math in the element dtype,
    ``flag`` (E,) bool life mask, ``disp``/``disp_prev`` (3, N) the new and
    previous nodal displacement in the nodal dtype.  Gathers through
    ``model.elem`` and takes both kinematic differences in the nodal dtype
    before the cast (``hakai_tpu/ops/element.py:element_kinematics``):
    pos = coord_e + (d - d_node0), du = d - dprev.  Returns (P_new (72, E),
    qe (24, E)), and with ``want_triax`` also the (8, E) triaxiality of the
    final stress."""
    E, edt = P.shape[1], model.edtype
    d = disp[:, model.elem]                           # (3, 8, E) nodal dtype
    pos = model.coord_e + (d - d[:, 0:1, :]).to(edt)
    du = (d - disp_prev[:, model.elem]).to(edt)
    qe, s, e, eq, y = element_math(
        model.pl_tables, model.mat_id, model.G_e, model.lam_e,
        model.has_plastic_e, model.pusai, pos, du,
        [P[8 * c:8 * (c + 1)] for c in range(6)],
        [P[48 + c] for c in range(6)],
        P[56:64], P[64:72], flag)
    P_new = torch.cat([*s, torch.stack(e), P.new_zeros((2, E)), eq, y])
    if want_triax:
        return P_new, qe.reshape(24, E), triax_components(s)
    return P_new, qe.reshape(24, E)


def assemble_internal_force_plain(model: LoweredModel, qe24):
    """Plain version of the assembly kernel: Q (3, N) from qe (24, E) by the
    incidence table, a masked sum over the V incident (slot, element)
    entries of each node in the fixed order v = 0..V-1."""
    qf = qe24.reshape(3, -1)                          # (3, 8E), i*E+e
    gathered = qf[:, model.inc_idx]                   # (3, V, N)
    return torch.where(model.inc_mask[None], gathered, 0.0).sum(dim=1)


def triax_stress(stress, eps: float = 1e-10):
    """Triaxiality per Gauss point of a (6, 8, E) stress."""
    return triax_components([stress[c] for c in range(6)], eps)


def triax_components(s, eps: float = 1e-10):
    """Stress triaxiality sigma_m / sigma_eq from a 6-component stress
    sequence; points with sigma_eq < eps keep 0."""
    sx, sy, sz, txy, tyz, txz = s
    vm = torch.sqrt(0.5 * ((sx - sy)**2 + (sy - sz)**2 + (sx - sz)**2
                           + 6.0 * (txy**2 + tyz**2 + txz**2)))
    mean = (sx + sy + sz) / 3.0
    return torch.where(vm < eps, 0.0, mean / torch.where(vm == 0, 1.0, vm))
