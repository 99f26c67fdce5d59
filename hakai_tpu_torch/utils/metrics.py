"""Structured run metrics in plain PyTorch (mirrors
``hakai_tpu/utils/metrics.py``): scalar diagnostics of the state, the
discrete energy balance, and an append-only JSONL writer called between
solver chunks.
"""
from __future__ import annotations

import json
from typing import IO

import torch

from ..core.lowering import LoweredModel
from ..core.state import SimState


def _elastic_energy(G_e, lam_e, vol_e, stress, flag):
    """Elastic strain energy from the constitutive state: per Gauss point
    u = sigma : C^-1 sigma / 2 in isotropic component form, weighted by
    vol_e/8 (initial geometry; diagnostics only)."""
    G = torch.where(G_e == 0, 1.0, G_e)
    nu = lam_e / (2.0 * (lam_e + G))
    E_y = 2.0 * G * (1.0 + nu)
    sx, sy, sz, txy, tyz, txz = (stress[c] for c in range(6))
    u_gp = ((sx**2 + sy**2 + sz**2
             - 2.0 * nu * (sx * sy + sy * sz + sz * sx)) / (2.0 * E_y)
            + (txy**2 + tyz**2 + txz**2) / (2.0 * G))
    wv = torch.where(flag, vol_e, 0.0) / 8.0
    return torch.sum(u_gp.sum(dim=-2) * wv)


def _plastic_dissipation(vol_e, yield0_e, yield_s, eq_ps, flag):
    """integral(sigma_y d eps_p) with the trapezoid (yield0 + yield_now)/2
    per Gauss point."""
    wv = torch.where(flag, vol_e, 0.0) / 8.0
    wp_gp = 0.5 * (yield0_e[..., None, :] + yield_s) * eq_ps
    return torch.sum(wp_gp.sum(dim=-2) * wv)


def _kinetic(model: LoweredModel, v):
    return 0.5 * torch.sum(model.diag_M * (v * v).sum(dim=0))


def _energy_terms(model: LoweredModel, state: SimState):
    """(KE, KE0, elastic energy, plastic dissipation)."""
    return (_kinetic(model, state.velo), _kinetic(model, model.velo0),
            _elastic_energy(model.G_e, model.lam_e, model.vol_e,
                            state.stress, state.element_flag),
            _plastic_dissipation(model.vol_e, model.yield0_e, state.yield_s,
                                 state.eq_ps, state.element_flag))


def _energy_fields(ke, ke0, work, u_el, w_p):
    """Balance scalars: ``balance_residual`` = KE - KE0 - W_ext + W_int is
    zero in real arithmetic for the central-difference update, so its
    magnitude tracks accumulated roundoff energy; ``energy_rel_error``
    normalises it by the run's energy scale."""
    w_ext, w_int = work[0], work[1]
    residual = ke - ke0 - w_ext + w_int
    scale = torch.maximum(
        torch.maximum(torch.maximum(ke, ke0),
                      torch.maximum(w_ext.abs(), w_int.abs())),
        torch.maximum(u_el + w_p, torch.tensor(1e-30, dtype=ke.dtype,
                                               device=ke.device)))
    return dict(work_external=w_ext, work_internal=w_int,
                elastic_energy=u_el, plastic_dissipation=w_p,
                balance_residual=residual,
                energy_rel_error=residual.abs() / scale)


def step_metrics(model: LoweredModel, state: SimState) -> dict:
    """Scalar diagnostics of the current state, as 0-d tensors."""
    d_disp = state.disp - state.disp_pre
    out = dict(
        kinetic_energy=_kinetic(model, state.velo),
        d_max=torch.sqrt((d_disp * d_disp).sum(dim=0)).max(),
        contact_force_max=state.contact_force.abs().max(),
        alive_elements=state.element_flag.sum(),
        eq_plastic_strain_max=state.eq_ps.max(),
        stress_absmax=state.stress.abs().max(),
        disp_absmax=state.disp.abs().max(),
    )
    if model.config.energy_check:
        ke, ke0, u_el, w_p = _energy_terms(model, state)
        out.update(_energy_fields(ke, ke0, state.work, u_el, w_p))
    return out


def energy_guard(model: LoweredModel, state: SimState):
    """|residual| / scale for the between-chunk divergence abort."""
    ke, ke0, u_el, w_p = _energy_terms(model, state)
    return _energy_fields(ke, ke0, state.work, u_el, w_p)["energy_rel_error"]


def halo_step_metrics(hm, s, group=None) -> dict:
    """:func:`step_metrics` of halo state (``parallel/halo.py``) without
    gathering it: every scalar reduces over the shards' arrays, and with a
    process ``group`` over the ranks too (``s`` and ``hm`` then one rank's
    row; sums and maxima each in one ``all_reduce``, taken in float64 and
    cast back).  ``hm`` and ``s`` may also be shard-major (S, ...) on one
    process.  The halo state carries no contact force: its max is 0.0, as
    in the JAX package (``hakai_tpu/utils/metrics.py:halo_step_metrics``)."""
    import torch.distributed as dist
    whole = s.disp.dim() == 3
    v = s.velo
    d_disp = s.disp - s.disp_pre
    sums = dict(kinetic_energy=0.5 * torch.sum(hm.diag_M
                                               * (v * v).sum(dim=-2)),
                alive_elements=s.element_flag.sum())
    maxes = dict(d_max=torch.sqrt((d_disp * d_disp).sum(dim=-2)).max(),
                 eq_plastic_strain_max=s.eq_ps.max(),
                 stress_absmax=s.stress.abs().max(),
                 disp_absmax=s.disp.abs().max())
    check = hm.base.config.energy_check
    if check:
        stress = s.stress.movedim(1, 0) if whole else s.stress
        work = s.work.sum(dim=0) if whole else s.work
        sums.update(
            ke0=0.5 * torch.sum(hm.diag_M * (hm.velo0 ** 2).sum(dim=-2)),
            u_el=_elastic_energy(hm.G_e.unsqueeze(-2),
                                 hm.lam_e.unsqueeze(-2), hm.vol_e, stress,
                                 s.element_flag),
            w_p=_plastic_dissipation(hm.vol_e, hm.yield0_e, s.yield_s,
                                     s.eq_ps, s.element_flag),
            w_ext=work[0], w_int=work[1])
    if group is not None:
        for vals, op in ((sums, dist.ReduceOp.SUM),
                         (maxes, dist.ReduceOp.MAX)):
            buf = torch.stack([x.to(torch.float64) for x in vals.values()])
            dist.all_reduce(buf, op=op, group=group)
            for (k, x), r in zip(list(vals.items()), buf):
                vals[k] = r.to(x.dtype)
    out = dict(kinetic_energy=sums["kinetic_energy"], d_max=maxes["d_max"],
               contact_force_max=torch.zeros((), dtype=s.disp.dtype,
                                             device=s.disp.device),
               alive_elements=sums["alive_elements"],
               eq_plastic_strain_max=maxes["eq_plastic_strain_max"],
               stress_absmax=maxes["stress_absmax"],
               disp_absmax=maxes["disp_absmax"])
    if check:
        out.update(_energy_fields(
            sums["kinetic_energy"], sums["ke0"],
            torch.stack([sums["w_ext"], sums["w_int"]]), sums["u_el"],
            sums["w_p"]))
    return out


class MetricsWriter:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: str | None):
        self._f: IO | None = open(path, "a") if path else None
        self.history: list[dict] = []

    def record_raw(self, values: dict, model: LoweredModel, step: int,
                   wall_s: float) -> dict:
        """Record one chunk's scalars (:func:`step_metrics` or
        :func:`halo_step_metrics`)."""
        rec = {k: float(v) for k, v in values.items()}
        rec["step"] = step
        rec["time"] = step * model.dt
        rec["wall_s"] = wall_s
        self.history.append(rec)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self):
        if self._f:
            self._f.close()
