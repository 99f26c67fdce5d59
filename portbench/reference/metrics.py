"""The plain reference of the program's metrics stream: what one record
of ``--metrics`` (``SolverConfig.metrics_path``) holds for a state, and
the negative-Jacobian count of the element update, in float64 PyTorch.

Worked out again from a :class:`~portbench.reference.decks.Deck` and a
deck-order state, such as ``portbench/program.py:deck_order`` returns: nodal
``disp``, ``disp_pre``, ``velo``, ``contact`` (n, 3); ``stress`` (E, 8, 6),
``eq_ps`` and ``yield_s`` (E, 8), ``alive`` (E,); and, for the energy
balance, ``work`` (2,), the state's accumulated [W_ext, W_int].  It
imports nothing of the program.

Departures from the program's ``utils/metrics.py:step_metrics``, none of
which changes a value beyond rounding:

* the lumped mass is the reference solver's (``Reference.mass``: density
  times the volume over 8 at each node of an element, in deck order); the
  program's padding nodes, of unit mass, hold no velocity and are absent
  here;
* element volumes are the sums of the reference's own ``det J`` at the
  2x2x2 Gauss points of the initial mesh; the steel's constants (Young's
  modulus, Poisson's ratio, the first yield stress of the hardening table)
  are the deck's, where the program reads them per element from its
  lowering and recovers Poisson's ratio from G and lambda;
* the work is read from the state, not recomputed: it is the sum of every
  step's increments, which no single state holds;
* every sum is in float64 over unpadded deck-order arrays, where the
  program sums padded arrays in the element dtype (float32 in mixed
  precision for the elastic energy and the plastic dissipation).
"""
from __future__ import annotations

import numpy as np
import torch

from .decks import PLASTIC, POISSON, YOUNG, Deck
from .solver import Reference, shape_gradients


def _t(a, device):
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def jacobians(deck: Deck, disp, device="cpu"):
    """(E, 8, 3, 3) J[e, k, a, b] = sum_i dN_i/dxi_a x_ib at the Gauss
    points of every element, on the positions coord + ``disp`` (n, 3)."""
    x = _t(deck.coord.T, device) + _t(disp, device)            # (n, 3)
    elem = torch.as_tensor(deck.elem.T.copy(), device=device)  # (E, 8)
    pus = _t(shape_gradients(), device)                        # (8, 3, 8)
    return torch.einsum("kai,eib->ekab", pus, x[elem])


def neg_jacobian_count(deck: Deck, disp, alive, device="cpu") -> int:
    """Gauss points of live elements whose Jacobian determinant is
    negative, on coord + ``disp`` (n, 3); ``alive`` (E,) bool."""
    det = torch.linalg.det(jacobians(deck, disp, device))     # (E, 8)
    alive = torch.as_tensor(np.asarray(alive, bool), device=device)
    return int(((det < 0) & alive[:, None]).sum())


def volumes(deck: Deck, device="cpu"):
    """(E,) initial element volumes: sum of det J over the Gauss points."""
    return torch.linalg.det(jacobians(
        deck, np.zeros((deck.n_node, 3)), device)).sum(dim=1)


def record(deck: Deck, state: dict, energy_check: bool, device="cpu",
           ref: Reference | None = None) -> dict:
    """A metrics record's values (no ``step``, ``time``, ``wall_s``) for the
    deck-order ``state``, as floats; with ``energy_check`` also the energy
    balance.  ``ref``, the deck's :class:`Reference` on ``device``, gives
    the lumped mass (made here if not given)."""
    ref = ref or Reference(deck, device)
    f = {k: _t(state[k], device) for k in ("disp", "disp_pre", "velo",
                                           "contact", "stress", "eq_ps",
                                           "yield_s")}
    alive = torch.as_tensor(np.asarray(state["alive"], bool), device=device)
    mass = ref.mass[:, 0].to(torch.float64)                   # (n,)

    def kinetic(v):
        return 0.5 * (mass * (v * v).sum(dim=1)).sum()

    dd = f["disp"] - f["disp_pre"]
    out = dict(kinetic_energy=kinetic(f["velo"]),
               d_max=torch.sqrt((dd * dd).sum(dim=1)).max(),
               contact_force_max=f["contact"].abs().max(),
               alive_elements=alive.sum(),
               eq_plastic_strain_max=f["eq_ps"].max(),
               stress_absmax=f["stress"].abs().max(),
               disp_absmax=f["disp"].abs().max())
    if energy_check:
        wv = torch.where(alive, volumes(deck, device), 0.0) / 8.0   # (E,)
        G = YOUNG / (2.0 * (1.0 + POISSON))
        s = f["stress"]
        sx, sy, sz, txy, tyz, txz = (s[..., c] for c in range(6))
        u_gp = ((sx * sx + sy * sy + sz * sz
                 - 2.0 * POISSON * (sx * sy + sy * sz + sz * sx))
                / (2.0 * YOUNG) + (txy * txy + tyz * tyz + txz * txz)
                / (2.0 * G))
        u_el = (u_gp.sum(dim=1) * wv).sum()
        w_p = ((0.5 * (PLASTIC[0, 0] + f["yield_s"]) * f["eq_ps"])
               .sum(dim=1) * wv).sum()
        ke, ke0 = out["kinetic_energy"], kinetic(ref.velo0.to(torch.float64))
        w_ext, w_int = (float(w) for w in np.asarray(state["work"],
                                                     np.float64))
        residual = ke - ke0 - w_ext + w_int
        scale = max(float(ke), float(ke0), abs(w_ext), abs(w_int),
                    float(u_el + w_p), 1e-30)
        out.update(work_external=w_ext, work_internal=w_int,
                   elastic_energy=u_el, plastic_dissipation=w_p,
                   balance_residual=residual,
                   energy_rel_error=abs(float(residual)) / scale)
    return {k: float(v) for k, v in out.items()}
