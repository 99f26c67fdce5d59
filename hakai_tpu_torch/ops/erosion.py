"""Ductile-damage element erosion (mirrors ``hakai_tpu/ops/erosion.py``,
which is XLA and no Pallas kernel there): the plain versions and the
entries the steps call, which run kernel E (``ops/erosion_cuda.py``) on
the card and the plain versions on the CPU.

Per element: average the equivalent plastic strain and the triaxiality over
the 8 Gauss points; interpolate the fracture strain from the material's
ductile table on the triaxiality; delete the element (flag off) when the
average plastic strain reaches it.  Elements with a negative average
triaxiality never erode.  The failure-stress criterion is inert, as in the
JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lowering import LoweredModel


class ErosionResult(NamedTuple):
    element_flag: torch.Tensor  # (E,) bool
    stress: torch.Tensor        # (6, 8, E) zeroed where dead
    strain: torch.Tensor        # (6, E) GP-mean accumulator, zeroed likewise
    deleted_now: torch.Tensor   # (E,) bool, deleted this step


def _gp_mean(x):
    """(8, E) -> (E,): the Gauss-point sum taken in the fixed order
    k = 0..7 on every device, then divided by 8 (exact)."""
    acc = x[0]
    for k in range(1, 8):
        acc = acc + x[k]
    return acc / 8.0


def fracture_strain(model: LoweredModel, t_e):
    """(E,) fracture strain at the element triaxiality ``t_e`` from each
    element's material table; +inf where the material has none.

    Unrolled per material with the table knots as scalar constants.  The
    default is the last row's strain; row segments interpolate on the
    half-open ``t0 <= t_e < t1``."""
    fr = torch.full_like(t_e, float("inf"))
    for m, tab in enumerate(model.du_tables):
        nd = len(tab)
        if nd == 0:
            continue
        fr_m = torch.full_like(t_e, tab[nd - 1][0])
        for j in range(nd - 1):
            f0, t0 = tab[j]
            f1, t1 = tab[j + 1]
            if t1 == t0:
                continue
            seg = (t_e >= t0) & (t_e < t1)
            fr_m = torch.where(seg, f0 + (f1 - f0) / (t1 - t0) * (t_e - t0),
                               fr_m)
        fr = torch.where(model.mat_id == m, fr_m, fr)
    return fr


def element_means(eq_ps, triax):
    """(v_e, t_e): the Gauss-point means of eq_ps and triax that erosion
    reads."""
    return _gp_mean(eq_ps), _gp_mean(triax)


def erosion_delete_mask_plain(model: LoweredModel, eq_ps, triax,
                              element_flag):
    """(new_flag, delete) per element: the ductile-table walk without any
    state zeroing.  An alive element is deleted when its mean triaxiality
    is >= 0 and its mean eq_ps reaches :func:`fracture_strain`."""
    v_e, t_e = element_means(eq_ps, triax)
    delete = ((t_e >= 0.0) & (v_e >= fracture_strain(model, t_e))
              & element_flag)
    return element_flag & ~delete, delete


def erosion_delete_mask(model: LoweredModel, eq_ps, triax, element_flag):
    """:func:`erosion_delete_mask_plain` through kernel E on the card (on
    the CPU the plain version): the counterpart of the JAX package's
    ``erosion_delete_mask``, kept for the parity test that holds the two
    packages' walks against each other (``tests/test_torch_erosion.py``);
    the steps call :func:`erode` or the walk itself."""
    from .erosion_cuda import erosion_walk
    w = erosion_walk(model, eq_ps, triax, element_flag)
    return w.element_flag, w.deleted


def erode(model: LoweredModel, stress, strain, eq_ps, triax,
          element_flag, carry=None) -> ErosionResult:
    """The table walk plus the zeroing of every dead element's stress and
    strain (the generic step's form; the chunk loop defers the zeroing to
    its exit), through kernel E on the card, which zeroes them in place,
    and plain on the CPU; with a chunk's activity ``carry``, whether any
    element died is left in ``carry.flags[2]``."""
    from .erosion_cuda import erosion_walk
    w = erosion_walk(model, eq_ps, triax, element_flag, stress=stress,
                     strain=strain, carry=carry)
    return ErosionResult(w.element_flag, w.stress, w.strain, w.deleted)
