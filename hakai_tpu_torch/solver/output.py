"""Node-averaged output fields in plain PyTorch (mirrors
``hakai_tpu/solver/output.py``): Gauss values -> element average ->
incidence-weighted node average.  Deleted elements keep their zeroed state
and still count in the divisor, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lowering import LoweredModel


class NodeData(NamedTuple):
    stress: torch.Tensor        # (6, N)
    strain: torch.Tensor        # (6, N)
    eq_ps: torch.Tensor         # (N,)
    mises: torch.Tensor         # (N,)
    triax: torch.Tensor         # (N,)


def _node_average(model: LoweredModel, elem_val):
    """(..., E) element field -> (..., N) incidence-averaged node field."""
    e_of = model.inc_idx % model.E                  # (V, N) element ids
    gathered = elem_val[..., e_of]                  # (..., V, N)
    s = torch.where(model.inc_mask, gathered, 0.0).sum(dim=-2)
    cnt = model.inc_mask.sum(dim=0)
    return s / torch.clamp(cnt, min=1)


def node_fields(model: LoweredModel, stress, strain, eq_ps, triax) -> NodeData:
    ns = _node_average(model, stress.mean(dim=1))   # (6, N)
    ne = _node_average(model, strain)               # strain is the GP mean
    np_ = _node_average(model, eq_ps.mean(dim=0))
    nt = _node_average(model, triax.mean(dim=0))
    sx, sy, sz, txy, tyz, txz = (ns[i] for i in range(6))
    mises = torch.sqrt(0.5 * ((sx - sy)**2 + (sy - sz)**2 + (sx - sz)**2
                              + 6.0 * (txy**2 + tyz**2 + txz**2)))
    return NodeData(ns, ne, np_, mises, nt)
