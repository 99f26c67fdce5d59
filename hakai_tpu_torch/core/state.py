"""Simulation state: the per-step arrays of the time loop as one dataclass
of tensors (mirrors ``hakai_tpu/core/state.py``).

``Q`` is state because the central-difference update at step ``t`` uses
the internal force assembled at the end of step ``t-1``.

Nodal fields and the work pair take the model's nodal dtype, Gauss-point
fields its element dtype (float64 and float32 in mixed mode).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .lowering import LoweredModel


@dataclass(frozen=True)
class SimState:
    t: torch.Tensor              # () int32 completed step count
    disp: torch.Tensor           # (3, N)
    disp_pre: torch.Tensor       # (3, N)
    velo: torch.Tensor           # (3, N)
    Q: torch.Tensor              # (3, N) internal force from the last step
    stress: torch.Tensor         # (6, 8, E) Gauss-point Cauchy stress
    strain: torch.Tensor         # (6, E) accumulated GP-mean strain
    eq_ps: torch.Tensor          # (8, E) equivalent plastic strain
    yield_s: torch.Tensor        # (8, E) current yield stress
    triax: torch.Tensor          # (8, E) stress triaxiality
    element_flag: torch.Tensor   # (E,) bool alive mask (padding = False)
    contact_force: torch.Tensor  # (3, N) last contact force
    work: torch.Tensor           # (2,) [W_ext + constraint, W_int]

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "SimState":
        return SimState(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})


def init_state(model: LoweredModel) -> SimState:
    """Initial state on the model's device.  The initial velocity enters
    through the back-difference start ``disp_pre = -velo0 * dt``."""
    kdt, edt, dev = model.dtype, model.edtype, model.device
    N, E = model.N, model.E

    def zeros(dt, *shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    return SimState(
        t=torch.zeros((), dtype=torch.int32, device=dev),
        disp=zeros(kdt, 3, N),
        disp_pre=-model.velo0 * model.dt_t,
        velo=model.velo0.clone(),
        Q=zeros(kdt, 3, N),
        stress=zeros(edt, 6, 8, E),
        strain=zeros(edt, 6, E),
        eq_ps=zeros(edt, 8, E),
        yield_s=model.yield0_e.expand(8, E).clone(),
        triax=zeros(edt, 8, E),
        element_flag=model.elem_exists.clone(),
        contact_force=zeros(kdt, 3, N),
        work=zeros(kdt, 2),
    )


# Gauss-point fields, in the element dtype; the other floats are nodal
ELEMENT_FIELDS = ("stress", "strain", "eq_ps", "yield_s", "triax")


def state_from_numpy(fields: dict, dtype: torch.dtype, device,
                     edtype: torch.dtype | None = None) -> SimState:
    """Build a :class:`SimState` on ``device`` from NumPy arrays keyed by
    field name (e.g. a JAX ``SimState``'s fields taken with ``np.asarray``,
    or a checkpoint).  Nodal floats take ``dtype``, Gauss-point floats
    ``edtype`` (default ``dtype``); ``t`` is int32 and ``element_flag``
    bool."""
    edtype = dtype if edtype is None else edtype

    def tensor(name):
        a = np.asarray(fields[name])
        if name == "t":
            return torch.as_tensor(a.astype(np.int32), device=device)
        if name == "element_flag":
            return torch.as_tensor(a.astype(bool), device=device)
        dt = edtype if name in ELEMENT_FIELDS else dtype
        return torch.as_tensor(a.astype(np.float64), device=device).to(dt)

    return SimState(**{f.name: tensor(f.name)
                       for f in dataclasses.fields(SimState)})
