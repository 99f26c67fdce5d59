"""Wrapper of kernel I (``csrc/integrate.cu``): the step's central-difference
update, the counterpart of the XLA fusion of ``amplitude_values``,
``apply_bc`` and ``_integrate`` (``hakai_tpu/solver/explicit.py:34-119``).

For tensors on the CPU the wrapper runs the plain version
(:func:`~hakai_tpu_torch.ops.integrate.central_difference_plain`); for CUDA
tensors it launches the kernel on the current stream, or raises.  The
kernel reads the step counter and dt on the device and returns the next
counter there, so a captured graph replays it.
"""
from __future__ import annotations

import torch

from .. import _build
from ..core.lowering import LoweredModel
from .integrate import Update, central_difference_plain

# (nodal dtype, element dtype) -> C entry
_ENTRIES = {(torch.float32, torch.float32): "hk_integrate_f32",
            (torch.float64, torch.float64): "hk_integrate_f64",
            (torch.float64, torch.float32): "hk_integrate_mixed"}
_BLOCK = 256                   # kBlock in csrc/integrate.cu
_MAX_TABLES = 4096             # amplitude values a block stages in shared
# (blocks, device) -> (per-block partial sums, the last-block ticket): the
# energy sums' workspace, allocated once outside any capture (the first
# call is a graph's warm-up step); the ticket is left zero by every call
_WORKSPACES: dict = {}


def _workspace(blocks: int, device):
    key = (blocks, device)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = (
            torch.empty(2 * blocks, dtype=torch.float64, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))
    return _WORKSPACES[key]


def central_difference(model: LoweredModel, state, external=None,
                       element_inputs: bool = False) -> Update:
    """The step's :class:`~hakai_tpu_torch.ops.integrate.Update` from
    ``state`` (its ``t``, ``disp``, ``disp_pre`` and ``Q``) and the contact
    force ``external`` (3, N) in the nodal dtype, or None.  ``dwork`` comes
    with ``config.energy_check``; with ``element_inputs`` also the element
    kernel's ``position`` and ``d_disp`` in the element dtype."""
    dev = state.disp.device
    if dev.type == "cpu":
        return central_difference_plain(model, state, external,
                                        element_inputs)
    if dev.type != "cuda":
        raise ValueError(f"no integrate kernel for device {dev}")
    kdt, edt, N = model.dtype, model.edtype, model.N
    if (kdt, edt) not in _ENTRIES:
        raise TypeError(f"no integrate kernel for dtypes {kdt}/{edt}")
    A, L = model.amp_time.shape
    if A > _MAX_TABLES:
        raise ValueError(f"{A} amplitude tables exceed the kernel's "
                         f"{_MAX_TABLES}")
    # the step counter and dt are one-element tensors (dt_t has shape (1,))
    t_in, dt = state.t.reshape(()), model.dt_t.reshape(())
    spec = {"t": (t_in, (), torch.int32), "dt_t": (dt, (), kdt),
            "diag_M": (model.diag_M, (N,), kdt),
            "Q": (state.Q, (3, N), kdt), "disp": (state.disp, (3, N), kdt),
            "disp_pre": (state.disp_pre, (3, N), kdt),
            "bcd_mask": (model.bcd_mask, (3, N), torch.bool),
            "bcd_amp": (model.bcd_amp, (3, N), torch.int32),
            "bcd_value": (model.bcd_value, (3, N), kdt),
            "amp_time": (model.amp_time, (A, L), kdt),
            "amp_value": (model.amp_value, (A, L), kdt),
            "amp_n": (model.amp_n, (A,), torch.int32),
            "node_exists": (model.node_exists, (N,), torch.bool),
            "coord": (model.coord, (3, N), kdt)}
    if external is not None:
        spec["external"] = (external, (3, N), kdt)
    _build.check_inputs(dev, spec)
    t = torch.empty_like(state.t)
    disp_new = torch.empty_like(state.disp)
    velo = torch.empty_like(state.disp)
    position = d_disp = dwork = None
    if element_inputs:
        position = torch.empty((3, N), dtype=edt, device=dev)
        d_disp = torch.empty((3, N), dtype=edt, device=dev)
    partial = ticket = None
    if model.config.energy_check:
        dwork = torch.empty(2, dtype=kdt, device=dev)
        partial, ticket = _workspace(-(-N // _BLOCK), dev)
    _build.launch(
        _ENTRIES[(kdt, edt)], dev, t_in, t, dt, model.diag_M,
        float(model.config.damping_C), state.Q, state.disp, state.disp_pre,
        external, model.bcd_mask, model.bcd_amp, model.bcd_value,
        model.amp_time, model.amp_value, model.amp_n, A, L,
        model.node_exists, model.coord, N, disp_new, velo, position, d_disp,
        partial, ticket, dwork)
    return Update(t, disp_new, velo, dwork, position, d_disp)
