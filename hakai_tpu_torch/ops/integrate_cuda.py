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

# (nodal dtype, element dtype) -> (C entry, variant name)
_ENTRIES = {(torch.float32, torch.float32): ("hk_integrate_f32", "float32"),
            (torch.float64, torch.float64): ("hk_integrate_f64", "float64"),
            (torch.float64, torch.float32): ("hk_integrate_mixed", "mixed")}
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
    lib = _build.library()
    entry, variant = _ENTRIES[(kdt, edt)]
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

    def ptr(x):
        return None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            t_in.data_ptr(), t.data_ptr(), dt.data_ptr(),
            model.diag_M.data_ptr(), float(model.config.damping_C),
            state.Q.data_ptr(), state.disp.data_ptr(),
            state.disp_pre.data_ptr(), ptr(external),
            model.bcd_mask.data_ptr(), model.bcd_amp.data_ptr(),
            model.bcd_value.data_ptr(), model.amp_time.data_ptr(),
            model.amp_value.data_ptr(), model.amp_n.data_ptr(), A, L,
            model.node_exists.data_ptr(), model.coord.data_ptr(), N,
            disp_new.data_ptr(), velo.data_ptr(), ptr(position),
            ptr(d_disp), ptr(partial), ptr(ticket), ptr(dwork),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "integrate kernel")
    central_difference.launches += 1
    central_difference.launches_by[variant] += 1
    return Update(t, disp_new, velo, dwork, position, d_disp)


central_difference.launches = 0
# launches by instantiation: "float32", "float64", "mixed"
central_difference.launches_by = {v: 0 for _, v in _ENTRIES.values()}
