"""Lowering: parsed :class:`~hakai_tpu_torch.io.model.Model` -> padded
static-shape tensors on one device.

A NumPy-only twin of ``hakai_tpu/core/lowering.py:lower`` for the subset
the port runs: no contact.  It reproduces that lowering's padding rules,
renumbering rule, lumped mass, time stepping, incidence table, material
constants, ductile (fracture) tables, BC dedup and amplitude tables, its
precision split and the node-0-centred element coordinates, so the internal
numbering and every array equal the JAX lowering's.  It builds none of the
TPU's window plans.

Precision: ``dtype="float32"``/``"float64"`` put everything in that type;
``"mixed"`` keeps the nodal kinematics (coordinates, mass, BC values,
amplitudes, initial velocity, the time step) in float64 and the element
math's inputs (material constants, volumes, hardening tables, shape
gradients, element coordinates) in float32, as the JAX lowering does.

:func:`model_from_numpy` is the one road from NumPy arrays to the port's
:class:`LoweredModel`: :func:`lower` uses it, and so do the tests to carry
a JAX ``LoweredModel`` across.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..config import SolverConfig
from ..io.model import Model
from ..ops.shape import pusai_hexa
from .renumber import renumber_model

# Mesh size at which the JAX lowering turns its window plans on; the port
# keeps the plan-time padding and renumbering rule so its shapes and node
# numbering equal the reference's.
_PLAN_TILE = 2048

# config dtype -> (nodal dtype, element dtype)
_DTYPES = {"float32": (torch.float32, torch.float32),
           "float64": (torch.float64, torch.float64),
           "mixed": (torch.float64, torch.float32)}
# float fields in the nodal dtype; every other float field takes the
# element dtype
_NODAL_FIELDS = ("coord", "diag_M", "bcd_value", "amp_time", "amp_value",
                 "velo0", "dt_t")
_INDEX_FIELDS = ("elem", "inc_idx", "mat_id", "bcd_amp", "amp_n")
_BOOL_FIELDS = ("elem_exists", "node_exists", "inc_mask", "has_plastic_e",
                "bcd_mask")


@dataclass(frozen=True)
class LoweredModel:
    """Static-shape solver inputs as tensors on one device.  Mesh axes are
    the last axes; layouts equal ``hakai_tpu.core.lowering.LoweredModel``."""
    # ---- static metadata ----
    n_node: int
    n_element: int
    N: int                          # padded node count
    E: int                          # padded element count
    dt: float
    end_time: float
    time_num: int
    mass_scaling: float
    element_min_size: float
    element_max_size: float
    cfl_dt: float
    config: SolverConfig
    fracture_enabled: bool          # a ductile table or failure stress
    pl_tables: tuple                # ((stress, strain), ...) per material
    du_tables: tuple                # ((fracture strain, triax), ...)

    # ---- mesh ----
    coord: torch.Tensor             # (3, N)
    elem: torch.Tensor              # (8, E) int32, 0-based
    elem_exists: torch.Tensor       # (E,) bool
    node_exists: torch.Tensor       # (N,) bool
    inc_idx: torch.Tensor           # (V, N) int32 into flattened (8*E) Qe
    inc_mask: torch.Tensor          # (V, N) bool
    diag_M: torch.Tensor            # (N,) lumped nodal mass (scaled)
    coord_e: torch.Tensor           # (3, 8, E) node-0-centred element coords
    pusai: torch.Tensor             # (8, 3, 8) shape gradients

    # ---- per-element material ----
    mat_id: torch.Tensor            # (E,) int32
    G_e: torch.Tensor               # (E,)
    lam_e: torch.Tensor             # (E,)
    has_plastic_e: torch.Tensor     # (E,) bool
    yield0_e: torch.Tensor          # (E,)
    # hardening tables for the element kernel, from pl_tables:
    hard_strain: torch.Tensor       # (M, W) table strains
    hard_slope: torch.Tensor        # (M, W-1) segment slopes
    hard_n: torch.Tensor            # (M,) int32 table rows

    # ---- boundary/initial conditions ----
    bcd_mask: torch.Tensor          # (3, N) bool prescribed dofs
    bcd_value: torch.Tensor         # (3, N)
    bcd_amp: torch.Tensor           # (3, N) int32 amplitude id, -1 = none
    amp_time: torch.Tensor          # (A, L)
    amp_value: torch.Tensor         # (A, L)
    amp_n: torch.Tensor             # (A,) int32 true knots
    velo0: torch.Tensor             # (3, N)
    vol_e: torch.Tensor             # (E,) initial element volume
    dt_t: torch.Tensor              # () dt in the nodal dtype

    # RCM renumbering: new internal id -> deck id (None = deck order)
    node_new2old: torch.Tensor | None = None   # (n_node,) int64
    elem_new2old: torch.Tensor | None = None   # (n_element,) int64

    @property
    def dtype(self) -> torch.dtype:
        """Nodal (kinematic) dtype: float64 in mixed mode."""
        return self.coord.dtype

    @property
    def edtype(self) -> torch.dtype:
        """Element-math dtype: float32 in mixed mode."""
        return self.G_e.dtype

    @property
    def device(self) -> torch.device:
        return self.coord.device

    def to(self, device) -> "LoweredModel":
        """A copy with every tensor on ``device``."""
        kw = {f.name: getattr(self, f.name).to(device)
              for f in dataclasses.fields(self)
              if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **kw)


def _round_up(x: int, m: int) -> int:
    return int(-(-x // m) * m)


def _hardening_tables(pl_tables):
    """(strain (M, W), slope (M, W-1), rows (M,)) from the static tables;
    slopes as ``hakai_tpu/ops/element.py:_hardening_slope_tab`` forms them."""
    M = max(len(pl_tables), 1)
    W = max(max((len(t) for t in pl_tables), default=0), 2)
    strain = np.zeros((M, W))
    slope = np.zeros((M, W - 1))
    rows = np.zeros(M, np.int32)
    for m, tab in enumerate(pl_tables):
        rows[m] = len(tab)
        for j, (_, s) in enumerate(tab):
            strain[m, j] = s
        for j in range(len(tab) - 1):
            slope[m, j] = ((tab[j + 1][0] - tab[j][0])
                           / (tab[j + 1][1] - tab[j][1]))
    return strain, slope, rows


def model_from_numpy(fields: dict, static: dict, device) -> LoweredModel:
    """Build a :class:`LoweredModel` on ``device`` from NumPy arrays.

    ``fields`` maps field names to arrays; float arrays take the nodal or
    the element dtype of ``static["config"].dtype`` (see ``_NODAL_FIELDS``).
    ``coord_e`` may be absent (the JAX lowering builds it only with window
    plans): it is then formed from ``coord`` and ``elem`` in float64 and
    cast.  ``static`` holds the metadata fields (n_node, ..., config,
    fracture_enabled, pl_tables, du_tables).  Extra keys of either are
    ignored, so a JAX ``LoweredModel``'s fields can be passed as they are,
    mixed and fracture models included."""
    cfg = static["config"]
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}: expected one of "
                         f"{sorted(_DTYPES)}")
    if static.get("contact_flag"):
        raise NotImplementedError(
            "contact is not ported yet (ROADMAP Queue 1 item 9)")
    kdt, edt = _DTYPES[cfg.dtype]
    device = torch.device(device)

    def tensor(name, a):
        a = np.ascontiguousarray(a)
        if name in _INDEX_FIELDS:
            return torch.as_tensor(a.astype(np.int32), device=device)
        if name in _BOOL_FIELDS:
            return torch.as_tensor(a.astype(bool), device=device)
        dt = kdt if name in _NODAL_FIELDS else edt
        return torch.as_tensor(a.astype(np.float64), device=device).to(dt)

    names = {f.name for f in dataclasses.fields(LoweredModel)}
    kw = {k: static[k] for k in names if k in static}
    for k in names:
        if k in fields and fields[k] is not None and k not in kw:
            kw[k] = tensor(k, fields[k])
    if fields.get("coord_e") is None:
        coord = np.asarray(fields["coord"], np.float64)
        elem = np.asarray(fields["elem"], np.int64)
        kw["coord_e"] = tensor("coord_e",
                               coord[:, elem] - coord[:, elem[0]][:, None, :])
    for k in ("node_new2old", "elem_new2old"):
        if fields.get(k) is not None:
            kw[k] = torch.as_tensor(np.asarray(fields[k], np.int64),
                                    device=device)
    # the element math always integrates at the 8 Gauss points, as
    # hakai_tpu/ops/element.py does (integ_num only enters the volumes)
    kw["pusai"] = tensor("pusai", pusai_hexa(8))
    strain, slope, rows = _hardening_tables(static["pl_tables"])
    kw["hard_strain"] = tensor("hard_strain", strain)
    kw["hard_slope"] = tensor("hard_slope", slope)
    kw["hard_n"] = torch.as_tensor(rows, device=device)
    kw["dt_t"] = tensor("dt_t", np.float64(static["dt"]))
    return LoweredModel(**kw)


def _renumbers(model: Model, cfg: SolverConfig) -> bool:
    """The JAX lowering's renumbering rule (``lower``): always with
    ``renumber="always"``; with ``"auto"`` when the mesh is large enough
    for window plans.  (The JAX lowering falls back to deck order when a
    renumbered mesh still fails its plans; plans are TPU-only, so the port
    keeps the renumbered order.)"""
    if model.n_element == 0:
        return False
    if cfg.renumber == "always":
        return True
    return (cfg.renumber == "auto" and model.n_element >= _PLAN_TILE
            and model.n_node >= _PLAN_TILE and cfg.gather_mode != "xla")


def lower_numpy(model: Model, cfg: SolverConfig) -> tuple[dict, dict]:
    """(fields, static) of the lowered model as NumPy arrays, in float64;
    follows ``hakai_tpu/core/lowering.py:_lower_impl`` line by line for the
    non-contact subset."""
    nN, nE = model.n_node, model.n_element
    node_pad, elem_pad = cfg.node_pad, cfg.elem_pad
    if cfg.gather_mode != "xla" and nE >= _PLAN_TILE and nN >= _PLAN_TILE:
        node_pad = int(np.lcm(node_pad, _PLAN_TILE))
        elem_pad = int(np.lcm(elem_pad, _PLAN_TILE))
    N = _round_up(max(nN, 1), node_pad)
    E = _round_up(max(nE, 1), elem_pad)

    coord = np.zeros((3, N))
    coord[:, :nN] = model.coordmat
    elem = np.zeros((8, E), np.int64)
    elem[:, :nE] = model.elementmat - 1
    elem_exists = np.zeros(E, bool)
    elem_exists[:nE] = True
    node_exists = np.zeros(N, bool)
    node_exists[:nN] = True

    # element volumes and lumped mass
    pusai = pusai_hexa(cfg.integ_num)
    epos = coord[:, elem[:, :nE]]                        # (3, 8, nE)
    J = np.einsum("kai,bie->kabe", pusai, epos)          # (8, 3, 3, nE)
    detJ = (J[:, 0, 0] * J[:, 1, 1] * J[:, 2, 2]
            + J[:, 0, 1] * J[:, 1, 2] * J[:, 2, 0]
            + J[:, 0, 2] * J[:, 1, 0] * J[:, 2, 1]
            - J[:, 0, 0] * J[:, 1, 2] * J[:, 2, 1]
            - J[:, 0, 1] * J[:, 1, 0] * J[:, 2, 2]
            - J[:, 0, 2] * J[:, 1, 1] * J[:, 2, 0])
    volume = detJ.sum(axis=0)

    mats = model.materials
    mat_id = np.zeros(E, np.int64)
    mat_id[:nE] = model.element_material - 1
    density = np.array([m.density for m in mats])
    density_e = density[mat_id[:nE]]
    node_mass_e = density_e * volume / 8.0
    diag_M = np.ones(N)                  # padding nodes: unit mass
    diag_M[:nN] = 0.0
    np.add.at(diag_M, elem[:, :nE].reshape(-1),
              np.broadcast_to(node_mass_e, (8, nE)).reshape(-1))
    diag_M[:nN] *= model.mass_scaling
    diag_M[nN:] = 1.0

    # element sizes and the CFL estimate
    p0 = epos[:, 0]
    sizes = np.stack([np.linalg.norm(p0 - epos[:, 1], axis=0),
                      np.linalg.norm(p0 - epos[:, 3], axis=0),
                      np.linalg.norm(p0 - epos[:, 4], axis=0)])
    dt = model.d_time * np.sqrt(model.mass_scaling)
    time_num = int(np.floor(model.end_time / dt)) if dt > 0 else 0
    G = np.array([m.G for m in mats]) if mats else np.zeros(1)
    lam = np.array([m.lam for m in mats]) if mats else np.zeros(1)
    cfl = float("inf")
    if nE:
        rho = np.maximum(density_e, 1e-300)
        c_wave = np.sqrt((lam[mat_id[:nE]] + 2.0 * G[mat_id[:nE]]) / rho)
        cfl = float((sizes.min(axis=0) / np.maximum(c_wave, 1e-300)).min()
                    * np.sqrt(model.mass_scaling))

    # assembly incidence: node -> (slot i, element e) flattened i*E+e
    counts = np.zeros(N, np.int64)
    np.add.at(counts, elem[:, :nE].reshape(-1), 1)
    V = max(int(counts.max()), 1)
    inc_idx = np.zeros((V, N), np.int64)
    inc_mask = np.zeros((V, N), bool)
    flat_nodes = elem[:, :nE].reshape(-1)
    flat_src = (np.arange(8)[:, None] * E + np.arange(nE)[None, :]).reshape(-1)
    order = np.argsort(flat_nodes, kind="stable")
    sn, ssrc = flat_nodes[order], flat_src[order]
    starts = np.concatenate([[0], np.nonzero(np.diff(sn))[0] + 1])
    grp_start = np.repeat(starts, np.diff(np.concatenate([starts, [len(sn)]])))
    slot = np.arange(len(sn)) - grp_start
    inc_idx[slot, sn] = ssrc
    inc_mask[slot, sn] = True

    # per-element material constants
    has_pl = np.array([m.plastic.shape[0] > 0 for m in mats]) \
        if mats else np.zeros(1, bool)
    y0 = np.array([m.plastic[0, 0] if m.plastic.shape[0] else 0.0
                   for m in mats]) if mats else np.zeros(1)

    # BCs: flatten and dedupe last-wins, dense (3, N) mirrors
    amp_names = [a.name for a in model.amplitudes]
    entries = {}
    for bc in model.bcs:
        amp_id = amp_names.index(bc.amp_name) if bc.amp_name in amp_names \
            else -1
        vals = bc.value if len(bc.value) == len(bc.dof) \
            else [bc.value[0]] * len(bc.dof)
        for dof, val in zip(bc.dof, vals):
            for d in dof:
                node, axis = (int(d) - 1) // 3, (int(d) - 1) % 3
                entries[(axis, node)] = (float(val), amp_id)
    bcd_mask = np.zeros((3, N), bool)
    bcd_value = np.zeros((3, N))
    bcd_amp = np.full((3, N), -1, np.int64)
    for (axis, node), (val, amp_id) in entries.items():
        bcd_mask[axis, node] = True
        bcd_value[axis, node] = val
        bcd_amp[axis, node] = amp_id

    A = max(len(model.amplitudes), 1)
    L = max(max((len(a.time) for a in model.amplitudes), default=0), 2)
    amp_time = np.zeros((A, L))
    amp_value = np.zeros((A, L))
    amp_n = np.full(A, 2, np.int64)
    for k, a in enumerate(model.amplitudes):
        la = len(a.time)
        amp_time[k, :la] = a.time
        amp_value[k, :la] = a.value
        if la:
            amp_time[k, la:] = a.time[-1] + np.arange(1, L - la + 1)
            amp_value[k, la:] = a.value[-1]
        amp_n[k] = max(la, 2)

    velo0 = np.zeros((3, N))
    for ic in model.ics:
        for dof, val in zip(ic.dof, ic.value):
            node = (np.asarray(dof) - 1) // 3
            axis = (np.asarray(dof) - 1) % 3
            velo0[axis, node] = val

    fields = dict(
        coord=coord, elem=elem, elem_exists=elem_exists,
        node_exists=node_exists, inc_idx=inc_idx, inc_mask=inc_mask,
        diag_M=diag_M, mat_id=mat_id, G_e=G[mat_id], lam_e=lam[mat_id],
        has_plastic_e=has_pl[mat_id] & elem_exists, yield0_e=y0[mat_id],
        bcd_mask=bcd_mask, bcd_value=bcd_value, bcd_amp=bcd_amp,
        amp_time=amp_time, amp_value=amp_value, amp_n=amp_n, velo0=velo0,
        vol_e=np.concatenate([volume, np.zeros(E - nE)]),
        # computed in f64 so the f32 cast carries no cancellation noise
        coord_e=coord[:, elem] - coord[:, elem[0]][:, None, :])
    static = dict(
        n_node=nN, n_element=nE, N=N, E=E, dt=float(dt),
        end_time=float(model.end_time), time_num=time_num,
        mass_scaling=float(model.mass_scaling),
        element_min_size=float(sizes.min()) if nE else 0.0,
        element_max_size=float(sizes.max()) if nE else 0.0,
        cfl_dt=cfl, config=cfg,
        # the JAX lowering's flag_fracture rule: a ductile table or a
        # failure stress (only the ductile table acts at run time)
        fracture_enabled=bool(any(m.ductile.shape[0] > 0 for m in mats)
                              or any(m.has_failure_stress for m in mats)),
        pl_tables=tuple(tuple((float(r[0]), float(r[1])) for r in m.plastic)
                        for m in mats),
        du_tables=tuple(tuple((float(r[0]), float(r[1])) for r in m.ductile)
                        for m in mats))
    return fields, static


def lower(model: Model, config: SolverConfig | None = None,
          device="cuda") -> LoweredModel:
    """Lower a parsed model onto ``device`` (default: the current GPU; pass
    ``device="cpu"`` to run the plain versions on the CPU).

    Renumbers under the JAX lowering's rule, so the internal node and
    element ids equal those of ``hakai_tpu.core.lowering.lower``.  Raises
    NotImplementedError for contact."""
    cfg = config or SolverConfig()
    if model.contact_flag != 0:
        raise NotImplementedError(
            "contact is not ported yet (ROADMAP Queue 1 item 9)")
    n2o = e2o = None
    if _renumbers(model, cfg):
        model, n2o, e2o = renumber_model(model)
    fields, static = lower_numpy(model, cfg)
    fields.update(node_new2old=n2o, elem_new2old=e2o)
    return model_from_numpy(fields, static, device)
