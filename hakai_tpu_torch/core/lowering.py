"""Lowering: parsed :class:`~hakai_tpu_torch.io.model.Model` -> padded
static-shape tensors on one device.

A NumPy-only twin of ``hakai_tpu/core/lowering.py:lower``.  It reproduces
that lowering's padding rules, renumbering rule, lumped mass, time
stepping, incidence table, material constants, ductile (fracture) tables,
BC dedup and amplitude tables, its precision split, the node-0-centred
element coordinates (on the meshes where it forms them) and the contact
pair inventories, so the internal numbering and every array equal the JAX
lowering's.  It builds none of the
TPU's window plans; in their place contact gets two flat tables (the merged
kinematics index list and a per-node force table, see
:func:`_contact_tables`).

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

# face -> local node slots, with the reference's node orders
# (get_element_face, HAKAI_j.jl:1959-1964)
_FACE_SLOTS = np.array([
    [0, 1, 2, 3],
    [4, 5, 6, 7],
    [0, 1, 5, 4],
    [1, 2, 6, 5],
    [2, 3, 7, 6],
    [3, 0, 4, 7],
])
_PAIR_INDEX = ("tri_nodes", "tri_elem", "tri_twin", "cand_nodes",
               "cand_twin", "jnode_nodes", "jnode_twin", "tri_enodes")
_PAIR_BOOL = ("tri_init", "cand_init", "jnode_init")


def _tensor_fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


@dataclass(frozen=True)
class ContactPair:
    """One directional contact pair: the candidate nodes of instance ``i``
    against the triangulated face inventory of instance ``j`` (layouts of
    ``hakai_tpu.core.lowering.ContactPairArrays`` without its TPU plans),
    plus the narrow phase's blocking."""
    i_instance: int
    j_instance: int
    is_self: bool
    young: float                    # triangle side's Young's modulus
    tri_capacity: int
    node_capacity: int
    jnode_capacity: int
    static_activity: bool           # fracture-free: the masks are all true
    # narrow-phase blocking (ops/contact.py): TB triangles x nb nodes
    tb: int
    nb: int
    tri_chunks: int
    n_chunks: int
    tri_nodes: torch.Tensor         # (3, 2F) int32 global node ids
    tri_elem: torch.Tensor          # (2F,) int32 owning element
    tri_init: torch.Tensor          # (2F,) bool initially exposed
    tri_twin: torch.Tensor          # (2F,) int32 twin element, -1 none
    cand_nodes: torch.Tensor        # (Ci,) int32
    cand_init: torch.Tensor         # (Ci,) bool
    cand_twin: torch.Tensor         # (Ci, VT) int32, -1 padded
    jnode_nodes: torch.Tensor       # (Cj,) int32 j-side surface nodes
    jnode_init: torch.Tensor        # (Cj,) bool
    jnode_twin: torch.Tensor        # (Cj, VTj) int32
    cand_mass: torch.Tensor         # (Ci,) lumped mass, element dtype
    tri_enodes: torch.Tensor | None = None   # (8, 2F) int32, self pairs

    @property
    def Tp(self) -> int:            # padded triangle count
        return self.tri_chunks * self.tb

    @property
    def Cp(self) -> int:            # padded candidate count
        return self.n_chunks * self.nb

    def to(self, device) -> "ContactPair":
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in _tensor_fields(self).items()})


@dataclass(frozen=True)
class AssemblePlan:
    """A grouped gather-and-accumulate (``hakai_tpu.ops.gather_pallas.
    plan_assemble`` without its TPU windows): ``vl`` consecutive tiles of
    ``r_tile`` entries of ``idx``/``mask`` sum into one output tile, so the
    output has ``r_pad // vl`` columns.  Built by
    :func:`hakai_tpu_torch.ops.assemble_cuda.plan_assemble`."""
    idx: torch.Tensor               # (r_pad,) int32 source columns
    mask: torch.Tensor              # (r_pad,) bool
    vl: int
    r_tile: int

    @property
    def r_pad(self) -> int:
        return self.idx.shape[0]

    def to(self, device) -> "AssemblePlan":
        return dataclasses.replace(self, idx=self.idx.to(device),
                                   mask=self.mask.to(device))


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
    # (3, 8, E) node-0-centred element coords; None where the JAX lowering
    # builds none (no window plans), and then run_chunk takes step()
    coord_e: torch.Tensor | None
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
    # ductile (fracture) tables for the erosion kernel, from du_tables:
    du_knots: torch.Tensor          # (M, K, 2) float64 rows, zero padded
    du_n: torch.Tensor              # (M,) int32 table rows

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

    # ---- contact (see _contact_tables) ----
    contact_flag: int = 0           # 0 none, 1 general, 2 self-contact
    pairs: tuple = ()               # ContactPair per directional pair
    # merged kinematics gather: kin = posvel[:, ckin_idx] feeds every pair;
    # ckin_slices[p] = ((start, stop) of tri_nodes[0], [1], [2], cand_nodes,
    # jnode_nodes) in kin
    ckin_idx: torch.Tensor | None = None       # (R,) int32
    ckin_slices: tuple = ()
    # per-node force table over the (3, fs_width) pair-force buffer:
    # entries fs_ptr[n]..fs_mid[n] add, fs_mid[n]..fs_ptr[n+1] subtract
    fs_ptr: torch.Tensor | None = None         # (N+1,) int32
    fs_mid: torch.Tensor | None = None         # (N,) int32
    fs_col: torch.Tensor | None = None         # (nnz,) int32
    fs_offsets: tuple = ()          # (force_i column, force_t column) per pair
    fs_width: int = 0
    # the same entries for kernel S (see _scatter_blocks): the nodes in
    # blocks of fs_nb, each block's entries (its range of fs_col) sorted by
    # column, one word each, column << fs_bits | place in the range; at
    # most fs_emax entries a block
    fs_sorted: torch.Tensor | None = None      # (nnz,) int32
    fs_nb: int = 0
    fs_bits: int = 0
    fs_emax: int = 0
    # a grouped assembly plan: when set, the assembly runs through
    # blocked_assemble (hakai_tpu/ops/element.py:619-621); no lowering
    # builds one, as the JAX lowering builds no plan_asm with vl > 0
    plan_asm: AssemblePlan | None = None

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
        """A copy with every tensor, the contact pairs' included, on
        ``device``."""
        kw = {k: v.to(device) for k, v in _tensor_fields(self).items()}
        return dataclasses.replace(
            self, pairs=tuple(p.to(device) for p in self.pairs),
            plan_asm=None if self.plan_asm is None
            else self.plan_asm.to(device), **kw)


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


def _ductile_tables(du_tables):
    """(knots (M, K, 2) float64, rows (M,) int32) from the static tables:
    each material's (fracture strain, triaxiality) rows as the host holds
    them, zero padded to the longest table."""
    M = max(len(du_tables), 1)
    K = max(max((len(t) for t in du_tables), default=0), 1)
    knots = np.zeros((M, K, 2))
    rows = np.zeros(M, np.int32)
    for m, tab in enumerate(du_tables):
        rows[m] = len(tab)
        if len(tab):
            knots[m, :len(tab)] = np.asarray(tab, np.float64)
    return knots, rows


def model_from_numpy(fields: dict, static: dict, device) -> LoweredModel:
    """Build a :class:`LoweredModel` on ``device`` from NumPy arrays.

    ``fields`` maps field names to arrays; float arrays take the nodal or
    the element dtype of ``static["config"].dtype`` (see ``_NODAL_FIELDS``).
    The hardening and ductile tables are formed from ``static``'s
    ``pl_tables`` and ``du_tables`` (the ductile knots stay float64, as the
    host holds them).
    ``coord_e`` is kept as given, None when absent (the JAX lowering builds
    it only with window plans; without it ``run_chunk`` takes the generic
    ``step()``, as the JAX package does).  ``static`` holds the metadata fields (n_node, ..., config,
    fracture_enabled, pl_tables, du_tables, contact_flag).
    ``fields["pairs"]`` holds one mapping per directional contact pair with
    the arrays and metadata of ``hakai_tpu.core.lowering.ContactPairArrays``;
    the blocking and the merged contact tables are formed here.  Extra keys
    of either are ignored, so a JAX ``LoweredModel``'s fields can be passed
    as they are (its pairs as mappings), mixed, fracture and contact models
    included."""
    cfg = static["config"]
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}: expected one of "
                         f"{sorted(_DTYPES)}")
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

    # the contact fields are formed below from fields["pairs"]; a grouped
    # assembly plan is carried only as the port's AssemblePlan
    names = {f.name for f in dataclasses.fields(LoweredModel)} - {
        "pairs", "ckin_slices", "fs_offsets", "fs_width", "fs_sorted",
        "fs_nb", "fs_bits", "fs_emax", "plan_asm"}
    kw = {k: static[k] for k in names if k in static}
    for k in names:
        if k in fields and fields[k] is not None and k not in kw:
            kw[k] = tensor(k, fields[k])
    kw.setdefault("coord_e", None)
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
    knots, rows = _ductile_tables(static["du_tables"])
    kw["du_knots"] = torch.as_tensor(knots, device=device)
    kw["du_n"] = torch.as_tensor(rows, device=device)
    kw["dt_t"] = tensor("dt_t", np.float64(static["dt"]))
    if isinstance(fields.get("plan_asm"), AssemblePlan):
        kw["plan_asm"] = fields["plan_asm"].to(device)
    pairs = [_pair_numpy(p, cfg.contact) for p in fields.get("pairs") or ()]
    if pairs:
        idx, slices, ptr, mid, col, offsets, width = _contact_tables(
            pairs, static["N"])
        words, nb, bits, emax = _scatter_blocks(ptr, col, width)
        kw.update(
            ckin_idx=torch.as_tensor(idx, device=device),
            ckin_slices=slices, fs_offsets=offsets, fs_width=width,
            fs_ptr=torch.as_tensor(ptr, device=device),
            fs_mid=torch.as_tensor(mid, device=device),
            fs_col=torch.as_tensor(col, device=device),
            fs_sorted=torch.as_tensor(words, device=device), fs_nb=nb,
            fs_bits=bits, fs_emax=emax,
            pairs=tuple(_pair_tensors(p, edt, device) for p in pairs))
    return LoweredModel(**kw)


def _pair_numpy(p, cc) -> dict:
    """A contact pair mapping with NumPy arrays and the narrow phase's
    blocking (``hakai_tpu/ops/contact.py:_pair_force``)."""
    names = {f.name for f in dataclasses.fields(ContactPair)}
    out = {k: (np.asarray(v) if hasattr(v, "shape") else v)
           for k, v in dict(p).items() if k in names}
    F2 = out["tri_nodes"].shape[1]
    Ci = out["cand_nodes"].shape[0]
    tb = min(cc.tri_block_self if out["is_self"] else cc.tri_block, F2)
    nbc = cc.node_block_self if out["is_self"] else cc.node_block
    nb = max(min(nbc, Ci, (1 << 21) // max(tb, 1)), 8)
    out.update(tb=tb, nb=nb, tri_chunks=-(-F2 // max(tb, 1)),
               n_chunks=-(-Ci // nb))
    if not out["is_self"]:
        out["tri_enodes"] = None
    return out


def _pair_tensors(p: dict, edt, device) -> ContactPair:
    """The pair's arrays as C-contiguous tensors (the kernels index them
    densely; fancy indexing leaves ``tri_enodes`` in column order)."""
    kw = {}
    for k, v in p.items():
        if k in _PAIR_INDEX and v is not None:
            v = torch.as_tensor(np.ascontiguousarray(v, np.int32),
                                device=device)
        elif k in _PAIR_BOOL:
            v = torch.as_tensor(np.ascontiguousarray(v, bool), device=device)
        elif k == "cand_mass":
            v = torch.as_tensor(np.ascontiguousarray(v, np.float64),
                                device=device).to(edt)
        kw[k] = v
    return ContactPair(**kw)


def _contact_tables(pairs, N: int):
    """The two flat tables that replace the JAX lowering's contact gather
    plans (``plan_ckin`` and the scatter-as-gather plans ``plan_fgi`` /
    ``plan_fgt`` / ``plan_fx``):

    - the merged kinematics index list: per pair, in pair order,
      ``tri_nodes[0]``, ``tri_nodes[1]``, ``tri_nodes[2]``, ``cand_nodes``
      and ``jnode_nodes`` concatenated, with each segment's (start, stop);
    - the per-node force table over a (3, width) buffer that holds, per
      pair, ``force_i`` (Cp columns) then ``force_t`` (Tp columns): node n
      adds the columns ``col[ptr[n]:mid[n]]`` (its candidate slots, pair
      order) and subtracts ``col[mid[n]:ptr[n+1]]`` (the triangles it is a
      vertex of, in (pair, vertex, triangle) order).

    Returns (idx, slices, ptr, mid, col, offsets, width)."""
    segs, slices, off = [], [], 0
    plus_n, plus_c, minus_n, minus_c, offsets, width = [], [], [], [], [], 0
    for p in pairs:
        tn = p["tri_nodes"].astype(np.int64)
        sl = []
        for s in (tn[0], tn[1], tn[2], p["cand_nodes"], p["jnode_nodes"]):
            segs.append(np.asarray(s, np.int64))
            sl.append((off, off + len(s)))
            off += len(s)
        slices.append(tuple(sl))
        Cp, Tp = p["n_chunks"] * p["nb"], p["tri_chunks"] * p["tb"]
        off_i, off_t = width, width + Cp
        offsets.append((off_i, off_t))
        width += Cp + Tp
        Ci, F2 = len(p["cand_nodes"]), tn.shape[1]
        plus_n.append(np.asarray(p["cand_nodes"], np.int64))
        plus_c.append(off_i + np.arange(Ci))
        minus_n.append(tn.reshape(-1))
        minus_c.append(np.tile(off_t + np.arange(F2), 3))
    nodes = np.concatenate(plus_n + minus_n)
    cols = np.concatenate(plus_c + minus_c)
    n_plus = sum(len(x) for x in plus_n)
    minus = np.arange(len(nodes)) >= n_plus
    order = np.lexsort((np.arange(len(nodes)), minus, nodes))
    ptr = np.zeros(N + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(nodes, minlength=N))
    mid = ptr[:-1] + np.bincount(nodes[~minus], minlength=N)
    return (np.concatenate(segs).astype(np.int32), tuple(slices),
            ptr.astype(np.int32), mid.astype(np.int32),
            cols[order].astype(np.int32), tuple(offsets), width)


# kernel S's blocks: nodes a block at most, and the entries a block may
# hold in shared memory (three float64 values each)
SCATTER_NB = 32
SCATTER_EMAX = 8192


def _scatter_blocks(ptr, col, width: int):
    """Kernel S's copy of the force table: the nodes in blocks of ``nb``
    (consecutive node ids), each block's entries (its range of ``col``)
    sorted by column, stably, each one word ``column << bits | place``
    (place: its position in the block's range), so that neighbouring
    threads gather neighbouring columns and each value still lands at its
    place in table order.  ``nb`` is SCATTER_NB, halved until a block's
    entries fit SCATTER_EMAX and their places and the columns fit one
    32-bit word.  Returns (words as int32, nb, bits, most entries a
    block)."""
    ptr = np.asarray(ptr, np.int64)
    col = np.asarray(col, np.int64)
    N, col_bits = len(ptr) - 1, max(int(width - 1).bit_length(), 1)
    nb = SCATTER_NB
    while True:
        starts = ptr[np.minimum(np.arange(0, N + nb, nb), N)]
        emax = int((starts[1:] - starts[:-1]).max()) if N else 0
        bits = max(int(emax - 1).bit_length(), 1)
        if (emax <= SCATTER_EMAX and bits + col_bits <= 32) or nb == 1:
            break
        nb //= 2
    if emax > SCATTER_EMAX or bits + col_bits > 32:
        raise ValueError(f"a node's {emax} force-table entries over {width} "
                         "columns exceed kernel S's block")
    block = np.repeat(np.arange(N) // nb, np.diff(ptr))
    place = np.arange(len(col)) - ptr[block * nb]
    order = np.lexsort((place, col, block))
    words = (col[order].astype(np.uint64) << np.uint64(bits)) \
        | place[order].astype(np.uint64)
    return words.astype(np.uint32).view(np.int32), nb, bits, emax


def uses_plans(model: Model, cfg: SolverConfig) -> bool:
    """The JAX lowering's window-plan rule (``use_plans``): a mesh of at
    least 2,048 elements and 2,048 nodes, unless ``gather_mode="xla"``.
    The port builds no plans, but keeps the rule's padding and its
    node-0-centred ``coord_e``, and with them the JAX package's choice of
    chunk loop."""
    return (cfg.gather_mode != "xla" and model.n_element >= _PLAN_TILE
            and model.n_node >= _PLAN_TILE)


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
    return cfg.renumber == "auto" and uses_plans(model, cfg)


def lower_numpy(model: Model, cfg: SolverConfig) -> tuple[dict, dict]:
    """(fields, static) of the lowered model as NumPy arrays, in float64
    (contact pairs as mappings, see :func:`_lower_contact`); follows
    ``hakai_tpu/core/lowering.py:_lower_impl`` line by line."""
    nN, nE = model.n_node, model.n_element
    node_pad, elem_pad = cfg.node_pad, cfg.elem_pad
    plans = uses_plans(model, cfg)
    if plans:
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
        coord_e=(coord[:, elem] - coord[:, elem[0]][:, None, :]
                 if plans else None))
    # the JAX lowering's flag_fracture rule: a ductile table or a failure
    # stress (only the ductile table acts at run time)
    fracture = bool(any(m.ductile.shape[0] > 0 for m in mats)
                    or any(m.has_failure_stress for m in mats))
    fields["pairs"] = _lower_contact(
        model, cfg, elem, diag_M,
        static_activity=not fracture and cfg.contact.static_cull)
    static = dict(
        n_node=nN, n_element=nE, N=N, E=E, dt=float(dt),
        end_time=float(model.end_time), time_num=time_num,
        mass_scaling=float(model.mass_scaling),
        element_min_size=float(sizes.min()) if nE else 0.0,
        element_max_size=float(sizes.max()) if nE else 0.0,
        cfl_dt=cfl, config=cfg, fracture_enabled=fracture,
        contact_flag=int(model.contact_flag),
        pl_tables=tuple(tuple((float(r[0]), float(r[1])) for r in m.plastic)
                        for m in mats),
        du_tables=tuple(tuple((float(r[0]), float(r[1])) for r in m.ductile)
                        for m in mats))
    return fields, static


def _instance_faces(model: Model, inst_idx: int):
    """All 6*Ej faces of an instance with the reference's node orders and
    outward orientation (get_element_face, HAKAI_j.jl:1946-1992).

    Returns (faces (F,4) part-local 1-based, face_elem (F,) part-local
    1-based, exterior (F,) bool, twin_elem (F,) part-local 1-based or 0)."""
    inst = model.instances[inst_idx]
    part = model.parts[inst.part_id - 1]
    cd = part.coordmat            # (3, n) part coords (pre-transform, as ref)
    el = part.elementmat.T        # (Ej, 8) 1-based
    nE = part.n_element

    faces = el[:, _FACE_SLOTS].reshape(nE * 6, 4)
    face_elem = np.repeat(np.arange(1, nE + 1), 6)

    # outward orientation fix
    p = cd[:, faces - 1]                           # (3, F, 4)
    ctr = np.repeat(cd[:, el - 1].mean(axis=2), 6, axis=1)     # (3, F)
    v1 = p[:, :, 1] - p[:, :, 0]
    v2 = p[:, :, 3] - p[:, :, 0]
    nv = np.cross(v1.T, v2.T).T                    # (3, F)
    vc = ctr - p[:, :, 0]
    flip = (nv * vc).sum(axis=0) > 0.0
    faces[flip] = faces[flip][:, [0, 3, 2, 1]]

    # dedup by sorted key
    keys = np.sort(faces, axis=1)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    inv = inv.reshape(-1)
    exterior = counts[inv] == 1

    twin_elem = np.zeros(nE * 6, np.int64)
    order = np.argsort(inv, kind="stable")
    so = order[counts[inv][order] == 2]            # pairs adjacent in `so`
    a, b = so[0::2], so[1::2]
    twin_elem[a] = face_elem[b]
    twin_elem[b] = face_elem[a]
    return faces, face_elem, exterior, twin_elem


def _initial_rows(face_elem, exterior, elements):
    """Initially exposed faces of the contact set.  The reference's
    surface dedup loop runs j = 1:nE*6-1 (HAKAI_j.jl:2045), so the
    instance's very last face is never a surface candidate."""
    init = exterior & np.isin(face_elem, elements)
    if len(init):
        init[-1] = False
    return init


def _cand_nodes(model: Model, inst_idx: int, elements, face_cache: dict,
                reexposure: bool = True):
    """Candidate surface nodes of an instance for one contact side
    (``hakai_tpu/core/lowering.py:_cand_nodes``, vectorised): nodes of the
    initially exposed faces, plus the nodes of the internal faces that a
    deletion can expose (add_surface_triangle, HAKAI_j.jl:2167-2245).  A
    node is active iff it was initially, or any owner of an internal face
    holding it has died.  Returns (cand (C,), cand_init (C,), cand_twin (C,
    VT)) with global ids, each row of cand_twin the node's owners sorted
    ascending and -1 padded.

    ``reexposure=False`` reproduces the reference's self-pair gap: only
    ``c_nodes_i`` is ever appended to (HAKAI_j.jl:779/789), so the j side
    of a self pair stays at its initial nodes."""
    faces, face_elem, exterior, twin = face_cache[inst_idx]
    inst = model.instances[inst_idx]
    init_rows = _initial_rows(face_elem, exterior, elements)
    gn = faces - 1 + inst.node_offset
    internal = (twin > 0) if reexposure else np.zeros(len(twin), bool)
    cand = np.unique(gn[init_rows | internal])
    cand_init = np.isin(cand, np.unique(gn[init_rows])) if init_rows.any() \
        else np.zeros(len(cand), bool)
    rows = np.nonzero(internal)[0]
    owner = np.stack([face_elem[rows] - 1, twin[rows] - 1], axis=1) \
        + inst.element_offset                      # (R, 2) global
    node = np.repeat(gn[rows][:, :, None], 2, axis=2).ravel()
    elem = np.repeat(owner[:, None, :], 4, axis=1).ravel()
    key = np.unique(node * (model.n_element + 1) + elem)
    node, elem = key // (model.n_element + 1), key % (model.n_element + 1)
    start = np.searchsorted(node, node, side="left")
    rank = np.arange(len(node)) - start
    vt = int(rank.max()) + 1 if len(node) else 1
    cand_twin = np.full((len(cand), vt), -1, np.int64)
    cand_twin[np.searchsorted(cand, node), rank] = elem
    return cand, cand_init, cand_twin


def _pair_arrays(model: Model, cfg: SolverConfig, i_inst: int, j_inst: int,
                 elements_i, elements_j, face_cache: dict, elem_np,
                 diag_M_np, static_activity: bool) -> dict:
    """One directional contact pair (global 0-based ids) as a mapping of
    ``ContactPairArrays``' fields (``hakai_tpu/core/lowering.py:
    _pair_arrays`` without the gather plans)."""
    for k in (i_inst, j_inst):
        if k not in face_cache:
            face_cache[k] = _instance_faces(model, k)
    inst_j = model.instances[j_inst]

    # triangle (j) side
    faces, face_elem, exterior, twin = face_cache[j_inst]
    init = _initial_rows(face_elem, exterior, elements_j)
    g_nodes = faces - 1 + inst_j.node_offset
    g_elem = face_elem - 1 + inst_j.element_offset
    g_twin = np.where(twin > 0, twin - 1 + inst_j.element_offset, -1)
    if i_inst == j_inst:
        # self pairs never receive re-exposed triangles: the reference's
        # surface repair updates only c_nodes_i for them (HAKAI_j.jl:789)
        g_twin = np.full_like(g_twin, -1)
    # two triangles per face: (1,2,3) and (3,4,1) (HAKAI_j.jl:2140-2145)
    tri_nodes = np.stack([g_nodes[:, [0, 1, 2]], g_nodes[:, [2, 3, 0]]],
                         axis=1).reshape(-1, 3).T                  # (3, 2F)
    tri_elem = np.repeat(g_elem, 2)
    tri_init = np.repeat(init, 2)
    tri_twin = np.repeat(g_twin, 2)
    if static_activity:
        # fracture-free deck: the flags never change, so only the initially
        # exposed inventory can ever be active
        keep = tri_init
        tri_nodes, tri_elem = tri_nodes[:, keep], tri_elem[keep]
        tri_twin = np.full(tri_elem.shape[0], -1, tri_twin.dtype)
        tri_init = np.ones(tri_elem.shape[0], bool)
    else:
        # initially active faces first inside each 2048-wide segment (the
        # JAX plan tile): a triangle's segment, and so which triangles
        # share a narrow-phase block, is kept; erosion-exposed twins land
        # in each segment's tail blocks
        n = tri_init.shape[0]
        perm = np.lexsort((np.arange(n), ~tri_init, np.arange(n) // 2048))
        tri_nodes, tri_elem = tri_nodes[:, perm], tri_elem[perm]
        tri_init, tri_twin = tri_init[perm], tri_twin[perm]

    cand, cand_init, cand_twin = _cand_nodes(model, i_inst, elements_i,
                                             face_cache)
    jc, jc_init, jc_twin = _cand_nodes(model, j_inst, elements_j, face_cache,
                                       reexposure=(i_inst != j_inst))
    if static_activity:
        cand, jc = cand[cand_init], jc[jc_init]
        cand_init, jc_init = np.ones(len(cand), bool), np.ones(len(jc), bool)
        cand_twin = np.full((len(cand), 1), -1, np.int64)
        jc_twin = np.full((len(jc), 1), -1, np.int64)

    cc = cfg.contact
    return dict(
        i_instance=i_inst, j_instance=j_inst, is_self=(i_inst == j_inst),
        young=float(model.materials[inst_j.material_id - 1].young),
        tri_capacity=cc.tri_capacity or min(
            tri_nodes.shape[1],
            _round_up(max(int(2.5 * int(tri_init.sum())), 16), 8)),
        node_capacity=cc.node_capacity or min(
            len(cand), _round_up(max(int(1.8 * cand_init.sum()), 16), 8)),
        jnode_capacity=cc.node_capacity or min(
            len(jc), _round_up(max(int(1.8 * jc_init.sum()), 16), 8)),
        static_activity=static_activity,
        tri_nodes=tri_nodes, tri_elem=tri_elem, tri_init=tri_init,
        tri_twin=tri_twin, cand_nodes=cand, cand_init=cand_init,
        cand_twin=cand_twin, jnode_nodes=jc, jnode_init=jc_init,
        jnode_twin=jc_twin,
        tri_enodes=elem_np[:, tri_elem] if i_inst == j_inst else None,
        cand_mass=diag_M_np[cand])


def _lower_contact(model: Model, cfg: SolverConfig, elem_np, diag_M_np,
                   static_activity: bool) -> list:
    """The directional pair list (HAKAI_j.jl:243-402): all exterior faces
    of every instance pair (with ``contact_flag == 2`` also each instance
    against itself), or the ``*Contact Pair`` sets; each instance pair
    gives the two directions."""
    if model.contact_flag < 1:
        return []
    insts = model.instances
    ni = len(insts)
    cps = []   # (i1, i2, elements_1, elements_2), 1-based part-local elsets
    if len(model.cps) == 0:
        if ni > 1:
            for i in range(ni):
                for j in range(i if model.contact_flag == 2 else i + 1, ni):
                    cps.append((i, j, np.arange(1, insts[i].n_element + 1),
                                np.arange(1, insts[j].n_element + 1)))
        else:
            els = np.arange(1, insts[0].n_element + 1)
            cps.append((0, 0, els, els))
    else:
        for cp in model.cps:
            cps.append((cp.instance_id_1 - 1, cp.instance_id_2 - 1,
                        np.asarray(cp.elements_1), np.asarray(cp.elements_2)))
    face_cache: dict = {}
    pairs = []
    for (i1, i2, els1, els2) in cps:
        dirs = [(i1, i2, els1, els2)]
        if i1 != i2:
            dirs.append((i2, i1, els2, els1))
        for (ii, jj, ei, ej) in dirs:
            pairs.append(_pair_arrays(model, cfg, ii, jj, ei, ej, face_cache,
                                      elem_np, diag_M_np, static_activity))
    return pairs


def lower(model: Model, config: SolverConfig | None = None,
          device="cuda") -> LoweredModel:
    """Lower a parsed model onto ``device`` (default: the current GPU; pass
    ``device="cpu"`` to run the plain versions on the CPU).

    Renumbers under the JAX lowering's rule, so the internal node and
    element ids equal those of ``hakai_tpu.core.lowering.lower``."""
    cfg = config or SolverConfig()
    n2o = e2o = None
    if _renumbers(model, cfg):
        model, n2o, e2o = renumber_model(model)
    fields, static = lower_numpy(model, cfg)
    fields.update(node_new2old=n2o, elem_new2old=e2o)
    return model_from_numpy(fields, static, device)
