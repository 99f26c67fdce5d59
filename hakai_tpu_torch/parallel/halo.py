"""Node-sharded halo-exchange runs over ``torch.distributed`` (the
counterpart of ``hakai_tpu/parallel/halo.py``; JAX's names are kept, so
each function finds its twin there).

Nodes are owned by ranks in contiguous ranges of No rows; each element
lives on the rank that owns its first node (padding elements on none).
A rank steps a window of W = No + 2H node rows, its own plus H ghost rows
on either side, where H, checked at :func:`partition`, bounds how far any
of its elements reaches past its own rows.  Per step a rank:

- runs the central difference on its own rows (``_integrate`` of
  ``solver/explicit.py`` on the rank's node view; on contact decks the
  compact contact-node block is all-gathered and the narrow phase dealt
  out over the ranks, as on element-sharded runs);
- receives its neighbours' boundary rows (:meth:`HaloComm.
  exchange_window`), runs the element kernel on its window (the packed
  entry when the partition keeps ``coord_e``, else the unpacked one), and
  assembles with kernel B on a window-local incidence table, which takes
  the place of the TPU's window plans;
- sends the ghost rows' forces back to their owners
  (:meth:`HaloComm.return_ghosts`), which add them after their own sum.

Each exchange is the JAX package's ring of two ``ppermute``s: a rank sends
H rows to each neighbour and receives H rows from each (one batch of
point-to-point sends and receives), into buffers it keeps; the ends of
the ring get zeros, as JAX masks its wrap.  A rank's exchange traffic does
not grow with the rank count.  Under gloo, whose sends take host memory,
a rank on the card stages its rows through pinned host buffers.  Under
NCCL a rank's chunk, exchanges and all-gathers included, replays captured
CUDA graphs, as JAX's ``make_halo_step`` is one ``jit`` program per
device; gloo ranks and the CPU step eagerly.  A rank keeps one shard, where
the JAX package keeps a leading ``dp`` axis: :class:`HaloModel` and
:class:`HaloState` hold either every shard, shard-major on the host (as
:func:`partition`, :func:`partition_state` and the checkpoint files have
them), or one rank's row (:meth:`HaloModel.shard`).

A halo Q is not kernel B's single-device sum: the ghost rows' parts add
after the owned part.  Halo runs agree with one device to roundoff, as the
JAX package's do (tests/test_halo.py's tolerances), not bit for bit.

A run of several processes (``parallel.dist.initialize``) partitions the
deck in every process, checks at the launch that all built the same
partition, and gives each process's ranks the rows of that process; its
checkpoints are one file a process plus a manifest, each process writing
and reading only its own rows (the JAX package's multi-process format).
Its steps are the one-process run's, bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..core.lowering import LoweredModel
from ..core.state import SimState
from ..ops.assemble_cuda import assemble_internal_force
from ..ops.contact import contact_forces_pv
from ..ops.element_cuda import element_update, packed_element_step
from ..ops.erosion import erode
from ..solver.output import NodeData
from .dist import (Rank, check_same, launch, local_ranks, process_count,
                   process_index)
from .sharding import ShardComm

# the partition's tile (the JAX package's gather-plan tile, _PLAN_TILE)
_TILE = 2048
# fields kept whole on every rank (index maps over every shard)
_REPL_FIELDS = ("cn_inv", "eg_inv")


def _round_up(x: int, m: int) -> int:
    return int(-(-x // m) * m)


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


@dataclass(frozen=True)
class HaloModel:
    """Shard-major lowered arrays of a halo run: every tensor leads with
    the shard axis S, or is one rank's row (:meth:`shard`).  ``base`` is
    the whole model."""
    n_shards: int
    No: int                          # owned node rows per shard
    H: int                           # halo rows on each side
    El: int                          # element slots per shard
    base: LoweredModel
    elem_w: torch.Tensor             # (S, 8, El) int32 window-local node ids
    elem_gid: torch.Tensor           # (S, El) int32 global element id, -1 pad
    elem_alive0: torch.Tensor        # (S, El) bool
    mat_id: torch.Tensor             # (S, El) int32
    G_e: torch.Tensor                # (S, El) element dtype
    lam_e: torch.Tensor
    has_plastic_e: torch.Tensor      # (S, El) bool
    yield0_e: torch.Tensor
    vol_e: torch.Tensor
    diag_M: torch.Tensor             # (S, No) nodal dtype
    coord: torch.Tensor              # (S, 3, No)
    node_exists: torch.Tensor        # (S, No) bool
    bc_mask: torch.Tensor            # (S, 3, No) bool prescribed dofs
    bc_value: torch.Tensor           # (S, 3, No)
    bc_amp: torch.Tensor             # (S, 3, No) int32 amplitude id, -1 none
    velo0: torch.Tensor              # (S, 3, No)
    # window-local incidence table for kernel B (the TPU's window plans'
    # place): window node -> (slot i, element e) as i*El+e, real elements
    # only; V_w the most entries of a node over every shard
    inc_idx: torch.Tensor            # (S, V_w, W) int32
    inc_mask: torch.Tensor           # (S, V_w, W) bool
    coord_e: torch.Tensor | None = None     # (S, 3, 8, El): the packed loop
    # contact: compact exchange of the contact-relevant node rows
    cn_local: torch.Tensor | None = None    # (S, Ncs) int32 owned-row id
    cn_mask: torch.Tensor | None = None     # (S, Ncs) bool
    cn_inv: torch.Tensor | None = None      # (N,) int32 -> slot in S*Ncs (+pad)
    eg_inv: torch.Tensor | None = None      # (E,) int32 -> slot in S*El (+pad)

    @property
    def W(self) -> int:
        return self.No + 2 * self.H

    def to(self, device) -> "HaloModel":
        return dataclasses.replace(
            self, base=self.base.to(device),
            **{f.name: _to(getattr(self, f.name), device)
               for f in dataclasses.fields(self) if f.name != "base"})

    def shard(self, d: int) -> "HaloModel":
        """Rank ``d``'s row of every shard-major field (the JAX package's
        ``_unlead``); the replicated index maps stay whole."""
        kw = {f.name: getattr(self, f.name)[d]
              for f in dataclasses.fields(self)
              if isinstance(getattr(self, f.name), torch.Tensor)
              and f.name not in _REPL_FIELDS}
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class HaloState:
    """The halo run's state: shard-major (S, ...) fields, or one rank's
    row.  ``work`` holds per-shard partial [W_ext, W_int] sums over owned
    rows (disjoint, so the whole run's pair is their sum)."""
    t: torch.Tensor              # () int32
    disp: torch.Tensor           # (S, 3, No)
    disp_pre: torch.Tensor
    velo: torch.Tensor
    Q: torch.Tensor
    stress: torch.Tensor         # (S, 6, 8, El)
    strain: torch.Tensor         # (S, 6, El)
    eq_ps: torch.Tensor          # (S, 8, El)
    yield_s: torch.Tensor
    triax: torch.Tensor
    element_flag: torch.Tensor   # (S, El) bool
    work: torch.Tensor           # (S, 2)

    def replace(self, **kw) -> "HaloState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "HaloState":
        return HaloState(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    def shard(self, d) -> "HaloState":
        """Row ``d`` of every shard-major field (a slice of rows for a
        slice ``d``); ``t`` whole."""
        return HaloState(t=self.t, **{f.name: getattr(self, f.name)[d]
                                      for f in dataclasses.fields(self)
                                      if f.name != "t"})


def _window_incidence(elem_w, alive0, El: int, W: int):
    """Per shard, the window incidence table of its real elements in the
    order of ``core/lowering.py:lower_numpy``'s (slot-major, then element):
    (idx (S, V, W), mask (S, V, W)).  Padding elements point at window slot
    0 and stay out of the table."""
    tables = []
    for ew, al in zip(elem_w, alive0):
        pos = np.nonzero(al)[0]
        nodes = ew[:, pos].reshape(-1)
        src = (np.arange(8)[:, None] * El + pos[None, :]).reshape(-1)
        order = np.argsort(nodes, kind="stable")
        sn, ssrc = nodes[order], src[order]
        starts = np.concatenate([[0], np.nonzero(np.diff(sn))[0] + 1]) \
            if len(sn) else np.zeros(0, np.int64)
        slot = np.arange(len(sn)) - np.repeat(
            starts, np.diff(np.concatenate([starts, [len(sn)]])))
        tables.append((sn, ssrc, slot))
    V = max([int(t[2].max()) + 1 for t in tables if len(t[2])] + [1])
    idx = np.zeros((len(tables), V, W), np.int64)
    mask = np.zeros((len(tables), V, W), bool)
    for d, (sn, ssrc, slot) in enumerate(tables):
        idx[d, slot, sn] = ssrc
        mask[d, slot, sn] = True
    return idx, mask


def partition(model: LoweredModel, n_shards: int) -> HaloModel:
    """NumPy partition of a lowered model into shard-major halo arrays, on
    the CPU, with the JAX package's geometry (``partition``,
    halo.py:125-345): contiguous node ownership, each real element on the
    shard of its first node, H the largest overshoot of a shard's elements
    past its rows.  Where the model keeps ``coord_e`` (the JAX lowering's
    window plans) and a shard holds at least 1,024 element slots, El is
    rounded up to 2,048 and H widened so that W is a multiple of 2,048, as
    the JAX package's window plans need; the rank then takes the packed
    loop.  ``coord_e`` of each shard is the model's own columns.  Raises
    ValueError where N does not divide or H exceeds No."""
    N, E = model.N, model.E
    if N % n_shards:
        raise ValueError(f"padded node count {N} not divisible by {n_shards}")
    No = N // n_shards
    elem = model.elem.cpu().numpy().astype(np.int64)          # (8, E)
    exists = model.elem_exists.cpu().numpy()

    owner = np.clip(elem.min(axis=0) // No, 0, n_shards - 1)
    owner = np.where(exists, owner, -1)       # padding: on no shard
    shard_elems = [np.nonzero(owner == d)[0] for d in range(n_shards)]
    El = max([len(ids) for ids in shard_elems] + [0])
    El = max(-(-El // 8) * 8, 8)

    H = 0
    for d, ids in enumerate(shard_elems):
        ids_r = ids[exists[ids]]
        if len(ids_r) == 0:
            continue
        sub = elem[:, ids_r]
        lo, hi = d * No, (d + 1) * No
        H = max(H, int(max(lo - sub.min(), 0)),
                int(max(sub.max() - (hi - 1), 0)))
    if H > No:
        raise ValueError(f"halo width {H} exceeds shard size {No}: "
                         "mesh ordering too scattered for halo decomposition")
    H = max(H, 1)

    use_plans = (model.coord_e is not None and El >= _TILE // 2
                 and model.config.gather_mode != "xla")
    if use_plans:
        El = _round_up(El, _TILE)
        rem = (No + 2 * H) % _TILE
        H2 = H + (_TILE - rem) // 2 if rem else H
        if H2 > No:
            use_plans = False       # window padding would pass shard size
        else:
            H = H2

    S, W = n_shards, No + 2 * H
    elem_w = np.zeros((S, 8, El), np.int64)
    elem_gid = np.full((S, El), -1, np.int64)
    alive0 = np.zeros((S, El), bool)
    efields = {k: getattr(model, k).cpu().double().numpy()
               if getattr(model, k).dtype.is_floating_point
               else getattr(model, k).cpu().numpy()
               for k in ("mat_id", "G_e", "lam_e", "has_plastic_e",
                         "yield0_e", "vol_e")}
    per = {k: np.zeros((S, El), v.dtype) for k, v in efields.items()}
    for d, ids in enumerate(shard_elems):
        k = len(ids)
        if k == 0:
            continue
        ew = elem[:, ids] - (d * No - H)
        elem_w[d, :, :k] = np.where(exists[ids][None, :], ew, 0)
        elem_gid[d, :k] = ids
        alive0[d, :k] = exists[ids]
        for name, v in efields.items():
            per[name][d, :k] = v[ids]

    def shard_nodes(t):             # (..., N) -> (S, ..., No)
        return t.cpu().reshape(t.shape[:-1] + (S, No)).movedim(-2, 0) \
            .contiguous()

    inc_idx, inc_mask = _window_incidence(elem_w, alive0, El, W)
    edt = model.edtype

    def etensor(a):
        return torch.as_tensor(a).to(edt)

    coord_e = None
    if use_plans:
        ce = model.coord_e.cpu()
        coord_e = torch.zeros((S, 3, 8, El), dtype=ce.dtype)
        for d, ids in enumerate(shard_elems):
            coord_e[d, :, :, :len(ids)] = ce[:, :, torch.as_tensor(ids)]

    contact = {}
    if model.pairs:
        parts = []
        for p in model.pairs:
            parts.append(p.tri_nodes.cpu().numpy().reshape(-1))
            parts.append(p.cand_nodes.cpu().numpy())
            parts.append(p.jnode_nodes.cpu().numpy())
        cnodes = np.unique(np.concatenate(parts))
        cnodes = cnodes[(cnodes >= 0) & (cnodes < N)]
        per_shard = [cnodes[(cnodes >= d * No) & (cnodes < (d + 1) * No)]
                     for d in range(S)]
        Ncs = max(_round_up(max(len(o) for o in per_shard), 8), 8)
        cn_local = np.zeros((S, Ncs), np.int64)
        cn_mask = np.zeros((S, Ncs), bool)
        cn_inv = np.full(N, S * Ncs, np.int64)      # pad slot -> zero column
        for d, own in enumerate(per_shard):
            cn_local[d, :len(own)] = own - d * No
            cn_mask[d, :len(own)] = True
            cn_inv[own] = d * Ncs + np.arange(len(own))
        eg_inv = np.full(E, S * El, np.int64)
        for d in range(S):
            real = elem_gid[d] >= 0
            eg_inv[elem_gid[d][real]] = d * El + np.nonzero(real)[0]
        contact = dict(
            cn_local=torch.as_tensor(cn_local, dtype=torch.int32),
            cn_mask=torch.as_tensor(cn_mask),
            cn_inv=torch.as_tensor(cn_inv, dtype=torch.int32),
            eg_inv=torch.as_tensor(eg_inv, dtype=torch.int32))

    i32 = torch.int32
    return HaloModel(
        n_shards=S, No=No, H=int(H), El=El, base=model,
        elem_w=torch.as_tensor(elem_w, dtype=i32),
        elem_gid=torch.as_tensor(elem_gid, dtype=i32),
        elem_alive0=torch.as_tensor(alive0),
        mat_id=torch.as_tensor(per["mat_id"], dtype=i32),
        G_e=etensor(per["G_e"]), lam_e=etensor(per["lam_e"]),
        has_plastic_e=torch.as_tensor(per["has_plastic_e"]),
        yield0_e=etensor(per["yield0_e"]), vol_e=etensor(per["vol_e"]),
        diag_M=shard_nodes(model.diag_M), coord=shard_nodes(model.coord),
        node_exists=shard_nodes(model.node_exists),
        bc_mask=shard_nodes(model.bcd_mask),
        bc_value=shard_nodes(model.bcd_value),
        bc_amp=shard_nodes(model.bcd_amp),
        velo0=shard_nodes(model.velo0),
        inc_idx=torch.as_tensor(inc_idx, dtype=i32),
        inc_mask=torch.as_tensor(inc_mask), coord_e=coord_e, **contact)


def exchange_bytes(hm: HaloModel, rank: int) -> int:
    """Bytes rank ``rank`` sends, and as many it receives, on the exchanges
    of one step: H rows to each of its neighbours (one at either end of
    the ring) of the window (3 channels in the packed loop, position and
    increment in the generic step) and of the ghost forces (3)."""
    C = 3 if hm.coord_e is not None else 6
    neighbours = (rank > 0) + (rank < hm.n_shards - 1)
    return (C + 3) * neighbours * hm.H * hm.base.dtype.itemsize


def init_halo_state(hm: HaloModel) -> HaloState:
    """The initial state of ``hm``'s shards (shard-major, or one rank's row
    for a rank's view), on ``hm``'s device."""
    dt, edt = hm.base.dtype, hm.base.edtype
    lead = tuple(hm.diag_M.shape[:-1])
    No, El, dev = hm.No, hm.El, hm.diag_M.device

    def zeros(t, *shape):
        return torch.zeros(lead + shape, dtype=t, device=dev)

    return HaloState(
        t=torch.zeros((), dtype=torch.int32, device=dev),
        disp=zeros(dt, 3, No), disp_pre=-hm.velo0 * float(hm.base.dt_t),
        velo=hm.velo0.clone(), Q=zeros(dt, 3, No),
        stress=zeros(edt, 6, 8, El), strain=zeros(edt, 6, El),
        eq_ps=zeros(edt, 8, El),
        yield_s=hm.yield0_e.unsqueeze(-2).expand(lead + (8, El)).to(edt)
        .clone(),
        triax=zeros(edt, 8, El), element_flag=hm.elem_alive0.clone(),
        work=zeros(dt, 2))


def _flat_gid(hm: HaloModel, device):
    """(indices into the flat (S*El) slots of real elements, their global
    element ids), on ``device``."""
    gid = hm.elem_gid.reshape(-1).long().to(device)
    slots = torch.nonzero(gid >= 0).reshape(-1)
    return slots, gid[slots]


def partition_state(hm: HaloModel, state: SimState) -> HaloState:
    """A whole :class:`SimState` scattered into shard-major halo shards (a
    resume); the cumulative work pair goes to shard 0, so that the shard
    sum reproduces it."""
    S, No, El = hm.n_shards, hm.No, hm.El
    state = state.to("cpu")
    slots, gids = _flat_gid(hm, "cpu")
    edt = hm.base.edtype

    def split_nodes(a):
        return a.reshape(a.shape[:-1] + (S, No)).movedim(-2, 0).contiguous()

    def split_elems(a, fill=0.0):
        flat = torch.full(a.shape[:-1] + (S * El,), fill, dtype=a.dtype)
        flat[..., slots] = a[..., gids]
        return flat.reshape(a.shape[:-1] + (S, El)).movedim(-2, 0) \
            .contiguous()

    work = torch.zeros((S, 2), dtype=hm.base.dtype)
    work[0] = state.work.to(hm.base.dtype)
    return HaloState(
        t=state.t.clone(), disp=split_nodes(state.disp),
        disp_pre=split_nodes(state.disp_pre), velo=split_nodes(state.velo),
        Q=split_nodes(state.Q),
        stress=split_elems(state.stress).to(edt),
        strain=split_elems(state.strain).to(edt),
        eq_ps=split_elems(state.eq_ps).to(edt),
        yield_s=split_elems(state.yield_s).to(edt),
        triax=split_elems(state.triax).to(edt),
        element_flag=split_elems(state.element_flag, fill=False),
        work=work)


def join_nodes(a):
    """(S, ..., No) shard-major node blocks -> (..., N) (the partition is
    contiguous)."""
    return a.movedim(0, -2).reshape(a.shape[1:-1] + (-1,))


def join_elem_field(hm: HaloModel, a, fill=0.0):
    """(S, ..., El) shard-major element field -> (..., E), global order."""
    slots, gids = _flat_gid(hm, a.device)
    flat = a.movedim(0, -2).reshape(a.shape[1:-1] + (-1,))
    out = torch.full(a.shape[1:-1] + (hm.base.E,), fill, dtype=a.dtype,
                     device=a.device)
    out[..., gids] = flat[..., slots]
    return out


def gather_state(hm: HaloModel, s: HaloState, comm=None) -> SimState:
    """The whole :class:`SimState` from shard-major halo state; with a
    :class:`HaloComm`, ``s`` is the rank's row and every rank gets the whole
    state (a collective).  ``contact_force`` is zeros and ``work`` the shard
    sum, as in the JAX package."""
    if comm is not None:
        s = comm.stack(s)
    base = hm.base
    return SimState(
        t=s.t, disp=join_nodes(s.disp), disp_pre=join_nodes(s.disp_pre),
        velo=join_nodes(s.velo), Q=join_nodes(s.Q),
        **{k: join_elem_field(hm, getattr(s, k))
           for k in ("stress", "strain", "eq_ps", "yield_s", "triax")},
        element_flag=join_elem_field(hm, s.element_flag, fill=False),
        contact_force=torch.zeros((3, base.N), dtype=base.dtype,
                                  device=s.disp.device),
        work=s.work.sum(dim=0))


class HaloComm(ShardComm):
    """One rank of a halo run: its row of the partition on its device
    (``hm``), its node view ``own`` (the whole model with the node fields
    cut to its rows, N = No: what ``_integrate`` reads) and its window
    model ``lm`` (the element fields of its shard over the window, N = W,
    E = El: what the element kernel, kernel B and erosion read), and the
    exchanges with the other ranks.  ``model`` is the whole model."""

    def __init__(self, hm: HaloModel, ctx: Rank):
        self.whole = hm                          # shard-major, on the host
        self.hm = hm.shard(ctx.rank).to(ctx.device)
        super().__init__(self.hm.base, ctx)
        self.ctx = ctx
        self.rank = ctx.rank
        # gloo's sends take host memory: a rank on the card stages them
        self.staged = ctx.backend == "gloo" and ctx.device.type == "cuda"
        self._ring_bufs = {}    # the ring's buffers by (shape, dtype)
        h = self.hm
        self.own = dataclasses.replace(
            h.base, N=h.No, coord=h.coord, diag_M=h.diag_M,
            node_exists=h.node_exists, bcd_mask=h.bc_mask,
            bcd_value=h.bc_value, bcd_amp=h.bc_amp, velo0=h.velo0)
        self.lm = dataclasses.replace(
            h.base, N=h.W, E=h.El, elem=h.elem_w, elem_exists=h.elem_alive0,
            mat_id=h.mat_id, G_e=h.G_e, lam_e=h.lam_e,
            has_plastic_e=h.has_plastic_e, yield0_e=h.yield0_e,
            vol_e=h.vol_e, coord_e=h.coord_e, inc_idx=h.inc_idx,
            inc_mask=h.inc_mask, plan_asm=None, pairs=())
        self.cforce = None      # the last step's contact force, own rows
        #                         (a buffer, so that graph replays fill it)
        if h.cn_inv is not None:
            self.cn_local = h.cn_local.long()
            self.cn_inv = h.cn_inv.long()
            self.eg_inv = h.eg_inv.long()

    def _ring(self, to_left, to_right):
        """Send ``to_left`` (C, H) to rank d-1 and ``to_right`` to rank d+1;
        returns (what rank d-1 sent to its right, what rank d+1 sent to its
        left), zeros where there is no neighbour (JAX's masked ring wrap).
        One batch of sends and receives, through buffers the comm keeps
        (static under a capture); the results are views of them, read
        before the next exchange."""
        d, S = self.rank, self.world
        key = (tuple(to_left.shape), to_left.dtype)
        bufs = self._ring_bufs.get(key)
        if bufs is None:
            # [to left, to right, from left, from right], the receives
            # zeros where no neighbour sends
            dev = to_left.new_zeros((4,) + key[0])
            host = (torch.zeros_like(dev, device="cpu", pin_memory=True)
                    if self.staged else dev)
            bufs = self._ring_bufs[key] = (dev, host)
        dev, io = bufs
        with self.timed(to_left):
            dev[0].copy_(to_left)
            dev[1].copy_(to_right)
            if self.staged:
                io[:2].copy_(dev[:2])
            ops = []
            for peer, send, recv in ((d - 1, io[0], io[2]),
                                     (d + 1, io[1], io[3])):
                if 0 <= peer < S:
                    ops += [dist.P2POp(dist.isend, send, peer, self.group),
                            dist.P2POp(dist.irecv, recv, peer, self.group)]
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            if self.staged:
                dev[2:].copy_(io[2:])
        return dev[2], dev[3]

    def exchange_window(self, x):
        """(C, No) owned rows -> (C, W) window: the left neighbour's tail
        and the right neighbour's head around them (zeros past shard 0 and
        shard S-1), JAX's ``_exchange_window``."""
        H = self.hm.H
        from_left, from_right = self._ring(x[..., :H], x[..., -H:])
        return torch.cat([from_left, x, from_right], dim=-1)

    def return_ghosts(self, fw):
        """(C, W) window forces -> (C, No) owned rows, the ghost rows' forces
        added by their owners after the owned sum: first what the right
        neighbour's head holds onto the tail, then what the left
        neighbour's tail holds onto the head (JAX's ``_return_ghosts``;
        zeros are added at the ends, as JAX adds its masked wrap)."""
        H, No = self.hm.H, self.hm.No
        from_left, from_right = self._ring(fw[..., :H], fw[..., H + No:])
        own = fw[..., H:H + No].clone()
        own[..., No - H:] += from_right
        own[..., :H] += from_left
        return own

    def assemble(self, qe24, out_dtype):
        """Q (3, No) on the own rows from this rank's qe (24, El): kernel B
        on the window table, then the ghosts' return."""
        return self.return_ghosts(
            assemble_internal_force(self.lm, qe24, out_dtype))

    def global_flag(self, flag):
        """(El,) life mask -> (E,) global, through ``eg_inv`` (padding reads
        a False pad slot); the chunk's, when hoisted."""
        if self.flag is not None:
            return self.flag
        fl = self.all_gather(flag.view(torch.uint8))
        return torch.cat([fl, fl.new_zeros(1)])[self.eg_inv].view(torch.bool)

    def contact(self, own: LoweredModel, state):
        """Contact force on the own rows (JAX's ``_halo_contact``): the
        compact (6, Ncs) block of contact-node positions and velocities is
        all-gathered and spread into a (6, N) view that is valid at the
        contact nodes (all the narrow phase reads); the pairs' narrow phase
        is dealt out over the ranks by whole blocks."""
        base, edt, No = self.model, self.model.edtype, self.hm.No
        pv = torch.cat([(own.coord + state.disp).to(edt),
                        state.velo.to(edt)])
        pvc = torch.where(self.hm.cn_mask, pv[:, self.cn_local], 0.0)
        flat = self.all_gather(pvc)
        full = torch.cat([flat, flat.new_zeros((6, 1))], 1)[:, self.cn_inv]
        cf = contact_forces_pv(base, full[:3], full[3:],
                               self.global_flag(state.element_flag),
                               self.group)
        own_cf = cf[:, self.rank * No:(self.rank + 1) * No]
        if self.cforce is None:
            self.cforce = torch.empty_like(own_cf)
        # the kept copy is contiguous, as kernel I reads it
        return self.cforce.copy_(own_cf)

    def stack(self, s: HaloState, local: bool = False) -> HaloState:
        """Every rank's row of ``s``, shard-major (a collective); with
        ``local``, the rows of this process's ranks only (a collective of
        its ranks), so that no host holds another process's rows."""
        group, n = ((self.ctx.local_group, local_ranks(self.world))
                    if local and process_count() > 1
                    else (self.group, self.world))

        def lead(x):
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=group)
            return torch.stack(parts)
        return HaloState(
            t=s.t, element_flag=lead(s.element_flag.view(torch.uint8))
            .view(torch.bool),
            **{f.name: lead(getattr(s, f.name))
               for f in dataclasses.fields(s)
               if f.name not in ("t", "element_flag")})

    def all_reduce(self, x, op):
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def initial(self, hs: HaloState | None) -> HaloState:
        """The rank's row of ``hs`` (this process's rows of a shard-major
        state) on its device, or its initial state."""
        if hs is None:
            return init_halo_state(self.hm)
        return hs.shard(self.ctx.local_rank).to(self.hm.diag_M.device)


def _halo_step(comm: HaloComm, s: HaloState) -> HaloState:
    """The generic step on a rank (JAX's ``_halo_step``): the element
    kernel's unpacked entry on the window's positions and increments, kernel
    B on the window table, the ghosts' return, erosion on the shard's
    elements (dead elements' stress and strain zeroed every step)."""
    from ..solver.explicit import _integrate
    lm, edt = comm.lm, comm.lm.edtype
    u, _ = _integrate(comm.own, s, comm)
    w = comm.exchange_window(torch.cat([comm.own.coord + u.disp_new,
                                        u.disp_new - s.disp]))
    res, triax = element_update(lm, w[:3].to(edt), w[3:].to(edt), s.stress,
                                s.strain, s.eq_ps, s.yield_s, s.element_flag,
                                want_triax=True)
    Q = comm.assemble(res.Qe.reshape(24, lm.E), lm.dtype)
    flag, stress, strain = s.element_flag, res.stress, res.strain
    if lm.fracture_enabled:
        er = erode(lm, stress, strain, res.eq_ps, triax, flag)
        flag, stress, strain = er.element_flag, er.stress, er.strain
    return s.replace(t=u.t, disp=u.disp_new, disp_pre=s.disp, velo=u.velo,
                     Q=Q, stress=stress, strain=strain, eq_ps=res.eq_ps,
                     yield_s=res.yield_s, triax=triax, element_flag=flag,
                     work=s.work if u.dwork is None else s.work + u.dwork)


def _halo_step_fast_packed(comm: HaloComm, s: HaloState, P, disp_w_prev):
    """One packed step on a rank (JAX's ``_halo_step_fast_packed``): the
    new own rows' window is exchanged once and carried as the next step's
    previous window; the element kernel's packed entry gathers both from
    the windows.  Returns (state, P, the window)."""
    from ..solver.explicit import _integrate
    lm = comm.lm
    u, _ = _integrate(comm.own, s, comm)
    disp_w = comm.exchange_window(u.disp_new)
    P_new, qe, triax, flag = packed_element_step(lm, P, s.element_flag,
                                                 disp_w, disp_w_prev)
    Q = comm.assemble(qe, lm.dtype)
    return s.replace(t=u.t, disp=u.disp_new, disp_pre=s.disp, velo=u.velo,
                     Q=Q, triax=s.triax if triax is None else triax,
                     element_flag=flag,
                     work=s.work if u.dwork is None else s.work + u.dwork), \
        P_new, disp_w


def _halo_steps(comm: HaloComm, loop: str, step, carry, n_steps: int):
    """``carry`` after ``n_steps`` of ``step(lm, *carry)``: replayed from
    the window model's captured graphs where the comm's collectives can be
    captured (``solver.explicit.uses_graphs``), else stepped eagerly."""
    from ..solver.explicit import uses_graphs
    from ..solver.graph import chunk_graphs
    lm = comm.lm
    if uses_graphs(carry[0].disp.device, comm):
        return chunk_graphs(lm, loop, step, comm.where).advance(
            lm, carry[0], n_steps, enter=lambda s: carry[1:])
    for _ in range(n_steps):
        carry = step(lm, *carry)
    return carry


def halo_run_chunk(comm: HaloComm, s: HaloState, n_steps: int) -> HaloState:
    """``n_steps`` steps of a rank (the body of JAX's ``make_halo_step``):
    the packed loop when the partition keeps ``coord_e``, else the generic
    step; in the packed loop dead elements keep stale stress until the
    chunk's exit and, on fracture-free decks, the triaxiality is formed
    there, and the window of the previous step's displacement is carried.
    On erosion-free contact decks the whole life mask is gathered once,
    for the chunk.  Under NCCL the steps replay captured graphs; the
    packed loop's entry and exit run once a chunk, around them."""
    from ..solver.explicit import finish_packed, pack_gauss_state
    base = comm.model
    comm.flag = None
    if base.pairs and not base.fracture_enabled:
        comm.hoist_flag(s.element_flag)
    try:
        if comm.lm.coord_e is None:
            return _halo_steps(comm, "halo generic",
                               lambda lm, s: (_halo_step(comm, s),), (s,),
                               n_steps)[0]
        P = pack_gauss_state(s)
        disp_w = comm.exchange_window(s.disp)
        s, P, _ = _halo_steps(
            comm, "halo packed",
            lambda lm, *carry: _halo_step_fast_packed(comm, *carry),
            (s, P, disp_w), n_steps)
        return finish_packed(comm.lm, s, P)
    finally:
        comm.flag = None


def make_halo_frame(comm: HaloComm):
    """``frame(s) -> (disp, velo, flag, NodeData)`` of the whole mesh from
    a rank's state, on every rank (a collective): the node averages of the
    output fields are formed per rank on its window (element Gauss-point
    means summed through the window table, the ghosts' parts returned to
    their owners, divided by the incident real elements), so no rank
    gathers the Gauss-point state; the (., No) node blocks and the life
    mask are all-gathered (JAX's ``make_halo_frame``).  Deleted elements
    count in the divisor, as on one device."""
    hm = comm.hm
    e_of = (hm.inc_idx % hm.El).long()
    slots, gids = _flat_gid(comm.whole, hm.diag_M.device)

    def frame(s: HaloState):
        al = hm.elem_alive0
        val = torch.cat([s.stress.mean(dim=1), s.strain,
                         s.eq_ps.mean(dim=0)[None], s.triax.mean(dim=0)[None],
                         torch.ones_like(s.triax[:1])])
        src = torch.where(al[None], val, 0.0)                    # (15, El)
        acc = torch.where(hm.inc_mask, src[:, e_of], 0.0).sum(dim=-2)
        own = comm.return_ghosts(acc)                            # (15, No)
        nf = own[:14] / torch.clamp(own[14], min=1.0)
        sx, sy, sz, txy, tyz, txz = (nf[i] for i in range(6))
        mises = torch.sqrt(0.5 * ((sx - sy)**2 + (sy - sz)**2 + (sx - sz)**2
                                  + 6.0 * (txy**2 + tyz**2 + txz**2)))
        nodes = comm.all_gather(torch.cat([nf, mises[None]]))    # (15, N)
        dv = comm.all_gather(torch.cat([s.disp, s.velo]))        # (6, N)
        fl = comm.all_gather(s.element_flag.view(torch.uint8))
        flag = torch.zeros(comm.model.E, dtype=torch.bool, device=fl.device)
        flag[gids] = fl[slots].view(torch.bool)
        nd = NodeData(nodes[:6], nodes[6:12], nodes[12], nodes[14],
                      nodes[13])
        return dv[:3], dv[3:], flag, nd
    return frame


# ---------------------------------------------------------------------------
# shard-major checkpoints, in the JAX package's formats, so files pass
# between the packages.  One process: one .npz of (S, ...) leaves plus
# halo_format [S, No, El].  Several processes: each process's local rank 0
# writes {path}.p{K}.npz of its own rows (halo_rows, halo_procs [K, P]
# beside them) and process 0 the manifest at path (halo_format,
# halo_manifest [P]), so no host ever holds the global element state.
# ---------------------------------------------------------------------------

def process_rows(n_shards: int) -> list[int]:
    """The shard rows of this process's ranks (JAX's ``_local_shard_rows``
    over ``make_mesh``'s process-major device order)."""
    local = local_ranks(n_shards)
    return list(range(process_index() * local, (process_index() + 1) * local))


def proc_shard_path(path: str, pid: int) -> str:
    return f"{path}.p{pid}.npz"


def save_halo_checkpoint(path: str, hm: HaloModel, s: HaloState,
                         rows: list[int] | None = None,
                         procs: tuple[int, int] | None = None) -> str:
    """Write shard-major ``s`` (on any device) to ``path``; with ``rows``
    (the global rows ``s`` holds) and ``procs`` (this process's index, the
    process count), this process's file ``{path}.p{K}.npz`` instead, and
    from process 0 the manifest at ``path``."""
    fmt = np.array([hm.n_shards, hm.No, hm.El], np.int64)
    leaves = {f.name: getattr(s, f.name).detach().cpu().numpy()
              for f in dataclasses.fields(s)}
    leaves["halo_format"] = fmt
    if rows is None:
        np.savez_compressed(path, **leaves)
        return path
    pid, nproc = procs
    leaves["halo_rows"] = np.asarray(rows, np.int64)
    leaves["halo_procs"] = np.array([pid, nproc], np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(proc_shard_path(path, pid), **leaves)
    if pid == 0:
        np.savez(path, halo_format=fmt,
                 halo_manifest=np.array([nproc], np.int64))
    return path


def is_halo_checkpoint(path: str) -> bool:
    with np.load(path) as data:
        return "halo_format" in data


def _check_format(data, hm: HaloModel, hint: str) -> None:
    S, No, El = (int(x) for x in data["halo_format"])
    if (S, No, El) != (hm.n_shards, hm.No, hm.El):
        raise ValueError(
            f"halo checkpoint partition (S={S}, No={No}, El={El}) does not "
            f"match the current partition (S={hm.n_shards}, No={hm.No}, "
            f"El={hm.El}){hint}")


def _leaves(data, hm: HaloModel, n_rows: int) -> HaloState:
    """The HaloState of ``n_rows`` shard rows in ``data``, in the
    partition's dtypes, on the CPU."""
    like = init_halo_state(hm.to("cpu") if hm.diag_M.device.type != "cpu"
                           else hm)
    kw = {}
    for f in dataclasses.fields(like):
        ref = getattr(like, f.name)
        shape = tuple(ref.shape) if f.name == "t" else \
            (n_rows,) + tuple(ref.shape[1:])
        if f.name == "work" and f.name not in data:
            kw[f.name] = torch.zeros(shape, dtype=ref.dtype)
            continue
        arr = data[f.name]
        if arr.shape != shape:
            raise ValueError(f"halo checkpoint field {f.name} has shape "
                             f"{arr.shape}, partition expects {shape}")
        kw[f.name] = torch.as_tensor(arr).to(ref.dtype)
    return HaloState(**kw)


def load_halo_checkpoint(path: str, hm: HaloModel) -> HaloState:
    """The shard-major state in ``path``, on the CPU; its partition
    geometry (shards, owned rows, element slots) must be ``hm``'s.  A
    manifest (several processes) must name this run's process count: this
    process then reads only its own file and gets its own rows, which must
    be the rows it saved."""
    data = np.load(path)
    if "halo_manifest" in data:
        nproc = int(data["halo_manifest"][0])
        if nproc != process_count():
            raise ValueError(
                f"halo checkpoint was written by {nproc} processes; this "
                f"run has {process_count()} — resume on the same process "
                "layout")
        data = np.load(proc_shard_path(path, process_index()))
        _check_format(data, hm, "")
        saved, now = [int(r) for r in data["halo_rows"]], \
            process_rows(hm.n_shards)
        if saved != now:
            raise ValueError(
                f"process {process_index()} owned shard rows {saved} at "
                f"save time but owns {now} now — resume on the same "
                "mesh/process layout")
        return _leaves(data, hm, len(now))
    _check_format(data, hm, "; re-partition with the same device count and "
                  "padding, or resume through a single-chip checkpoint")
    return _leaves(data, hm, hm.n_shards)


class HaloView:
    """What ``run_loop`` reads of a rank's halo state between chunks; every
    method is a collective that every rank calls at the same point, and
    the root rank alone writes (see ``solver.explicit.LoopView``)."""

    collective = True

    def __init__(self, comm: HaloComm, root: bool):
        self.comm, self.root = comm, root
        self.frame_fn = make_halo_frame(comm)
        self.s = None

    def update(self, s):
        self.s = s

    def alive(self) -> int:
        n = self.s.element_flag.sum().reshape(1).to(torch.float64)
        return int(self.comm.all_reduce(n, dist.ReduceOp.SUM))

    def finite(self) -> bool:
        bad = (~torch.isfinite(self.s.disp)).sum().reshape(1).double()
        return int(self.comm.all_reduce(
            bad, dist.ReduceOp.SUM)) == 0

    def metrics(self) -> dict:
        from ..utils.metrics import halo_step_metrics
        return halo_step_metrics(self.comm.hm, self.s, self.comm.group)

    def energy_rel(self) -> float:
        return float(self.metrics()["energy_rel_error"])

    def frame_data(self):
        out = self.frame_fn(self.s)
        return out if self.root else None

    def save(self, path: str):
        """One file from the root rank; with several processes, one file a
        process from its local rank 0, of its own ranks' rows."""
        ctx, nproc = self.comm.ctx, process_count()
        rows = self.comm.stack(self.s, local=True)
        if nproc == 1 and self.root:
            save_halo_checkpoint(path, self.comm.whole, rows)
        elif nproc > 1 and ctx.local_rank == 0:
            save_halo_checkpoint(path, self.comm.whole, rows,
                                 process_rows(self.comm.world),
                                 (ctx.process, nproc))

    def final(self) -> SimState:
        return gather_state(self.comm.whole, self.s, self.comm)


def halo_rank(ctx: Rank, hm: HaloModel, hs: HaloState | None,
              verbose: bool, write_output: bool, profile: str | None = None):
    """One rank of ``run(halo=n)``: the host loop on the rank's shard from
    ``hs`` (this process's rows) or the initial state, its checkpoints
    shard-major; rank 0 writes frames, metrics and console lines and, with
    ``profile``, traces its loop; each process's local rank 0 returns (the
    whole final state on the CPU, its timings)."""
    from ..solver.explicit import run_loop
    from ..utils.profiling import trace
    check_same(ctx, "partition", hm)
    comm = HaloComm(hm, ctx)
    s = comm.initial(hs)
    clock = {}
    with trace(profile if ctx.rank == 0 else None):
        final = run_loop(comm.model, s,
                         lambda x, n: halo_run_chunk(comm, x, n),
                         HaloView(comm, ctx.rank == 0), verbose,
                         write_output, clock)
    return (final.to("cpu"), clock) if ctx.local_rank == 0 else None


def run_halo(model: LoweredModel, state: SimState | None, halo: int,
             device="cuda", backend: str | None = None, verbose: bool = True,
             write_output: bool = True, resume_halo: str | None = None,
             profile: str | None = None):
    """``run()`` on ``halo`` node-sharded ranks, spread over the run's
    processes (``parallel.dist``): partitioned here, in every process;
    resumed from a shard-major checkpoint (``resume_halo``) or from a whole
    state with t > 0, each process handing its ranks only its own rows.
    Returns (the final state on the CPU, this process's local rank 0's
    timings)."""
    hm = partition(model.to("cpu"), halo)
    rows = process_rows(halo)
    hs = None
    if resume_halo is not None:
        hs = load_halo_checkpoint(resume_halo, hm)
    elif state is not None and int(state.t) > 0:
        hs = partition_state(hm, state)
    if hs is not None and hs.disp.shape[0] == halo:
        hs = hs.shard(slice(rows[0], rows[-1] + 1))
    return launch(halo_rank, halo, device, backend, hm, hs, verbose,
                  write_output, profile)


def halo_job(ctx: Rank, job: dict, measure) -> dict:
    """A halo job of ``sharding.chunk_rank``: ``job["model"]`` partitioned
    over the launch's ranks, stepped from ``job.get("state")`` (whole) by
    ``measure`` (``sharding._measured``); with ``roundtrip``, after each
    chunk the state goes through ``gather_state`` and ``partition_state``
    (a resume) before the next.  Adds the partition's numbers and, per
    chunk, the largest contact force on any rank."""
    hm = partition(job["model"].to("cpu"), ctx.world)
    comm = HaloComm(hm, ctx)
    st = job.get("state")
    s = comm.initial(None if st is None else partition_state(hm, st))

    def after(s, g):
        if job.get("roundtrip"):
            return comm.initial(partition_state(hm, g.to("cpu")))
        return s

    def contact_max(s, g):
        cf = (comm.cforce.abs().max().reshape(1).double()
              if comm.cforce is not None
              else torch.zeros(1, dtype=torch.float64, device=s.disp.device))
        return float(comm.all_reduce(cf, dist.ReduceOp.MAX))

    rec = measure(ctx, comm, s, job,
                  lambda x, n: halo_run_chunk(comm, x, n),
                  lambda x: gather_state(hm, x, comm), contact_max, comm.lm,
                  after)
    rec["partition"] = dict(No=hm.No, H=hm.H, W=hm.W, El=hm.El,
                            packed=hm.coord_e is not None,
                            exchange_bytes=exchange_bytes(hm, ctx.rank))
    return rec
