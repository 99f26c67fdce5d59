"""Penalty contact: node-vs-triangle narrow phase with AABB and grid-cell
culling (mirrors ``hakai_tpu/ops/contact.py``).

Per step and directional pair: the activity masks over the static face
inventory (a pure function of the element life mask), the broad phase in
plain PyTorch on the device (masked AABBs, the overlap test, the range
cull and the block AABBs that decide which (triangle block, node block)
pairs the narrow phase visits), then the narrow phase (kernel N,
``ops/contact_cuda.py``).  One gather (kernel G) feeds every pair's
kinematics and one scatter (kernel S) sums every pair's forces onto the
nodes.  Nothing reads a value back to the host: where the JAX package
compacts the surviving block pairs and loops over them with a dynamic trip
count under ``lax.cond(overlap)``, the kernels read ``pair_ok`` and
``overlap`` on the device and skip culled work.

Under element sharding each rank runs the broad phase on the whole
(replicated) node state and a share of the narrow phase
(:func:`deal_block_pairs`), and the ranks sum their pair-force buffers
with one ``all_reduce`` before the one scatter.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.lowering import ContactPair, LoweredModel
from .contact_cuda import (BroadPhase, PairConstants, kin_views, narrow_phase,
                           pair_constants, scatter_forces)
from .gather_cuda import gather_cols


def _node_active(flag, init, twins):
    tw_dead = (twins >= 0) & ~flag[twins.clamp_min(0)]
    return init | tw_dead.any(dim=1)


def pair_activity(pair: ContactPair, flag):
    """(tri_active, ni_active, nj_active) masks over the static inventory
    (the reference's surface appends, add_surface_triangle
    HAKAI_j.jl:2167-2245, as mask flips); None on fracture-free pairs,
    whose inventory was culled at lowering."""
    if pair.static_activity:
        return None
    twin_dead = (pair.tri_twin >= 0) & ~flag[pair.tri_twin.clamp_min(0)]
    tri_active = (pair.tri_init | twin_dead) & flag[pair.tri_elem]
    return (tri_active, _node_active(flag, pair.cand_init, pair.cand_twin),
            _node_active(flag, pair.jnode_init, pair.jnode_twin))


def contact_activity(model: LoweredModel, flag):
    """Per-pair activity masks for the whole model (see pair_activity)."""
    return tuple(pair_activity(p, flag) for p in model.pairs)


def _masked_minmax(x, valid):
    if valid is None:
        return x.amin(dim=-1), x.amax(dim=-1)
    return (torch.where(valid, x, float("inf")).amin(dim=-1),
            torch.where(valid, x, float("-inf")).amax(dim=-1))


def _pad_last(x, n, fill):
    if x.shape[-1] == n:
        return x
    return torch.cat([x, x.new_full(x.shape[:-1] + (n - x.shape[-1],), fill)],
                     dim=-1)


def broad_phase(pair: ContactPair, kin, ksl, activity,
                consts: PairConstants) -> BroadPhase:
    """``_pair_force``'s prologue (contact.py:160-236): the AABBs of the
    two active node sets, their overlap, the range cull of triangles and
    nodes, and the (tri_chunks, n_chunks) block pairs whose q0-based and
    node boxes, padded by 2*ddiv, overlap."""
    q0, q1, q2, _, pos_i, _, pos_jn = kin_views(kin, ksl)
    tri_a, ni_a, nj_a = activity if activity is not None else (None,) * 3
    min_i, max_i = _masked_minmax(pos_i, ni_a)
    min_j, max_j = _masked_minmax(pos_jn, nj_a)
    range_min, range_max = torch.maximum(min_i, min_j), \
        torch.minimum(max_i, max_j)
    overlap = (range_min <= range_max).all()
    if tri_a is not None:
        overlap = overlap & tri_a.any() & ni_a.any()
    lo, hi = range_min[:, None], range_max[:, None]
    tri_in = ~(((q0 < lo) & (q1 < lo) & (q2 < lo)).any(dim=0)
               | ((q0 > hi) & (q1 > hi) & (q2 > hi)).any(dim=0))
    node_in = ((pos_i >= lo) & (pos_i <= hi)).all(dim=0)
    if tri_a is not None:
        tri_in = tri_in & tri_a
        node_in = node_in & ni_a
    tc, nc, TB, nb = pair.tri_chunks, pair.n_chunks, pair.tb, pair.nb
    tin_p = _pad_last(tri_in, pair.Tp, False)
    nin_p = _pad_last(node_in, pair.Cp, False)
    q0_p, pos_p = _pad_last(q0, pair.Tp, 0.0), _pad_last(pos_i, pair.Cp, 0.0)
    inf = float("inf")
    bmin_t = torch.where(tin_p, q0_p, inf).view(3, tc, TB).amin(dim=2)
    bmax_t = torch.where(tin_p, q0_p, -inf).view(3, tc, TB).amax(dim=2)
    bmin_n = torch.where(nin_p, pos_p, inf).view(3, nc, nb).amin(dim=2)
    bmax_n = torch.where(nin_p, pos_p, -inf).view(3, nc, nb).amax(dim=2)
    pad = 2.0 * consts.ddiv
    pair_ok = ((bmin_t[:, :, None] - pad <= bmax_n[:, None, :])
               & (bmin_n[:, None, :] - pad <= bmax_t[:, :, None])).all(dim=0)
    pair_ok &= (tin_p.view(tc, TB).any(dim=1)[:, None]
                & nin_p.view(nc, nb).any(dim=1)[None, :])
    return BroadPhase(tri_in, node_in, torch.minimum(min_i, min_j),
                      pair_ok, overlap)


def deal_block_pairs(pair_ok, rank: int, world: int):
    """Rank ``rank``'s share of the narrow phase: (the node launch's, the
    triangle launch's) block-pair masks.  The k-th node block that has a
    surviving pair goes whole to rank ``k % world``'s node launch, the k-th
    such triangle block to its triangle launch, so every node's and every
    triangle's force is summed on one rank, in the single-device order,
    and the other ranks add exact zeros: the sharded contact force is the
    single-device one, bit for bit.  (JAX deals single block pairs
    round-robin, contact.py:350-370, which splits a node's sum over ranks
    and reassociates it; in float32 that flips accept decisions near
    their thresholds.)  Found with cumsums on the device; nothing reads
    back to the host."""
    def share(active):
        k = torch.cumsum(active, 0) - 1
        return active & (k % world == rank)
    return (pair_ok & share(pair_ok.any(dim=0))[None, :],
            pair_ok & share(pair_ok.any(dim=1))[:, None])


def contact_kinematics(model: LoweredModel, position, velo):
    """The merged (6, R) kinematics of every pair: one gather (kernel G)
    of the (6, N) position/velocity rows through ``ckin_idx``."""
    return gather_cols(torch.cat([position, velo]), model.ckin_idx)


def contact_forces_pv(model: LoweredModel, position, velo, element_flag,
                      group=None):
    """Sum of all directional pair forces, (3, N) in the nodal dtype, from
    (3, N) position and velocity in the element dtype and the (E,) life
    mask.  The pairs' sums run in the element dtype, in one scatter.  With
    a process ``group`` the narrow phase is dealt out over its ranks and
    the pair-force buffers summed over them (every rank gets the total)."""
    kin = contact_kinematics(model, position, velo)
    force = torch.empty((3, model.fs_width), dtype=kin.dtype,
                        device=kin.device)
    for i, pair in enumerate(model.pairs):
        consts = pair_constants(model, pair)
        ksl = model.ckin_slices[i]
        bp = broad_phase(pair, kin, ksl, pair_activity(pair, element_flag),
                         consts)
        sides = None if group is None else deal_block_pairs(
            bp.pair_ok, dist.get_rank(group), dist.get_world_size(group))
        narrow_phase(pair, kin, ksl, bp, consts, force, model.fs_offsets[i],
                     sides=sides)
    if group is not None:
        dist.all_reduce(force, group=group)
    return scatter_forces(model, force, model.dtype)


def contact_forces(model: LoweredModel, state, group=None):
    """Contact force of ``state``, (3, N) in the nodal dtype; the narrow
    phase runs in the element dtype (float32 in mixed mode).  With a
    process ``group``, ``state.element_flag`` is the whole life mask and
    the narrow phase is dealt out over the group's ranks."""
    edt = model.edtype
    return contact_forces_pv(model, (model.coord + state.disp).to(edt),
                             state.velo.to(edt), state.element_flag, group)
