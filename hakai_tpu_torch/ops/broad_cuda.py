"""Kernel A (``csrc/broad.cu``): contact activity and the broad phase of one
directional pair, the counterpart of the XLA fusion of the JAX step's
``pair_activity`` and ``_pair_force`` prologue
(``hakai_tpu/ops/contact.py:45-59``, ``:160-236``), with its plain
versions :func:`pair_activity`, :func:`active_list_plain` and
:func:`broad_phase`.

:func:`broad` is the step's entry: for tensors on the CPU it runs the plain
versions, for CUDA tensors it launches the kernel (three launches) on the
current stream, or raises.  On a pair whose masks a chunk carries
(``ops/activity.py``) :func:`list_active` runs first, before the step's
gather: it recomputes the triangle mask and the list of active triangles
only when the carry's flag says that the previous step deleted an element
(or the chunk begins); :func:`broad` then recomputes the node masks under
the same flag, and its range cull visits the listed triangles only.  The
decisions are taken on the device (on the CPU by a host test of the flag).
"""
from __future__ import annotations

import torch

from .. import _build
from ..core.lowering import ContactPair
from .contact_cuda import BroadPhase, PairConstants, kin_views

_ENTRIES = {torch.float32: "hk_broad_f32", torch.float64: "hk_broad_f64"}
_NODES = 256                   # kBlock in csrc/broad.cu
_ANY = 4                       # kAny in csrc/broad.cu
# (Ci, Cj, tri_chunks, n_chunks, dtype, device) -> (boxes, int32 words,
# node blocks): the kernel's workspace, allocated once per shapes outside
# any capture (calls run in stream order, so pairs of equal shapes share
# it): the node blocks' boxes, the overlap range, the chunks' boxes; the
# ORs and a ticket, then the chunks' flags.  Its ORs and ticket start zero
# and each call leaves them so
_WORKSPACES: dict = {}


def _node_active(flag, init, twins):
    tw_dead = (twins >= 0) & ~flag[twins.clamp_min(0)]
    return init | tw_dead.any(dim=1)


def _tri_active(pair: ContactPair, flag):
    twin_dead = (pair.tri_twin >= 0) & ~flag[pair.tri_twin.clamp_min(0)]
    return (pair.tri_init | twin_dead) & flag[pair.tri_elem]


def pair_activity(pair: ContactPair, flag):
    """(tri_active, ni_active, nj_active) masks over the static inventory
    (the reference's surface appends, add_surface_triangle
    HAKAI_j.jl:2167-2245, as mask flips); None on fracture-free pairs,
    whose inventory was culled at lowering."""
    if pair.static_activity:
        return None
    return (_tri_active(pair, flag),
            _node_active(flag, pair.cand_init, pair.cand_twin),
            _node_active(flag, pair.jnode_init, pair.jnode_twin))


def active_list_plain(tri_active, tb: int):
    """(ids, starts) of a (F2,) triangle mask: ``ids`` (count,) int32, the
    active triangles in increasing order; ``starts`` (tri_chunks + 1,)
    int32, the exclusive sum of the chunks' counts (chunks of ``tb`` ids,
    the last one ragged), so chunk c's triangles are
    ``ids[starts[c]:starts[c + 1]]`` and ``starts[-1]`` is the count.
    Each active id lands at its chunk's start plus its rank among the
    chunk's active ids, as ``broad_list`` places it."""
    F2 = tri_active.shape[0]
    tc = -(-F2 // tb)
    a = _pad_last(tri_active, tc * tb, False).view(tc, tb)
    starts = torch.zeros(tc + 1, dtype=torch.int64, device=a.device)
    starts[1:] = torch.cumsum(a.sum(dim=1), 0)
    place = starts[:-1, None] + torch.cumsum(a, dim=1) - 1
    ids = torch.empty(int(starts[-1]), dtype=torch.int64, device=a.device)
    ids[place[a]] = torch.arange(tc * tb, device=a.device).view(tc, tb)[a]
    return ids.int(), starts.int()


def list_active(pair: ContactPair, flag, carried, changed, stats,
                last: bool) -> None:
    """Kernel A's first launch on a pair whose masks a chunk carries, before
    the step's gather: when ``changed`` (the carry's 0-d int32 flag) is
    set, the triangle mask from the (E,) life mask ``flag`` into
    ``carried.masks[0]``, the list of active triangles into ``carried.ids``,
    ``carried.starts`` and ``carried.count`` (:func:`active_list_plain`),
    ``carried.tri_in`` cleared off the list, and the carry's ``stats``
    counted (``last``: the model's last pair, which folds the step's count
    into the most listed and counts a rebuild after a deletion); else
    nothing."""
    dev = flag.device
    if dev.type == "cpu":
        if int(changed):
            tri = _tri_active(pair, flag)
            carried.masks[0].copy_(tri)
            ids, starts = active_list_plain(tri, pair.tb)
            carried.ids[:len(ids)] = ids
            carried.starts.copy_(starts)
            carried.count.fill_(len(ids))
            carried.tri_in.logical_and_(tri)
            stats[1] += len(ids)
            if last:
                stats[2] = torch.maximum(stats[2], stats[1])
                stats[1] = 0
                stats[0] += int(changed) & 1
        return
    if dev.type != "cuda":
        raise ValueError(f"no broad-phase kernel for device {dev}")
    F2, tc = pair.tri_nodes.shape[1], pair.tri_chunks
    _build.check_inputs(dev, {
        "flag": (flag, (flag.shape[0],), torch.bool),
        "tri_init": (pair.tri_init, (F2,), torch.bool),
        "tri_twin": (pair.tri_twin, (F2,), torch.int32),
        "tri_elem": (pair.tri_elem, (F2,), torch.int32),
        "changed": (changed, (), torch.int32),
        "tri_active": (carried.masks[0], (F2,), torch.bool),
        "tri_in": (carried.tri_in, (F2,), torch.bool),
        "ids": (carried.ids, (F2,), torch.int32),
        "starts": (carried.starts, (tc + 1,), torch.int32),
        "count": (carried.count, (1,), torch.int32),
        "look": (carried.look, (tc + 1,), torch.int64),
        "stats": (stats, (3,), torch.int32)})
    _build.launch("hk_broad_list", dev, flag, pair.tri_init, pair.tri_twin,
                  pair.tri_elem, F2, pair.tb, tc, changed, carried.masks[0],
                  carried.tri_in, carried.ids, carried.starts, carried.count,
                  carried.look, stats, int(last))


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


def _workspace(pair: ContactPair, Ci: int, Cj: int, dtype, device):
    key = (Ci, Cj, pair.tri_chunks, pair.n_chunks, dtype, device)
    if key not in _WORKSPACES:
        nbox = -(-Ci // _NODES) + -(-Cj // _NODES)
        chunks = pair.tri_chunks + pair.n_chunks
        _WORKSPACES[key] = (
            torch.empty(6 * (nbox + 1 + chunks), dtype=dtype, device=device),
            torch.zeros(_ANY + chunks, dtype=torch.int32, device=device),
            nbox)
    return _WORKSPACES[key]


def broad(pair: ContactPair, kin, ksl, flag, consts: PairConstants,
          carried=None, changed=None) -> BroadPhase:
    """One pair's :class:`BroadPhase` from the merged (6, R) kinematics
    ``kin`` (its slices ``ksl``) and the (E,) life mask ``flag``.  On a pair
    whose masks depend on ``flag`` a chunk's step passes ``carried`` (the
    pair's :class:`~hakai_tpu_torch.ops.activity.PairCarry`, whose
    triangle mask and list :func:`list_active` has made this step) and
    ``changed`` (the carry's 0-d int32 flag): the node masks are
    recomputed into the carry when it is set and read otherwise, the range
    cull visits the listed triangles only, and ``tri_in`` is the carry's
    buffer (false off the list); ``kin`` need hold the listed triangles'
    columns only.  Without ``carried`` every mask is recomputed and the
    range cull sweeps every slot."""
    dev = kin.device
    if dev.type == "cpu":
        if carried is None:
            return broad_phase(pair, kin, ksl, pair_activity(pair, flag),
                               consts)
        if int(changed):
            for k, a in zip(carried.masks[1:],
                            pair_activity(pair, flag)[1:]):
                k.copy_(a)
        bp = broad_phase(pair, kin, ksl, carried.masks, consts)
        carried.tri_in.copy_(bp.tri_in)
        return bp._replace(tri_in=carried.tri_in)
    if dev.type != "cuda":
        raise ValueError(f"no broad-phase kernel for device {dev}")
    dt = kin.dtype
    if dt not in _ENTRIES:
        raise TypeError(f"no broad-phase kernel for {dt}")
    (a0, b0), (a1, _), (a2, _), (cs, ce), (js, je) = ksl
    F2, Ci, Cj, R = b0 - a0, ce - cs, je - js, kin.shape[1]
    tc, nc = pair.tri_chunks, pair.n_chunks
    dyn = not pair.static_activity
    spec = {"kin": (kin, (6, R), dt)}
    if carried is not None:
        if not dyn:
            raise ValueError("a fracture-free pair carries no activity")
        masks, tri_in = carried.masks, carried.tri_in
        ids, starts = carried.ids, carried.starts
        spec.update({"changed": (changed, (), torch.int32),
                     "ids": (ids, (F2,), torch.int32),
                     "starts": (starts, (tc + 1,), torch.int32)})
    else:
        masks = tuple(torch.empty(n, dtype=torch.bool, device=dev)
                      for n in (F2, Ci, Cj)) if dyn else (None,) * 3
        tri_in = torch.empty(F2, dtype=torch.bool, device=dev)
        changed = ids = starts = None
    if dyn:
        VT, VTj = pair.cand_twin.shape[1], pair.jnode_twin.shape[1]
        spec.update({
            "flag": (flag, (flag.shape[0],), torch.bool),
            "tri_init": (pair.tri_init, (F2,), torch.bool),
            "tri_twin": (pair.tri_twin, (F2,), torch.int32),
            "tri_elem": (pair.tri_elem, (F2,), torch.int32),
            "cand_init": (pair.cand_init, (Ci,), torch.bool),
            "cand_twin": (pair.cand_twin, (Ci, VT), torch.int32),
            "jnode_init": (pair.jnode_init, (Cj,), torch.bool),
            "jnode_twin": (pair.jnode_twin, (Cj, VTj), torch.int32),
            "tri_active": (masks[0], (F2,), torch.bool),
            "ni_active": (masks[1], (Ci,), torch.bool),
            "nj_active": (masks[2], (Cj,), torch.bool),
            "tri_in": (tri_in, (F2,), torch.bool)})
    _build.check_inputs(dev, spec)
    boxes, iws, nbox = _workspace(pair, Ci, Cj, dt, dev)
    node_in = torch.empty(Ci, dtype=torch.bool, device=dev)
    all_min = torch.empty(3, dtype=dt, device=dev)
    pair_ok = torch.empty((tc, nc), dtype=torch.bool, device=dev)
    overlap = torch.empty((), dtype=torch.bool, device=dev)

    def on(x):
        # the activity arguments: NULL on a pair whose activity does not
        # depend on flag
        return x if dyn else None
    _build.launch(
        _ENTRIES[dt], dev, kin, R, a0, a1, a2, cs, js, F2, Ci, Cj, on(flag),
        on(pair.tri_init), on(pair.tri_twin), on(pair.tri_elem),
        on(pair.cand_init), on(pair.cand_twin), pair.cand_twin.shape[1],
        on(pair.jnode_init), on(pair.jnode_twin), pair.jnode_twin.shape[1],
        masks[0], masks[1], masks[2], changed, ids, starts, pair.tb, pair.nb,
        tc, nc, 2.0 * consts.ddiv, tri_in, node_in, all_min, pair_ok,
        overlap, boxes, boxes[6 * (nbox + 1):], iws)
    return BroadPhase(tri_in, node_in, all_min, pair_ok, overlap)
