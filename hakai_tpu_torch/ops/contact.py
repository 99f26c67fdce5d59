"""Penalty contact: node-vs-triangle narrow phase with AABB and grid-cell
culling (mirrors ``hakai_tpu/ops/contact.py``).

Per step and directional pair: the activity masks over the static face
inventory (a pure function of the element life mask, carried through a
single-device chunk with each pair's list of active triangles,
``ops/activity.py``) and the broad phase (masked AABBs, the overlap test,
the range cull and the block AABBs that decide which (triangle block,
node block) pairs the narrow phase visits), both kernel A
(``ops/broad_cuda.py``), then the narrow phase (kernel N,
``ops/contact_cuda.py``).  One gather (kernel G) feeds every pair's
kinematics, in a chunk only the listed triangles' and the nodes' columns,
and one scatter (kernel S) sums every pair's forces onto the nodes.
Nothing reads a value back to the host: where the JAX package compacts the
surviving block pairs and loops over them with a dynamic trip count under
``lax.cond(overlap)``, the kernels read ``pair_ok`` and ``overlap`` on the
device and skip culled work.

Under element sharding each rank runs the broad phase on the whole
(replicated) node state and a share of the narrow phase
(:func:`deal_block_pairs`), and the ranks sum their pair-force buffers
with one ``all_reduce`` before the one scatter.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.lowering import LoweredModel
from .broad_cuda import (broad, broad_phase, list_active,  # noqa: F401
                         pair_activity)
from .contact_cuda import narrow_phase, pair_constants, scatter_forces
from .gather_cuda import gather_cols, gather_listed


def contact_activity(model: LoweredModel, flag):
    """Per-pair activity masks for the whole model (see pair_activity)."""
    return tuple(pair_activity(p, flag) for p in model.pairs)


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


def contact_kinematics(model: LoweredModel, position, velo, carry=None):
    """The merged (6, R) kinematics of every pair: one gather (kernel G)
    of the (6, N) position/velocity rows through ``ckin_idx``; with
    ``carry`` (see :func:`contact_forces_pv`) only what the step's kernels
    read of it, the carried pairs' listed triangles and the nodes."""
    src = torch.cat([position, velo])
    if carry is None:
        return gather_cols(src, model.ckin_idx)
    return gather_listed(src, model.ckin_idx, carry.listed)


def contact_forces_pv(model: LoweredModel, position, velo, element_flag,
                      group=None, carry=None):
    """Sum of all directional pair forces, (3, N) in the nodal dtype, from
    (3, N) position and velocity in the element dtype and the (E,) life
    mask.  The pairs' sums run in the element dtype, in one scatter.  With
    a process ``group`` the narrow phase is dealt out over its ranks and
    the pair-force buffers summed over them (every rank gets the total).
    With ``carry`` (a chunk's :class:`~hakai_tpu_torch.ops.activity.
    ActivityCarry`) the activity masks and the lists of active triangles
    are the carried ones, rebuilt only after a deletion, and the gather
    and the range cull visit the listed triangles only; without, every
    call recomputes the masks and sweeps every slot."""
    carried = (None,) * len(model.pairs) if carry is None else carry.pairs
    changed = None if carry is None else carry.flags[2]
    if carry is not None:
        for i, (pair, c) in enumerate(zip(model.pairs, carried)):
            list_active(pair, element_flag, c, changed, carry.stats,
                        i == len(carried) - 1)
    kin = contact_kinematics(model, position, velo, carry)
    force = torch.empty((3, model.fs_width), dtype=kin.dtype,
                        device=kin.device)
    for i, (pair, c) in enumerate(zip(model.pairs, carried)):
        consts = pair_constants(model, pair)
        ksl = model.ckin_slices[i]
        bp = broad(pair, kin, ksl, element_flag, consts, c, changed)
        sides = None if group is None else deal_block_pairs(
            bp.pair_ok, dist.get_rank(group), dist.get_world_size(group))
        narrow_phase(pair, kin, ksl, bp, consts, force, model.fs_offsets[i],
                     sides=sides)
    if group is not None:
        dist.all_reduce(force, group=group)
    return scatter_forces(model, force, model.dtype)


def contact_forces(model: LoweredModel, state, group=None, carry=None):
    """Contact force of ``state``, (3, N) in the nodal dtype; the narrow
    phase runs in the element dtype (float32 in mixed mode).  With a
    process ``group``, ``state.element_flag`` is the whole life mask and
    the narrow phase is dealt out over the group's ranks; ``carry`` as for
    :func:`contact_forces_pv`."""
    edt = model.edtype
    return contact_forces_pv(model, (model.coord + state.disp).to(edt),
                             state.velo.to(edt), state.element_flag, group,
                             carry)
