"""The chunk-carried contact activity: the counterpart of the JAX chunk
loop's ``_init_activity`` and ``_next_activity``
(``hakai_tpu/solver/explicit.py:157-181``).

The activity masks of a pair (``ops/contact.py:pair_activity``) are pure
functions of the life mask, and only erosion writes the life mask, so a
chunk may keep them from step to step and recompute them only on a step
after one in which erosion deleted an element; JAX does so under a
``lax.cond``.  Here the masks live in buffers the model object holds (one
:class:`ActivityCarry`, made at chunk entry, outside any capture), and the
decision stays on the device: the erosion walk (kernel E) writes whether
any element died into ``flags[2]``, and the next step's kernel A
recomputes the masks into the buffers only when it is set.  The graphs
stay static and nothing is read back.  On the CPU the plain versions do
the same with ``torch.where(changed, recomputed, kept)``.

Beside its masks the carry holds each pair's list of active triangles
(:class:`PairCarry`): their ids in increasing order and, per triangle
chunk of TB ids, the start of the chunk's run in the list.  Kernel A
rebuilds it whenever it recomputes the masks, before the step's gather
(``broad_cuda.list_active``), and the step's gather (kernel G) and range
cull (kernel A) visit only the listed triangles rather than the whole face
inventory, which keeps every face of every element so that erosion can
expose it (~5% of it is active on the impact deck).  Kernel N reads the
pair's ``tri_in`` over every slot, so the carry holds that buffer too: the
rebuild clears it off the list, and the range cull writes the listed
slots.  ``stats`` counts the rebuilds that followed a deletion and the
most triangles listed at a rebuild (:func:`list_stats`).

The chunk (``solver/explicit.py``: ``eager_chunk``, ``graph_chunk``)
takes the carry from :func:`chunk_carry` and passes it to its steps, as
it binds a rank's ``comm``.  Kernel E writes 1 into ``flags[2]`` when a
step deletes an element, else 0; at chunk entry the flag gains 2, so the
first step recomputes: the invariant "flag clear => the masks and lists
are those of the step's life mask" holds at every step, and the carried
masks are bitwise a per-step recompute.

Only a single-device chunk carries them.  A rank's erosion sees only its
own elements, and the flag that decides is the whole life mask's: knowing
it would cost the ranks a collective every step, so ranks (element-sharded
and halo) recompute the masks every step from the life mask they already
gather, and sweep the whole inventory.  A fracture-free deck carries
nothing: its inventory was culled to the exterior at lowering, and every
slot is active.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lowering import LoweredModel
from .gather_cuda import Listed


class PairCarry(NamedTuple):
    """One pair's carried activity (device buffers)."""
    masks: tuple            # (tri_active (F2,), ni_active (Ci,),
    #                         nj_active (Cj,)) bool
    ids: torch.Tensor       # (F2,) int32: the active triangles in
    #                         increasing order, the first starts[-1]
    starts: torch.Tensor    # (tri_chunks + 1,) int32: chunk c's run is
    #                         ids[starts[c]:starts[c + 1]]
    count: torch.Tensor     # (1,) int32: starts[-1], where the gather
    #                         reads it
    tri_in: torch.Tensor    # (F2,) bool: the broad phase's range cull,
    #                         false off the list
    look: torch.Tensor      # (tri_chunks + 1,) int64: the rebuild's
    #                         look-back words, its ticket last


class ActivityCarry:
    """The carried activity of a model's pairs (``pairs``: a
    :class:`PairCarry` each; a deck's pairs are all fracture-free or
    none); ``listed``, what the step's gather reads
    (:class:`~hakai_tpu_torch.ops.gather_cuda.Listed`); ``flags``: int32
    [deletions seen by the erosion launch's blocks, its blocks done, 1 if
    the last step deleted an element (kernel E writes it) or'ed with 2 at
    the chunk's entry]; the erosion kernel leaves the first two zero;
    ``stats``: int32 [rebuilds after a deletion, listed at this rebuild,
    most listed at a rebuild]; ``slots``, the pairs' triangle slots."""

    def __init__(self, model: LoweredModel):
        dev = model.device

        def zeros(n, dtype=torch.int32):
            return torch.zeros(n, dtype=dtype, device=dev)
        self.slots = sum(p.tri_nodes.shape[1] for p in model.pairs)
        ids, counts = zeros(self.slots), zeros(len(model.pairs))
        pairs, rows, whole, pos, off = [], [], [], [], 0
        for i, (p, sl) in enumerate(zip(model.pairs, model.ckin_slices)):
            (a0, _), (a1, _), (a2, _), (cs, ce), (js, je) = sl
            whole.append(torch.arange(cs, ce))
            pos.append(torch.arange(js, je))
            F2 = p.tri_nodes.shape[1]
            pairs.append(PairCarry(
                masks=tuple(zeros(n, torch.bool) for n in
                            (F2, p.cand_nodes.shape[0],
                             p.jnode_nodes.shape[0])),
                ids=ids[off:off + F2], starts=zeros(p.tri_chunks + 1),
                count=counts[i:i + 1], tri_in=zeros(F2, torch.bool),
                look=zeros(p.tri_chunks + 1, torch.int64)))
            rows.append([off, a0, a1, a2])
            off += F2
        self.pairs = tuple(pairs)
        dense = torch.cat(whole + pos)
        self.listed = Listed(
            dense.to(device=dev, dtype=torch.int32),
            int(sum(map(len, whole))),
            torch.tensor(rows, dtype=torch.int32, device=dev),
            ids, counts, len(dense) + 3 * self.slots)
        self.flags = zeros(3)
        self.stats = zeros(3)


class _Held(dict):
    """The carry a model object holds; pickles and deep-copies as empty
    (its buffers belong to this process)."""

    def __reduce__(self):
        return _Held, ()


def carries_activity(model: LoweredModel) -> bool:
    """Whether a chunk of ``model`` carries activity masks: JAX's
    ``_init_activity`` rule (contact pairs, fracture on, the pairs' masks
    depend on the life mask; the lowering culls every pair of a
    fracture-free deck alike)."""
    return (bool(model.pairs) and model.fracture_enabled
            and not any(p.static_activity for p in model.pairs))


def chunk_carry(model: LoweredModel, comm=None) -> ActivityCarry | None:
    """The carry of a single-device chunk of ``model`` (``comm`` None), the
    entry bit of its flag set so that the chunk's first step recomputes the
    masks and lists; None where the chunk carries none.  Its buffers are
    made at first use, outside any capture, and held by the model object,
    as its captured graphs are, so every chunk of the model (and every
    replay of a graph that read them) sees the same ones."""
    if comm is not None or not carries_activity(model):
        return None
    held = model.__dict__.get("_activity")
    if held is None:
        held = _Held()
        object.__setattr__(model, "_activity", held)
    if "carry" not in held:
        held["carry"] = ActivityCarry(model)
    carry = held["carry"]
    carry.flags[2:].bitwise_or_(2)
    return carry


def list_stats(model: LoweredModel):
    """(``stats``, ``slots``) of the carry that ``model`` holds: its
    counters on the device, int32 [the lists' rebuilds after a deletion
    (each chunk's first step rebuilds them too), listed at this rebuild,
    the most triangles listed at a rebuild], and its pairs' triangle
    slots; None where it holds none (no chunk of it carried activity)."""
    held = model.__dict__.get("_activity")
    carry = None if held is None else held.get("carry")
    return None if carry is None else (carry.stats, carry.slots)
