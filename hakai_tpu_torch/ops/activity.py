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
any element died into ``flags[2]``, and the next step's broad phase
(kernel A) recomputes the masks into the buffers only when it is set.  The
graphs stay static and nothing is read back.  On the CPU the plain
versions do the same with ``torch.where(changed, recomputed, kept)``.

The chunk (``solver/explicit.py``: ``eager_chunk``, ``graph_chunk``)
takes the carry from :func:`chunk_carry` and passes it to its steps, as
it binds a rank's ``comm``.  At chunk entry ``flags[2]`` is set, so the
first step recomputes: the invariant "flag clear => the masks are those
of the step's life mask" holds at every step, and the carried masks are
bitwise a per-step recompute.

Only a single-device chunk carries them.  A rank's erosion sees only its
own elements, and the flag that decides is the whole life mask's: knowing
it would cost the ranks a collective every step, so ranks (element-sharded
and halo) recompute the masks every step from the life mask they already
gather.
"""
from __future__ import annotations

import torch

from ..core.lowering import LoweredModel


class ActivityCarry:
    """The carried masks of a model's pairs (None for a fracture-free
    pair) and ``flags``: int32 [deletions seen by the erosion launch's
    blocks, its blocks done, deleted an element last step]; the erosion
    kernel leaves the first two zero."""

    def __init__(self, model: LoweredModel):
        dev = model.device
        self.masks = tuple(
            None if p.static_activity else tuple(
                torch.zeros(n, dtype=torch.bool, device=dev)
                for n in (p.tri_nodes.shape[1], p.cand_nodes.shape[0],
                          p.jnode_nodes.shape[0]))
            for p in model.pairs)
        self.flags = torch.zeros(3, dtype=torch.int32, device=dev)


class _Held(dict):
    """The carry a model object holds; pickles and deep-copies as empty
    (its buffers belong to this process)."""

    def __reduce__(self):
        return _Held, ()


def carries_activity(model: LoweredModel) -> bool:
    """Whether a chunk of ``model`` carries activity masks: JAX's
    ``_init_activity`` rule (contact pairs, fracture on, some pair's masks
    depend on the life mask)."""
    return (bool(model.pairs) and model.fracture_enabled
            and not all(p.static_activity for p in model.pairs))


def chunk_carry(model: LoweredModel, comm=None) -> ActivityCarry | None:
    """The carry of a single-device chunk of ``model`` (``comm`` None), its
    deletion flag set so that the chunk's first step recomputes the masks;
    None where the chunk carries none.  Its buffers are made at first use,
    outside any capture, and held by the model object, as its captured
    graphs are, so every chunk of the model (and every replay of a graph
    that read them) sees the same ones."""
    if comm is not None or not carries_activity(model):
        return None
    held = model.__dict__.get("_activity")
    if held is None:
        held = _Held()
        object.__setattr__(model, "_activity", held)
    if "carry" not in held:
        held["carry"] = ActivityCarry(model)
    carry = held["carry"]
    carry.flags[2].fill_(1)
    return carry
