"""The chunk loop as captured CUDA graphs: the port's counterpart of the
JAX package's compiled ``run_chunk`` (``jax.jit`` over
``jax.lax.fori_loop``, ``hakai_tpu/solver/explicit.py:326-400``), in which
a chunk of n steps is one device program and the host takes no part in
the steps.

A step's kernels, and the plain PyTorch ops around them, launch on the
current stream with static shapes and read nothing back to the host, so
``GRAPH_STEPS`` consecutive steps are captured once into a
``torch.cuda.CUDAGraph`` over static input buffers (the state's tensors
and, on the packed loop, the packed Gauss state ``P``) and replayed.  A
chunk of n steps copies its input into those buffers, replays the
``GRAPH_STEPS``-step graph ``n // GRAPH_STEPS`` times and a graph of the
remaining ``n % GRAPH_STEPS`` steps once, and copies the buffers out.
Each length is captured the first time it appears, as ``jit`` compiles
once per static ``n_steps``; the graphs of one model and loop live in a
:class:`ChunkGraphs` held by the model object, and die with it.  The
process's captures, their host seconds and its replays add up in
:func:`totals`; a chunk's copy-in, captures, replays and copy-out are the
spans ``hakai.chunk.load``, ``hakai.graph.capture`` (with
``hakai.graph.warm_up`` and ``hakai.graph.instantiate``),
``hakai.graph.replay`` and ``hakai.chunk.unload``
(``utils/profiling.py``).

A replay runs the captured kernels with the captured launch shapes in
the captured order, so a chunk's state equals the eager loop's
(``solver/explicit.eager_chunk``) bit for bit.  Each graph ends by
writing its last step's state into the static buffers, so consecutive
replays need no copy between them.  Launch counts
(``_build.LAUNCHES``, by C entry): the kernel wrappers run only while a
graph is captured; a replay adds the launches its capture made, so the
counts say what ran on the card.

A rank whose collectives can be captured (NCCL, ``Rank.capturable``)
replays graphs of its own steps, collectives included, as the JAX
package's multi-device chunk is one ``jit(shard_map(...))`` program per
device: its step function is bound to its comm, and the graphs live on
its local model view, a new object per launch.  Gloo ranks and the CPU
run the eager loop (``solver/explicit.uses_graphs`` decides, from the
backend and device alone).

Nothing falls back: a failed warm-up, capture or replay raises, with a
note naming the rank, the step and the loop.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import NamedTuple

import torch

from .. import _build
from ..core.lowering import LoweredModel
from ..core.state import SimState
from ..utils.profiling import span

# steps a replay advances (K): chosen on the H100 from the step times of
# K = 1, 8 and 32 on [main] and [contact] (PERF.md, section 5)
GRAPH_STEPS = 32

# graphs captured in this process, the host seconds of their warm-up,
# capture and instantiation, and graph replays (read through totals())
_TOTALS = {"captures": 0, "capture_s": 0.0, "replays": 0}


def split(n_steps: int, k: int = GRAPH_STEPS) -> tuple[int, int]:
    """(replays of the k-step graph, steps of the remainder graph) of an
    n-step chunk."""
    if k < 1 or n_steps < 0:
        raise ValueError(f"a chunk of {n_steps} steps in graphs of {k}")
    return divmod(n_steps, k)


def totals() -> dict:
    """This process's graph captures (``captures``, ``capture_s``: host
    seconds of warm-up, capture and instantiation) and graph replays
    (``replays``) so far."""
    return dict(_TOTALS)


def leaves(carry) -> list:
    """The tensors of a carry ``(state, *tensors)`` (a :class:`SimState`,
    or a halo rank's ``HaloState``), in field order."""
    state, *extra = carry
    return [getattr(state, f.name) for f in dataclasses.fields(state)] + \
        list(extra)


def rebuild(carry, tensors) -> tuple:
    """A carry shaped like ``carry`` from :func:`leaves`-ordered
    ``tensors``."""
    names = [f.name for f in dataclasses.fields(carry[0])]
    return (type(carry[0])(**dict(zip(names, tensors))),
            *tensors[len(names):])


def write_back(static: list, out: list) -> None:
    """``static[i] <- out[i]`` for every leaf, reading every output before
    writing any buffer: an output that is a buffer of another field (a
    one-step graph's ``disp_pre`` is its input ``disp``) or a view of one
    is copied first.  An output that is its own buffer (a field the steps
    pass through) stays."""
    held = {s.untyped_storage().data_ptr() for s in static}
    out = [o if o is s or o.untyped_storage().data_ptr() not in held
           else o.clone() for s, o in zip(static, out)]
    for s, o in zip(static, out):
        if o is not s:
            s.copy_(o)


class Captured(NamedTuple):
    """One captured length: its graph (anything with ``replay()``), the
    kernel launches of one replay by C entry, and what the capture took:
    host seconds to capture and to instantiate, and the bytes the graph
    pool grew by."""
    graph: object
    launches: collections.Counter
    capture_s: float
    instantiate_s: float
    pool_bytes: int


class ChunkGraphs:
    """The captured graphs of one model's chunk loop (``loop``: "packed" or
    "generic", or a halo rank's), each length captured once, over one set
    of static buffers and one memory pool.  ``step_fn(model, state,
    *extra)`` is one step of the loop, returning ``(state, *extra)``; on a
    rank it is bound to the rank's comm, and ``where`` names the rank.
    The model holds this object and passes itself to every call (no
    reference back to it, so the graphs die with the model as soon as it
    is dropped).

    The graphs share the pool safely: each replays alone, in stream
    order, and leaves nothing in the pool that a later replay reads (its
    result is in the static buffers, which lie outside the pool).  The
    comm's buffers (gathered rows, ring buffers, the hoisted life mask)
    are static too: kept by the comm, made outside any capture."""

    def __init__(self, loop: str, step_fn, where: str = ""):
        self.loop, self.step_fn = loop, step_fn
        self.what = f"the {loop} loop" + (f" on {where}" if where else "")
        self.static = None        # the carry the graphs read and write
        self.graphs: dict[int, Captured] = {}
        self.pool = None
        self.warm = False

    def advance(self, model: LoweredModel, state: SimState, n_steps: int,
                k: int = GRAPH_STEPS, enter=None, leave=None):
        """The carry ``(state, *extra)`` after ``n_steps`` steps:
        ``split(n_steps, k)`` replays of the k-step graph, then the
        remainder's.  ``enter(state)`` gives ``extra`` (default: none); the
        carry returned is a copy of the static buffers, which the next
        chunk overwrites, or with ``leave`` what ``leave(*carry)``
        returns.  The copy in with ``enter`` is the span
        ``hakai.chunk.load``, the copy out with ``leave``
        ``hakai.chunk.unload``."""
        q, r = split(n_steps, k)
        with span("hakai.chunk.load"):
            self._load((state, *(enter(state) if enter else ())))
        for length, times in ((k, q), (r, 1)):
            if length and times:
                self._replay(model, length, times)
        with span("hakai.chunk.unload"):
            out = rebuild(self.static,
                          [x.clone() for x in leaves(self.static)])
            return leave(*out) if leave else out

    def _load(self, carry) -> None:
        """Copy ``carry`` into the static buffers (made at first use)."""
        new = leaves(carry)
        if self.static is None:
            self.static = rebuild(carry, [torch.empty_like(x) for x in new])
        for s, x in zip(leaves(self.static), new):
            if (s.shape, s.dtype, s.device) != (x.shape, x.dtype, x.device):
                raise ValueError(
                    f"the {self.loop} loop's graphs take {tuple(s.shape)} "
                    f"{s.dtype} on {s.device}, not {tuple(x.shape)} "
                    f"{x.dtype} on {x.device}")
            s.copy_(x)

    def _replay(self, model: LoweredModel, length: int, times: int) -> None:
        g = self.graphs.get(length)
        if g is None:
            t0 = time.perf_counter()
            with span("hakai.graph.capture", steps=length):
                g = self.graphs[length] = self._capture(model, length)
            _TOTALS["captures"] += 1
            _TOTALS["capture_s"] += time.perf_counter() - t0
        with span("hakai.graph.replay", steps=length, times=times):
            for j in range(times):
                try:
                    g.graph.replay()
                except RuntimeError as e:
                    e.add_note(f"replaying steps {j * length + 1}-"
                               f"{(j + 1) * length} of the chunk ({length}-"
                               f"step graph of {self.what})")
                    raise
        _TOTALS["replays"] += times
        for entry, n in g.launches.items():
            _build.LAUNCHES[entry] += times * n

    def _steps(self, model: LoweredModel, length: int, what: str):
        carry = self.static
        for i in range(length):
            try:
                carry = self.step_fn(model, *carry)
            except Exception as e:
                e.add_note(f"in step {i + 1} of {length} of {what}")
                raise
        return carry

    def _warm_up(self, model: LoweredModel) -> None:
        """One eager step from the static buffers on a side stream, its
        result dropped, as PyTorch's CUDA-graph recipe warms up.  It does
        outside any capture what a step does at first use: the kernel
        library's build and each kernel's first launch, the allocator's
        first blocks, the workspaces of the narrow phase, the broad phase
        and the energy sums (their counters are left zero by every call)
        and the element kernel's shape-gradient table,
        a synchronous ``cudaMemcpyToSymbol`` that no capture may hold; on a
        rank also every collective of the step once (NCCL forms its
        communicator at the first collective, which no capture may hold)
        and the comm's buffers.  The table is global per device, so every
        model's graphs replay the one table: sound while it is
        model-independent, as ``pusai_hexa(8)`` is."""
        dev = model.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._steps(model, 1, f"the warm-up of {self.what}")
        torch.cuda.current_stream(dev).wait_stream(side)
        self.warm = True

    def _capture(self, model: LoweredModel, length: int) -> Captured:
        """Capture ``length`` steps from the static buffers back into them.
        The launch counts are restored afterwards: neither the warm-up nor
        the capture launches a kernel of the chunk."""
        before = _build.LAUNCHES.copy()
        try:
            with torch.cuda.device(model.device):
                if not self.warm:
                    with span("hakai.graph.warm_up"):
                        self._warm_up(model)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
                if self.pool is None:
                    self.pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                mark = _build.LAUNCHES.copy()
                t0 = time.perf_counter()
                with torch.cuda.graph(graph, pool=self.pool):
                    out = self._steps(model, length, f"the {length}-step "
                                      f"capture of {self.what}")
                    write_back(leaves(self.static), leaves(out))
                    del out
                t1 = time.perf_counter()
                launches = _build.LAUNCHES - mark
                with span("hakai.graph.instantiate"):
                    graph.instantiate()
                    torch.cuda.synchronize()
                t2 = time.perf_counter()
                pool = torch.cuda.memory_reserved() - reserved
        finally:
            _build.LAUNCHES.clear()
            _build.LAUNCHES.update(before)
        return Captured(graph, launches, t1 - t0, t2 - t1, pool)


class _Cache(dict):
    """A model's :class:`ChunkGraphs` by loop.  It pickles and deep-copies
    as empty: graphs hold this process's device pointers (a model sent to
    a spawned rank captures its own, or none)."""

    def __reduce__(self):
        return _Cache, ()


def chunk_graphs(model: LoweredModel, loop: str, step_fn,
                 where: str = "") -> ChunkGraphs:
    """The model's graphs of ``loop``, kept in an attribute of the model
    object, not in a dataclass field: a model made by
    ``dataclasses.replace`` (or ``model.to``), whose tensors may differ,
    starts with no graphs.  A rank's model is its local view, which
    belongs to one comm (``where`` names the rank)."""
    cache = model.__dict__.get("_chunk_graphs")
    if cache is None:
        cache = _Cache()
        object.__setattr__(model, "_chunk_graphs", cache)
    if loop not in cache:
        cache[loop] = ChunkGraphs(loop, step_fn, where)
    return cache[loop]
