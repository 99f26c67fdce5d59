"""Element-sharded runs over ``torch.distributed`` (the counterpart of
``hakai_tpu/parallel/sharding.py``).

Elements are sharded over the ranks in contiguous ranges of the (possibly
renumbered) element order; node state is replicated.  Each rank steps its
own elements with the port's own step functions (``run_chunk``, ``step``,
``step_fast_packed`` and ``_integrate`` of ``solver/explicit.py``, given a
:class:`ShardComm`), and:

- the assembly all-gathers every rank's qe (24, E/world) into (24, E) and
  runs the assembly kernel on the whole of it on every rank.  That is the
  JAX package's disjoint-lane ``psum`` (sharding.py:204-221) in another
  form: it moves 24*E values where the lane psum moves 3*V*N, and since
  elements are independent and the kernel's order is fixed, Q is bitwise
  the single-device port's, so the replicated integrator runs on identical
  inputs on every rank;
- contact reads the all-gathered life mask (every step on fracture decks,
  once per chunk on erosion-free ones, as JAX hoists it, :316-320) and
  deals its narrow phase out over the ranks (``ops/contact.py``);
- ``run()`` with ``devices`` launches one process per rank
  (``parallel/dist.py``); rank 0 writes what the JAX package's process 0
  writes, from :func:`gather_state`, so frames and checkpoints keep the
  single-device formats;
- a rank's chunk is ``run_chunk`` given the comm: under NCCL, whose
  collectives are kernels on the card, it replays captured CUDA graphs
  with the all-gathers inside them (the JAX package's chunk is one
  ``jit`` program per device, collectives included); under gloo and on
  the CPU it steps eagerly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

from .. import _build
from ..core.lowering import LoweredModel
from ..core.state import SimState, init_state
from ..ops.assemble_cuda import assemble_internal_force
from .dist import Rank, check_same, launch

# element-axis (last-dim sharded) fields of LoweredModel; vol_e too, which
# JAX keeps whole, so that the local view is one consistent model
_ELEM_FIELDS = ("elem", "elem_exists", "mat_id", "G_e", "lam_e",
                "has_plastic_e", "yield0_e", "coord_e", "vol_e")
# the all-gather into one tensor (torch.distributed names it
# all_gather_single from 2.12 on)
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
# element-axis fields of SimState
_STATE_ELEM_FIELDS = ("stress", "strain", "eq_ps", "yield_s", "triax",
                      "element_flag")


def _shard(E: int, rank: int, world: int) -> slice:
    if E % world:
        raise ValueError(f"E={E} not divisible by {world} ranks (set "
                         "SolverConfig.elem_pad to a multiple)")
    n = E // world
    return slice(rank * n, (rank + 1) * n)


def shard_model(model: LoweredModel, rank: int, world: int) -> LoweredModel:
    """Rank ``rank``'s local view: the element fields sliced to its range
    of elements; node fields, the incidence table and the contact tables
    whole.  The view carries no grouped plan (its assembly runs on the
    whole model, :meth:`ShardComm.assemble`)."""
    sl = _shard(model.E, rank, world)
    kw = {k: getattr(model, k)[..., sl].contiguous() for k in _ELEM_FIELDS
          if getattr(model, k) is not None}
    return dataclasses.replace(model, E=sl.stop - sl.start, plan_asm=None,
                               **kw)


def shard_state(state: SimState, rank: int, world: int) -> SimState:
    """Rank ``rank``'s slice of a whole state (node fields whole)."""
    sl = _shard(state.element_flag.shape[0], rank, world)
    return state.replace(**{k: getattr(state, k)[..., sl].contiguous()
                            for k in _STATE_ELEM_FIELDS})


class ShardComm:
    """What a rank's step needs of the other ranks.  ``model`` is the whole
    model on the rank's device.  ``capturable``: the rank's collectives can
    be captured into a CUDA graph (``Rank.capturable``), so its chunks
    replay graphs.  With ``events`` set to a list, each collective of a
    rank that cannot be captured appends a pair of CUDA events around it
    (no timing event goes into a capture; under graphs the collectives'
    share of a step is the profiler's)."""

    def __init__(self, model: LoweredModel, ctx: Rank):
        self.model = model
        self.group = ctx.group
        self.world = ctx.world
        self.capturable = ctx.capturable
        self.where = f"rank {ctx.rank} of {ctx.world}"
        self.flag = None        # the chunk's whole life mask, when hoisted
        self.events = None
        self._flag = None       # the buffer that holds the hoisted mask
        self._gathered = {}     # all_gather's buffers by (shape, dtype)

    @contextlib.contextmanager
    def timed(self, x):
        """Records a pair of CUDA events around the block into ``events``
        (when set, on a CUDA rank that steps eagerly)."""
        if self.events is None or not x.is_cuda or self.capturable:
            yield
            return
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        yield
        ev[1].record()
        self.events.append(ev)

    def all_gather(self, x):
        """The ranks' ``x`` side by side along the last axis: gathered
        rank-major into a buffer the comm keeps for x's shape and dtype
        (static under a capture), then laid out by a device copy into a
        tensor of the caller's own."""
        x = x.contiguous()
        key = (tuple(x.shape), x.dtype)
        buf = self._gathered.get(key)
        if buf is None:
            # concatenated on dim 0, the layout gloo and NCCL both take
            buf = self._gathered[key] = x.new_empty(
                (self.world * x.shape[0],) + tuple(x.shape[1:]))
        with self.timed(x):
            _all_gather_single(buf, x, group=self.group)
        out = x.new_empty(x.shape[:-1] + (self.world * x.shape[-1],))
        out.view(x.shape[:-1] + (self.world, x.shape[-1])).copy_(
            buf.view((self.world,) + tuple(x.shape)).movedim(0, -2))
        return out

    def hoist_flag(self, flag):
        """Gather the whole life mask once for a chunk (erosion-free
        contact decks, as JAX hoists it) into the buffer the comm keeps,
        which a graph's captured steps read."""
        self.flag = None
        whole = self.global_flag(flag)
        if self._flag is None:
            self._flag = torch.empty_like(whole)
        self.flag = self._flag.copy_(whole)

    def assemble(self, qe24, out_dtype):
        """Q (3, N) in ``out_dtype`` from this rank's qe (24, E/world)."""
        return assemble_internal_force(self.model, self.all_gather(qe24),
                                       out_dtype)

    def global_flag(self, flag):
        """The (E,) life mask of every rank's elements."""
        if self.flag is not None:
            return self.flag
        return self.all_gather(flag.view(torch.uint8)).view(torch.bool)

    def contact(self, model: LoweredModel, state: SimState):
        """The contact force (3, N) of a rank's step, its narrow phase dealt
        out over the ranks, on the whole life mask."""
        from ..ops.contact import contact_forces
        return contact_forces(model, state.replace(
            element_flag=self.global_flag(state.element_flag)), self.group)


def gather_state(comm: ShardComm, state: SimState) -> SimState:
    """The whole state from every rank's shard (a collective)."""
    return state.replace(**{k: comm.all_gather(getattr(state, k))
                            for k in _STATE_ELEM_FIELDS
                            if k != "element_flag"},
                         element_flag=comm.global_flag(state.element_flag))


def sharded_run_chunk(comm: ShardComm, lm: LoweredModel, state: SimState,
                      n_steps: int, chunk=None) -> SimState:
    """``n_steps`` steps of a rank's shard (``make_sharded_step``): the
    packed loop when the model has ``coord_e``, else the generic step,
    replayed from captured graphs where the comm's collectives can be
    captured (``chunk``: ``run_chunk`` by default; ``eager_chunk`` steps
    eagerly, the loop the graphs are held to).  On erosion-free contact
    decks the whole life mask is gathered once, for the chunk."""
    from ..solver.explicit import run_chunk
    comm.flag = None
    if lm.pairs and not lm.fracture_enabled:
        comm.hoist_flag(state.element_flag)
    try:
        return (chunk or run_chunk)(lm, state, n_steps, comm)
    finally:
        comm.flag = None


def _rank_setup(ctx: Rank, model: LoweredModel, state: SimState | None):
    """(whole model, comm, local view, local state) on the rank's device."""
    model = model.to(ctx.device)
    state = init_state(model) if state is None else state.to(ctx.device)
    comm = ShardComm(model, ctx)
    return (model, comm, shard_model(model, ctx.rank, ctx.world),
            shard_state(state, ctx.rank, ctx.world))


def run_rank(ctx: Rank, model: LoweredModel, state: SimState | None,
             verbose: bool, write_output: bool, profile: str | None = None):
    """One rank of ``run(devices=n)``: the host loop on the rank's shard;
    rank 0 writes and, with ``profile``, traces its loop; each process's
    local rank 0 returns (the whole final state on the CPU, its
    timings)."""
    from ..solver.explicit import LoopView, run_loop
    from ..utils.profiling import trace
    check_same(ctx, "model", model)
    model, comm, lm, ls = _rank_setup(ctx, model, state)
    clock = {}
    with trace(profile if ctx.rank == 0 else None):
        final = run_loop(model, ls,
                         lambda s, n: sharded_run_chunk(comm, lm, s, n),
                         LoopView(model, lambda s: gather_state(comm, s),
                                  ctx.rank == 0),
                         verbose, write_output, clock)
    return (final.to("cpu"), clock) if ctx.local_rank == 0 else None


def run_sharded(model: LoweredModel, state: SimState | None, devices: int,
                device="cuda", backend: str | None = None,
                verbose: bool = True, write_output: bool = True,
                profile: str | None = None):
    """``run()`` on ``devices`` element-sharded ranks, spread over the
    run's processes (``parallel.dist``); returns (the final state on the
    CPU, this process's local rank 0's timings)."""
    _shard(model.E, 0, devices)
    return launch(run_rank, devices, device, backend, model.to("cpu"),
                  None if state is None else state.to("cpu"), verbose,
                  write_output, profile)


def chunk_rank(ctx: Rank, jobs: list) -> list | None:
    """A worker that runs sharded chunks and measures them.  Each job is a
    dict: ``model`` (whole, on the CPU), ``state`` (whole, or None for the
    initial state), ``chunks`` (step counts run one after the other),
    optionally ``warm`` (steps run first from the same state and dropped),
    ``trace`` (steps run after the chunks under ``torch.profiler`` on
    rank 0, dropped) and ``eager`` (the rank's eager loop, where it would
    replay graphs); with ``halo`` set the job runs node-sharded over the
    launch's ranks (``parallel.halo.halo_job``) instead of element-sharded.
    Rank 0 returns per job: the whole final state (CPU), the alive count,
    the largest contact force and host seconds after each chunk (each ends
    in a device sync), the seconds of the collectives per chunk (CUDA
    events; None on the CPU and under NCCL, where ``trace`` gives the NCCL
    kernels' time), the kernel launches of the chunks by C entry, the
    captured graphs (:func:`captures`), and with ``trace`` the device busy
    microseconds, kernels and NCCL kernel microseconds per step and the
    host ops of the most time (:func:`_traced`)."""
    from ..solver.explicit import eager_chunk
    from .halo import halo_job
    out = []
    for job in jobs:
        if job.get("halo"):
            out.append(halo_job(ctx, job, _measured))
            continue
        model, comm, lm, ls = _rank_setup(ctx, job["model"], job.get("state"))
        chunk = eager_chunk if job.get("eager") else None
        out.append(_measured(
            ctx, comm, ls, job,
            lambda s, n, comm=comm, lm=lm, chunk=chunk: sharded_run_chunk(
                comm, lm, s, n, chunk),
            lambda s, comm=comm: gather_state(comm, s),
            lambda s, g: float(g.contact_force.abs().max()), lm))
    return out if ctx.rank == 0 else None


def captures(model) -> dict:
    """The graphs captured of ``model``'s chunk loops: per loop and length,
    (capture s, instantiate s, graph pool bytes)."""
    return {loop: {n: (c.capture_s, c.instantiate_s, c.pool_bytes)
                   for n, c in g.graphs.items()}
            for loop, g in model.__dict__.get("_chunk_graphs", {}).items()}


def _measured(ctx: Rank, comm, ls, job: dict, run, gather, contact_max,
              model, after=None) -> dict:
    """``job``'s warm-up, chunks and trace on a rank: ``run(state, n)``
    steps, ``gather(state)`` is the whole state (a collective),
    ``contact_max(state, whole)`` the largest contact force, ``model`` the
    model view whose graphs the chunks replay, and ``after(state, whole)``
    the state the next chunk starts from."""
    if job.get("warm"):
        run(ls, job["warm"])
    cuda = ctx.device.type == "cuda"
    timed = cuda and not comm.capturable
    before = _build.LAUNCHES.copy()
    rec = {"alive": [], "contact_max": [], "seconds": [], "collective_s": []}
    for n in job["chunks"]:
        comm.events = []
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ls = run(ls, n)
        int(ls.t)
        rec["seconds"].append(time.perf_counter() - t0)
        rec["collective_s"].append(
            sum(a.elapsed_time(b) for a, b in comm.events) / 1e3
            if timed else None)
        comm.events = None
        g = gather(ls)
        rec["alive"].append(int(g.element_flag.sum()))
        rec["contact_max"].append(contact_max(ls, g))
        if after is not None:
            ls = after(ls, g)
    rec["launches"] = _build.LAUNCHES - before
    rec["state"] = g.to("cpu")
    rec["captures"] = captures(model)
    if job.get("trace"):
        rec.update(_traced(ctx, lambda: run(ls, job["trace"]), job["trace"]))
    return rec


def _traced(ctx: Rank, steps, n: int) -> dict:
    """``steps()`` (``n`` more steps) untraced, their host us per step on
    rank 0, then again under torch.profiler on rank 0:
    device busy us, kernels and copies, and the NCCL kernels' us per step
    of rank 0's process (0 on the CPU; one NCCL rank launches no kernel,
    its collectives are device copies), the device ranges of its NCCL
    ops (eager steps only: a graph replay has no host op), and its six
    host ops of the most self CPU time, as (name, us per step)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = ctx.device.type == "cuda"

    def go():
        steps()
        if cuda:
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    go()                        # the same steps untraced, on every rank
    wall = (time.perf_counter() - t0) / n * 1e6
    if ctx.rank != 0:
        go()
        return {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        go()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    # the device ranges of annotated host ops (c10d's "nccl:<op>", eager
    # only) overlap the kernels and copies they hold
    ranges = [e for e in dev if getattr(e, "is_user_annotation", False)]
    dev = [e for e in dev if not getattr(e, "is_user_annotation", False)]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)

    def us(events):
        return sum(e.time_range.elapsed_us() for e in events) / n
    return {"busy_us": us(dev), "wall_us": wall, "kernels": len(dev) / n,
            "nccl_us": us(e for e in dev if "nccl" in e.name.lower()),
            "nccl_ranges_us": us(e for e in ranges
                                 if e.name.startswith("nccl")),
            "host_top": [(e.key, e.self_cpu_time_total / n)
                         for e in host[:6]]}
