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
  single-device formats.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from ..core.lowering import LoweredModel
from ..core.state import SimState, init_state
from ..ops.assemble_cuda import assemble_internal_force
from .dist import Rank, launch

# element-axis (last-dim sharded) fields of LoweredModel; vol_e too, which
# JAX keeps whole, so that the local view is one consistent model
_ELEM_FIELDS = ("elem", "elem_exists", "mat_id", "G_e", "lam_e",
                "has_plastic_e", "yield0_e", "coord_e", "vol_e")
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
    model on the rank's device.  With ``events`` set to a list, each
    all-gather appends a pair of CUDA events around it."""

    def __init__(self, model: LoweredModel, ctx: Rank):
        self.model = model
        self.group = ctx.group
        self.world = ctx.world
        self.flag = None        # the chunk's whole life mask, when hoisted
        self.events = None

    def all_gather(self, x):
        """The ranks' ``x`` side by side along the last axis."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        timed = self.events is not None and x.is_cuda
        if timed:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        dist.all_gather(parts, x, group=self.group)
        if timed:
            ev[1].record()
            self.events.append(ev)
        return torch.cat(parts, dim=-1)

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
                      n_steps: int) -> SimState:
    """``n_steps`` steps of a rank's shard (``make_sharded_step``): the
    packed loop when the model has ``coord_e``, else the generic step.  On
    erosion-free contact decks the whole life mask is gathered once, for
    the chunk."""
    from ..solver.explicit import run_chunk
    comm.flag = None
    if lm.pairs and not lm.fracture_enabled:
        comm.flag = comm.global_flag(state.element_flag)
    try:
        return run_chunk(lm, state, n_steps, comm)
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
    with ``profile``, rank 0 traces its loop; rank 0 returns (the whole
    final state on the CPU, its timings)."""
    from ..solver.explicit import LoopView, run_loop
    from ..utils.profiling import trace
    model, comm, lm, ls = _rank_setup(ctx, model, state)
    clock = {}
    with trace(profile if ctx.rank == 0 else None):
        final = run_loop(model, ls,
                         lambda s, n: sharded_run_chunk(comm, lm, s, n),
                         LoopView(model, lambda s: gather_state(comm, s),
                                  ctx.rank == 0),
                         verbose, write_output, clock)
    return (final.to("cpu"), clock) if ctx.rank == 0 else None


def run_sharded(model: LoweredModel, state: SimState | None, devices: int,
                device="cuda", backend: str | None = None,
                verbose: bool = True, write_output: bool = True,
                profile: str | None = None):
    """``run()`` on ``devices`` element-sharded ranks; returns (the final
    state on the CPU, rank 0's timings)."""
    _shard(model.E, 0, devices)
    return launch(run_rank, devices, device, backend, model.to("cpu"),
                  None if state is None else state.to("cpu"), verbose,
                  write_output, profile)


def _launch_counts() -> dict:
    """The kernel wrappers' launch counts in this process."""
    from ..ops.contact_cuda import narrow_phase, scatter_forces
    from ..ops.element_cuda import element_core_packed, element_update
    from ..ops.gather_cuda import gather_cols
    from ..ops.assemble_cuda import blocked_assemble
    return {f.__name__: f.launches
            for f in (element_core_packed, element_update,
                      assemble_internal_force, blocked_assemble, gather_cols,
                      narrow_phase, scatter_forces)}


def chunk_rank(ctx: Rank, jobs: list) -> list | None:
    """A worker that runs sharded chunks and measures them.  Each job is a
    dict: ``model`` (whole, on the CPU), ``state`` (whole, or None for the
    initial state), ``chunks`` (step counts run one after the other),
    optionally ``warm`` (steps run first from the same state and dropped)
    and ``trace`` (steps run after the chunks under ``torch.profiler`` on
    rank 0, dropped); with ``halo`` set the job runs node-sharded over the
    launch's ranks (``parallel.halo.halo_job``) instead of element-sharded.
    Rank 0 returns per job: the whole final state (CPU), the alive count,
    the largest contact force and host seconds after each chunk (each ends
    in a device sync), the seconds of the collectives per chunk (CUDA
    events; None on the CPU), the kernel launches of the chunks, and with
    ``trace`` the device busy microseconds, kernels per step and the host
    ops of the most time (:func:`_traced`)."""
    from .halo import halo_job
    out = []
    for job in jobs:
        if job.get("halo"):
            out.append(halo_job(ctx, job, _measured))
            continue
        model, comm, lm, ls = _rank_setup(ctx, job["model"], job.get("state"))
        out.append(_measured(
            ctx, comm, ls, job,
            lambda s, n, comm=comm, lm=lm: sharded_run_chunk(comm, lm, s, n),
            lambda s, comm=comm: gather_state(comm, s),
            lambda s, g: float(g.contact_force.abs().max())))
    return out if ctx.rank == 0 else None


def _measured(ctx: Rank, comm, ls, job: dict, run, gather, contact_max,
              after=None) -> dict:
    """``job``'s warm-up, chunks and trace on a rank: ``run(state, n)``
    steps, ``gather(state)`` is the whole state (a collective),
    ``contact_max(state, whole)`` the largest contact force, and
    ``after(state, whole)`` the state the next chunk starts from."""
    if job.get("warm"):
        run(ls, job["warm"])
    cuda = ctx.device.type == "cuda"
    before = _launch_counts()
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
            if cuda else None)
        comm.events = None
        g = gather(ls)
        rec["alive"].append(int(g.element_flag.sum()))
        rec["contact_max"].append(contact_max(ls, g))
        if after is not None:
            ls = after(ls, g)
    rec["launches"] = {k: v - before[k] for k, v in _launch_counts().items()}
    rec["state"] = g.to("cpu")
    if job.get("trace"):
        rec.update(_traced(ctx, lambda: run(ls, job["trace"]), job["trace"]))
    return rec


def _traced(ctx: Rank, steps, n: int) -> dict:
    """``steps()`` (``n`` more steps) under torch.profiler on rank 0:
    device busy us and kernels per step of rank 0's process (0 on the
    CPU), and its six host ops of the most self CPU time, as (name, us per
    step)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = ctx.device.type == "cuda"

    def go():
        steps()
        if cuda:
            torch.cuda.synchronize()
    if ctx.rank != 0:
        go()
        return {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        go()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"busy_us": sum(e.time_range.elapsed_us() for e in dev) / n,
            "kernels": len(dev) / n,
            "host_top": [(e.key, e.self_cpu_time_total / n)
                         for e in host[:6]]}
