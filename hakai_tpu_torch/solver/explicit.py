"""Explicit central-difference time integration (mirrors the generic
``step()``, the packed chunk loop and ``run()`` of
``hakai_tpu/solver/explicit.py``).

A step is five things: on contact decks the contact force (kernel A's
activity masks and broad phase, then the gather, narrow-phase and scatter
kernels), the central-difference update with amplitude-scaled boundary
conditions (kernel I), the fused element kernel, the assembly kernel, and
on fracture decks the erosion walk (kernel E).  On the CPU each kernel's
plain version runs.  The step counter and the current time stay on the
device: nothing in a chunk reads a value back to the host.  A
single-device chunk carries the contact activity masks from step to step,
recomputing them after a deletion (``ops/activity.py``), as the JAX chunk
loop does.

``run_chunk`` picks the loop as the JAX package does: the packed loop on
models that carry ``coord_e`` (the lowering forms it on meshes of 2,048
elements and nodes and more, unless ``gather_mode="xla"``), else the
generic :func:`step`, which keeps the unpacked state, zeroes a dead
element's stress and strain every step and reports its triaxiality from
the trial stress.  ``run()`` drives chunks from the host and writes VTK
frames, checkpoints and metrics between them, on one device or, with
``devices``, on element-sharded ranks (``parallel/sharding.py``), whose
steps are these same functions given a ``comm``.  On a CUDA device a
chunk replays captured CUDA graphs of its steps (``solver/graph.py``),
alone or on a rank whose collectives can be captured (NCCL).
"""
from __future__ import annotations

import contextlib
import functools
import sys
import time as _time

import numpy as np
import torch

from ..core.lowering import LoweredModel
from ..core.state import SimState, init_state
from ..io.vtk import write_pvd, write_vtk
from ..ops.assemble_cuda import assemble_internal_force
from ..ops.activity import chunk_carry, list_stats
from ..ops.contact import contact_forces
from ..ops.element import triax_components
from ..ops.element_cuda import element_update, packed_element_step
from ..ops.erosion import erode
from ..ops.integrate_cuda import central_difference
from ..utils.checkpoint import save_checkpoint
from ..utils.metrics import MetricsWriter, energy_guard, step_metrics
from ..utils.profiling import IDS, simulation, span
from .graph import GRAPH_STEPS, chunk_graphs, totals
from .output import node_fields


def _integrate(model: LoweredModel, state: SimState, comm=None,
               carry=None, element_inputs: bool = False):
    """Contact + central difference + BCs.  Returns (update, cforce): the
    :class:`~hakai_tpu_torch.ops.integrate.Update` (t, disp_new, velo,
    dwork, the [dW_ext, dW_int] increment pair or None unless
    ``config.energy_check``, and with ``element_inputs`` the element
    kernel's position and d_disp in the element dtype) and the step's
    contact force (None on decks without contact).  The update is kernel I
    on the card (``ops/integrate_cuda.py``), its plain version on the CPU.

    ``comm`` (a :class:`~hakai_tpu_torch.parallel.sharding.ShardComm` or
    :class:`~hakai_tpu_torch.parallel.halo.HaloComm`) makes this a rank's
    step: its ``contact`` reads the life mask of every rank's elements and
    deals the narrow phase out over the ranks, recomputing the activity
    masks every step.  On a halo rank ``model`` and ``state`` hold the
    rank's own node rows.  On one device ``carry``, a chunk's
    :class:`~hakai_tpu_torch.ops.activity.ActivityCarry`, holds the masks
    from step to step, as the JAX chunk loop carries them; without one
    every step recomputes them."""
    cforce = None
    if model.pairs:
        cforce = (contact_forces(model, state, carry=carry)
                  if comm is None else comm.contact(model, state))
    return central_difference(model, state, cforce, element_inputs), cforce


def _assemble(model: LoweredModel, qe24, comm):
    """Q in the nodal dtype from this rank's qe (24, E)."""
    if comm is None:
        return assemble_internal_force(model, qe24, out_dtype=model.dtype)
    return comm.assemble(qe24, model.dtype)


def _finish(model: LoweredModel, state: SimState, u, cforce, res, triax,
            comm=None, carry=None) -> SimState:
    """Assembly, erosion and the state swap of the generic step after the
    update ``u``.  ``triax`` is the element kernel's, of the final stress;
    on fracture decks ``erode`` walks the table on it and zeroes every dead
    element's stress and strain (and sets ``carry``'s deletion flag)."""
    Q = _assemble(model, res.Qe.reshape(24, model.E), comm)
    flag = state.element_flag
    stress, strain = res.stress, res.strain
    if model.fracture_enabled:
        er = erode(model, stress, strain, res.eq_ps, triax, flag, carry)
        flag, stress, strain = er.element_flag, er.stress, er.strain
    return state.replace(
        t=u.t, disp=u.disp_new, disp_pre=state.disp, velo=u.velo, Q=Q,
        stress=stress, strain=strain, eq_ps=res.eq_ps, yield_s=res.yield_s,
        triax=triax, element_flag=flag,
        contact_force=state.contact_force if cforce is None else cforce,
        work=state.work if u.dwork is None else state.work + u.dwork)


def step(model: LoweredModel, state: SimState, comm=None,
         carry=None) -> SimState:
    """One generic step on the unpacked state.  The new position
    ``coord + disp`` and the increment ``disp_new - disp`` are formed in the
    nodal dtype and cast to the element dtype before the element kernel
    gathers them (in mixed mode its math, centring included, is float32).
    With ``comm``, ``model`` and ``state`` are a rank's element shard
    (:mod:`hakai_tpu_torch.parallel.sharding`); ``carry`` is a
    single-device chunk's activity carry (see :func:`_integrate`)."""
    u, cforce = _integrate(model, state, comm, carry, element_inputs=True)
    res, triax = element_update(
        model, u.position, u.d_disp, state.stress, state.strain,
        state.eq_ps, state.yield_s, state.element_flag, want_triax=True)
    return _finish(model, state, u, cforce, res, triax, comm, carry)


def step_fast_packed(model: LoweredModel, state: SimState, P, comm=None,
                     carry=None):
    """One step on the packed Gauss state ``P`` (72, E): returns the new
    state (its stress fields stale until :func:`unpack_gauss_state`) and
    the new P.

    Serves every precision: the element kernel gathers the nodal disp and
    previous disp itself and, in mixed mode, differences them in float64
    before the float32 math, so no (3, 8, E) element copy of either is
    formed or carried (the JAX package's ``step_fast_packed`` carries one;
    its ``step_fast_packed_fused`` does not).  In mixed mode the float32
    force sum is stored as float64.  On fracture decks the triaxiality is
    the kernel's, masked by the pre-erosion flag, and the flag is the
    post-erosion one; dead elements keep stale stress in ``P`` until the
    chunk exit.  ``comm`` and ``carry`` as for :func:`step`."""
    u, cforce = _integrate(model, state, comm, carry)
    P_new, qe, triax, flag = packed_element_step(
        model, P, state.element_flag, u.disp_new, state.disp, carry)
    Q = _assemble(model, qe, comm)
    work = state.work if u.dwork is None else state.work + u.dwork
    return state.replace(
        t=u.t, disp=u.disp_new, disp_pre=state.disp, velo=u.velo, Q=Q,
        triax=state.triax if triax is None else triax, element_flag=flag,
        contact_force=state.contact_force if cforce is None else cforce,
        work=work), P_new


def pack_gauss_state(state: SimState):
    """(72, E) packed Gauss state: stress 0:48, GP-mean strain 48:54, zero
    pad 54:56, eq_ps 56:64, yield 64:72."""
    E = state.eq_ps.shape[1]
    return torch.cat([state.stress.reshape(48, E), state.strain,
                      state.strain.new_zeros((2, E)), state.eq_ps,
                      state.yield_s])


def unpack_gauss_state(state: SimState, P) -> SimState:
    E = P.shape[1]
    return state.replace(stress=P[:48].reshape(6, 8, E), strain=P[48:54],
                         eq_ps=P[56:64], yield_s=P[64:72])


def run_chunk(model: LoweredModel, state: SimState, n_steps: int,
              comm=None) -> SimState:
    """Advance ``n_steps`` steps: the generic :func:`step` when the model
    has no ``coord_e``, else the packed loop.  In the packed loop dead
    elements keep stale stress inside the chunk and are zeroed once at its
    exit; on fracture-free decks the triaxiality is formed once at exit
    from the final stress, on fracture decks it is the last step's (the
    erosion walk needs it every step).

    Where :func:`uses_graphs` says so the steps replay captured CUDA
    graphs (:func:`graph_chunk`), as the JAX package runs a chunk as one
    compiled program, collectives included; else they run eagerly
    (:func:`eager_chunk`).  The two give the same bits.  With ``comm``,
    ``model`` and ``state`` are a rank's element shard (every per-element
    act of the chunk, its exit included, stays on the rank's elements).
    The state returned is the caller's: no later chunk changes it."""
    if uses_graphs(state.disp.device, comm):
        return graph_chunk(model, state, n_steps, comm=comm)
    return eager_chunk(model, state, n_steps, comm)


def uses_graphs(device, comm=None) -> bool:
    """Whether a chunk on ``device`` replays captured CUDA graphs: on a
    CUDA device, alone or on a rank whose collectives can be captured
    (``comm.capturable``: NCCL's are kernels on the card).  Gloo ranks,
    whose collectives run on the host, and the CPU, which has no graphs,
    step eagerly: a consequence of the backend and device, not a
    fallback."""
    return torch.device(device).type == "cuda" and (
        comm is None or comm.capturable)


def eager_chunk(model: LoweredModel, state: SimState, n_steps: int,
                comm=None) -> SimState:
    """:func:`run_chunk`'s loop with every op launched from the host."""
    carry = chunk_carry(model, comm)
    if model.coord_e is None:
        for _ in range(n_steps):
            state = step(model, state, comm, carry)
        return state
    P = pack_gauss_state(state)
    for _ in range(n_steps):
        state, P = step_fast_packed(model, state, P, comm, carry)
    return finish_packed(model, state, P)


def _generic_step(model: LoweredModel, state: SimState, comm=None,
                  carry=None):
    return (step(model, state, comm, carry),)


def graph_chunk(model: LoweredModel, state: SimState, n_steps: int,
                k: int = GRAPH_STEPS, comm=None) -> SimState:
    """:func:`run_chunk` on a CUDA device: the chunk's steps replay the
    model's captured graphs of ``k`` steps and of the remainder
    (:mod:`hakai_tpu_torch.solver.graph`); the packed loop's entry and
    exit run eagerly, once a chunk, around them.  With ``comm`` (a rank
    whose collectives can be captured) the steps are the rank's, bound to
    its comm, and ``model`` is its local view, which holds the graphs."""
    where = comm.where if comm is not None else ""
    carry = chunk_carry(model, comm)
    if model.coord_e is None:
        return chunk_graphs(model, "generic", functools.partial(
            _generic_step, comm=comm, carry=carry), where).advance(
                model, state, n_steps, k)[0]
    return chunk_graphs(model, "packed", functools.partial(
        step_fast_packed, comm=comm, carry=carry), where).advance(
            model, state, n_steps, k,
            enter=lambda s: (pack_gauss_state(s),),
            leave=functools.partial(finish_packed, model))


def finish_packed(model: LoweredModel, state, P):
    """The packed loop's exit: dead elements' stress and strain zeroed
    (deferred from the steps), on fracture-free decks the triaxiality
    formed from the final stress, and the state unpacked."""
    P = torch.cat([torch.where(state.element_flag[None, :], P[:56], 0.0),
                   P[56:]])
    if not model.fracture_enabled:
        state = state.replace(triax=triax_components(
            [P[8 * c:8 * (c + 1)] for c in range(6)]))
    return unpack_gauss_state(state, P)


def _numpy(x):
    return x.detach().cpu().numpy()


def _deck_order_frame(model: LoweredModel, disp, velo, flag, nd):
    """Map internal (possibly RCM-renumbered) arrays back to the deck's
    node and element order for output, as NumPy arrays."""
    nN, nE = model.n_node, model.n_element
    coord, elem, flag = _numpy(model.coord), _numpy(model.elem), _numpy(flag)
    disp, velo = _numpy(disp), _numpy(velo)
    nd_np = type(nd)(*[_numpy(x) for x in nd])
    if model.node_new2old is None:
        return coord, elem, flag, disp, velo, nd_np
    n2o = _numpy(model.node_new2old)
    e2o = _numpy(model.elem_new2old)

    def nodes_back(a):
        out = np.zeros(a.shape, a.dtype)
        out[..., n2o] = a[..., :nN]
        return out

    elem_o = np.zeros_like(elem)
    elem_o[:, e2o] = n2o[elem[:, :nE]]
    flag_o = np.zeros_like(flag)
    flag_o[e2o] = flag[:nE]
    return (nodes_back(coord), elem_o, flag_o, nodes_back(disp),
            nodes_back(velo), type(nd)(*[nodes_back(x) for x in nd_np]))


def run(model: LoweredModel, state: SimState | None = None,
        verbose: bool = True, write_output: bool = True,
        devices: int | None = None, halo: int | None = None,
        resume_halo: str | None = None, device="cuda",
        timings: dict | None = None,
        dist_backend: str | None = None,
        profile: str | None = None) -> SimState:
    """Whole simulation: ``time_num`` steps in chunks of
    ``time_num // output_num``, a VTK frame after each chunk (and frame 0
    before the first) plus ``collection.pvd``, a checkpoint every
    ``checkpoint_every`` frames, the metrics JSONL when ``metrics_path`` is
    set, the NaN and energy-balance guards, and an "Element deleted" line
    when the alive count changes.  A ``state`` whose ``t > 0`` resumes
    (frames continue from its step).

    Runs on ``device`` (default: the current GPU; pass ``device="cpu"`` for
    the plain versions); the model and state are moved there.
    ``devices=n`` with n > 1 runs the element-sharded loop on ``n`` ranks
    over ``torch.distributed``
    (:func:`hakai_tpu_torch.parallel.sharding.run_sharded`); ``halo=n``
    with n > 1 runs the node-sharded halo decomposition on ``n`` ranks
    instead, and wins over ``devices``, as in the JAX package
    (:func:`hakai_tpu_torch.parallel.halo.run_halo`; its checkpoints are
    shard-major, and ``resume_halo`` names one to resume from).  Backend
    ``dist_backend``, default NCCL on CUDA and gloo on the CPU; with one
    device it is unused, as no collective runs.  On ranks, rank 0 writes
    the frames, metrics and console lines, and checkpoints (a halo run
    with several processes writes one file a process), and the whole final
    state is returned, on ``device``.  After
    :func:`hakai_tpu_torch.parallel.dist.initialize` every process of the
    run calls ``run()`` alike: the ranks spread over the processes, every
    process gets the final state, and only process 0 writes (as the JAX
    package's ``proc0`` gate).  With ``profile``, a torch.profiler
    trace of the run's loop (on ranks, rank 0's) goes to
    ``<profile>/trace.json``, its ``hakai.*`` spans
    (``utils/profiling.py``) naming what the host did.  With a ``timings``
    dict, fills in :func:`run_loop`'s counters (on ranks, this process's
    local rank 0's).  Returns the final state."""
    from ..utils.profiling import trace
    if (halo or 1) > 1:
        from ..parallel.halo import run_halo
        state, clock = run_halo(model, state, halo, device, dist_backend,
                                verbose, write_output, resume_halo, profile)
    elif resume_halo is not None:
        raise ValueError("resume_halo resumes a halo run: pass halo > 1")
    elif (devices or 1) > 1:
        from ..parallel.sharding import run_sharded
        state, clock = run_sharded(model, state, devices, device,
                                   dist_backend, verbose, write_output,
                                   profile)
    else:
        from ..parallel.dist import process_index
        with trace(profile), simulation(), span("hakai.run"):
            with span("hakai.run.enter"):
                model = model.to(device)
                state = init_state(model) if state is None \
                    else state.to(device)
            return run_loop(model, state, lambda s, n: run_chunk(model, s, n),
                            LoopView(model, None, process_index() == 0),
                            verbose, write_output, timings)
    if timings is not None:
        timings.update(clock)
    return state.to(device)


class LoopView:
    """What :func:`run_loop` reads of a rank's state between chunks, from
    ``view(state)``, the whole state: on element-sharded ranks a
    collective that every rank calls at the same points, so the reads are
    ``collective`` and the loop makes them one at a time as each chunk
    ends.  With no ``view`` the state is the whole state on one device,
    and the loop queues a chunk's reads on the device (:meth:`queue`).
    Only the ``root`` rank forms frames and metrics and writes
    checkpoints.  Halo ranks read through ``parallel.halo.HaloView``,
    whose methods are collectives."""

    def __init__(self, model: LoweredModel, view, root: bool):
        self.model, self.view, self.root = model, view, root
        self.collective = view is not None
        self.sv = None
        self.host = self.copied = None       # made at the run's first read

    def update(self, state):
        self.sv = state if self.view is None else self.view(state)

    def alive(self):
        return self.sv.element_flag.sum()

    def finite(self):
        return torch.isfinite(self.sv.disp).all()

    def energy_rel(self):
        return energy_guard(self.model, self.sv)

    def metrics(self) -> dict | None:
        return step_metrics(self.model, self.sv) if self.root else None

    def queue(self, values: dict):
        """``values`` (0-d device tensors by name) as one float64 vector
        copied without blocking into the host buffer, pinned on a CUDA
        device, and an event recorded after the copy; returns a function
        that waits on the event and gives the values by name as floats.
        float64 holds every float32 value, and a count up to 2**53,
        exactly.  On the CPU the copy is synchronous.  One buffer serves
        the run (made anew where the values grow, as with the last
        chunk's): the loop reads a chunk's values before it queues the
        next chunk's."""
        vec = torch.stack([v.to(torch.float64) for v in values.values()])
        if self.host is None or self.host.shape != vec.shape:
            self.host = torch.empty(vec.shape, dtype=vec.dtype,
                                    pin_memory=vec.is_cuda)
            if vec.is_cuda:
                self.copied = torch.cuda.Event()
        self.host.copy_(vec, non_blocking=True)
        if self.copied is not None:
            self.copied.record(torch.cuda.current_stream(vec.device))
        names = list(values)

        def wait() -> dict:
            if self.copied is not None:
                self.copied.synchronize()
            return dict(zip(names, self.host.tolist()))
        return wait

    def frame_data(self):
        """(disp, velo, element_flag, NodeData) of the whole mesh on the
        root rank, else None."""
        if not self.root:
            return None
        s = self.sv
        return s.disp, s.velo, s.element_flag, node_fields(
            self.model, s.stress, s.strain, s.eq_ps, s.triax)

    def save(self, path: str):
        if self.root:
            save_checkpoint(path, self.sv)

    def final(self):
        return self.sv


@simulation()
def run_loop(model: LoweredModel, state, chunk, hooks, verbose: bool = True,
             write_output: bool = True,
             timings: dict | None = None) -> SimState:
    """The host loop of :func:`run` on one rank: ``chunk(state, n)``
    advances the rank's state n steps; ``hooks`` (a :class:`LoopView`, or
    a halo rank's ``HaloView``) reads the alive count, the guards, metrics,
    frames and checkpoints from it between chunks, every rank at the same
    points; only ``hooks.root`` writes files and console lines.  ``model``
    is the whole model.  Returns ``hooks.final()``, the whole final
    state.

    The loop runs one chunk ahead of its reads.  After chunk k it queues
    every value it will read of chunk k (the alive count, the NaN flag
    where ``check_nan`` is set, the energy ratio where the guard is on,
    the metrics record with ``metrics_path``; the guard reads the
    record's ``energy_rel_error``) as one copy to the host
    (``hooks.queue``), then queues chunk k+1, and only then waits for
    chunk k's values and acts on them: the guards, the "Element deleted"
    and progress lines, the record.  The device so runs chunk k+1 while
    the host reads chunk k.  It does not run ahead past a chunk after
    which a frame or checkpoint is due, nor past the last chunk, nor on
    ``hooks.collective`` (ranks whose reads are host collectives: they
    read each value as each chunk ends).  A guard that trips after chunk
    k raises after chunk k+1 was queued, which is dropped: the only
    ``chunk`` call that a synchronous loop would not make.  At most two
    states are alive at once: chunk k's is dropped once chunk k+1 has
    been queued from it.

    With ``timings``, fills in: ``step_s``, host seconds in ``chunk``
    calls and in the waits for chunk values (``hakai.chunk.sync``), over
    ``chunks`` chunks and ``steps`` steps; ``ahead``, the chunks queued
    before the previous chunk's values were read; ``frame_s`` over
    ``frames`` (the root's); ``loop_s``, the loop's other host seconds
    (queueing the reads, the guards, metrics, progress, checkpoints);
    ``metrics_s``, the part of ``loop_s`` inside ``hakai.metrics`` (the
    record's reductions queued, the JSONL write); ``host_syncs``, the
    waits for device values outside frames and checkpoints (one a chunk;
    on collective hooks each value read); ``captures`` and ``capture_s``,
    the graphs captured in the call and their host seconds of warm-up,
    capture and instantiation, and ``replays``, graph replays
    (``solver/graph.totals``); ``contact_rebuilds`` and
    ``contact_listed_max``, the contact activity lists' rebuilds after a
    deletion and the most triangles listed at a rebuild over the carried
    pairs' slots (``ops/activity.list_stats``; 0 where no chunk carried
    the lists: ranks, fracture-free decks), read with the last chunk's
    values.  Its stretches are spans: ``hakai.chunk``
    (the chunk queued and a wait for chunk values, ``hakai.chunk.sync``,
    whose ``chunk`` is the chunk read), ``hakai.metrics``,
    ``hakai.guard.alive`` (before the first chunk; on collective hooks
    with ``.finite`` and ``.energy`` after each), ``hakai.frame`` (with
    ``.gather``, ``.map`` and ``.write``), ``hakai.checkpoint`` and
    ``hakai.pvd``, each with the run and the chunk it follows."""
    cfg = model.config
    root = hooks.root
    verbose = verbose and root
    guard = cfg.energy_check and cfg.energy_abort_rel > 0
    stream = cfg.metrics_path is not None
    time_num = model.time_num
    d_out = max(time_num // cfg.output_num, 1)
    n_frames = time_num // d_out if time_num else 0
    metrics = MetricsWriter(cfg.metrics_path if root else None)
    clock = {"step_s": 0.0, "frame_s": 0.0, "frames": 0, "steps": 0,
             "chunks": 0, "ahead": 0, "host_syncs": 0, "metrics_s": 0.0,
             "contact_rebuilds": 0, "contact_listed_max": 0.0}
    counted = None if hooks.collective else list_stats(model)
    if counted is not None:         # a model whose chunks ran before
        counted[0].zero_()
    t_loop, framing, graphs = _time.perf_counter(), 0.0, totals()

    @contextlib.contextmanager
    def timed(key):
        t = _time.perf_counter()
        try:
            yield
        finally:
            clock[key] += _time.perf_counter() - t

    def read(name, value, **ids):
        """``value()``, device values read to the host, in span ``name``."""
        clock["host_syncs"] += 1
        with span(name, **ids):
            return value()

    def sync(value, j):
        """Chunk j's values waited for, a part of ``step_s``."""
        with timed("step_s"):
            return read("hakai.chunk.sync", value, chunk=j)

    def queue_reads(last):
        """The values of the chunk just run, queued on the device (its
        record's reductions in ``hakai.metrics``; after the ``last`` chunk
        the contact lists' counters too): (wait, record names)."""
        vals = {"alive": hooks.alive()}
        stats = list_stats(model) if last else None
        if stats is not None:
            vals["contact_rebuilds"] = stats[0][0]
            vals["contact_listed"] = stats[0][2]
        if cfg.check_nan:
            vals["finite"] = hooks.finite()
        rec = {}
        if stream and root:
            with timed("metrics_s"), span("hakai.metrics"):
                rec = hooks.metrics()
            vals.update(rec)
        if guard and "energy_rel_error" not in vals:
            vals["energy_rel_error"] = hooks.energy_rel()
        return hooks.queue(vals), list(rec)

    def collective_reads():
        """The values of the chunk just run, read one at a time (every rank
        at the same points), and the record's names."""
        got = {"alive": read("hakai.guard.alive",
                             lambda: int(hooks.alive()))}
        if cfg.check_nan:
            got["finite"] = read("hakai.guard.finite",
                                 lambda: bool(hooks.finite()))
        if guard:
            got["energy_rel_error"] = read(
                "hakai.guard.energy", lambda: float(hooks.energy_rel()))
        rec = {}
        if stream:
            with timed("metrics_s"), span("hakai.metrics"):
                vals = hooks.metrics()
                if root:
                    rec = {k: float(v) for k, v in vals.items()}
                    clock["host_syncs"] += len(vals)
        return {**got, **rec}, list(rec)

    def act(step, got, names):
        """The guards, console lines and metrics record of the chunk that
        ended at ``step``, from its values ``got``."""
        nonlocal alive_prev
        alive = int(got["alive"])
        if cfg.check_nan and not got["finite"]:
            raise FloatingPointError(f"NaN/Inf in displacement at step {step}")
        if guard:
            rel = got["energy_rel_error"]
            if rel > cfg.energy_abort_rel:
                raise FloatingPointError(
                    f"energy balance diverged at step {step}: "
                    f"|KE - KE0 - W_ext + W_int| = {rel:.3e} of the energy "
                    f"scale (> {cfg.energy_abort_rel:.3e}) — roundoff energy "
                    "injection; re-run with --precision f64 or mixed")
        if verbose and alive != alive_prev:
            print(f"Element deleted:{alive}/{model.n_element}")
            alive_prev = alive
        if verbose:
            sys.stdout.write(f"\r{step * model.dt:.4e} / "
                             f"{model.end_time:.4e}     ")
            sys.stdout.flush()
        if names:
            with timed("metrics_s"), span("hakai.metrics"):
                metrics.record_raw({k: got[k] for k in names}, model, step,
                                   _time.time() - t0)

    def frame(index):
        nonlocal framing
        t0 = _time.perf_counter()
        with span("hakai.frame", frame=index):
            with span("hakai.frame.gather"):
                data = hooks.frame_data()
            if root:
                di_, ve_, fl_, nd = data
                with span("hakai.frame.map"):
                    co, el, fl, di, ve, nd_o = _deck_order_frame(
                        model, di_, ve_, fl_, nd)
                with span("hakai.frame.write"):
                    write_vtk(index, cfg.out_dir, co, el, fl, di, ve, nd_o,
                              model.n_node, model.n_element)
        dt = _time.perf_counter() - t0
        framing += dt
        if root:
            clock["frame_s"] += dt
            clock["frames"] += 1

    hooks.update(state)
    done = int(state.t)
    clock["host_syncs"] += 1
    frame_times = []
    if write_output:
        frame(0)
        frame_times.append((0, float(done) * model.dt))

    t0 = _time.time()
    alive_prev = read("hakai.guard.alive", lambda: int(hooks.alive()))
    i_out = done // d_out + 1
    pending = None      # (step, wait, names) of a chunk whose reads wait
    while done < time_num:
        n = min(d_out, time_num - done)
        j = clock["chunks"]
        IDS["chunk"] = j
        done += n
        due = write_output and done % d_out == 0 and i_out <= n_frames
        ahead = not (hooks.collective or due or done == time_num)
        with span("hakai.chunk", steps=n):
            with timed("step_s"):
                state = chunk(state, n)
            if hooks.collective:
                sync(lambda: int(state.t), j)
            else:
                if pending is not None:     # chunk j - 1's, after j queued
                    clock["ahead"] += 1
                    prev = sync(pending[1], j - 1)
                hooks.update(state)
                wait, names = queue_reads(done == time_num)
                if not ahead:
                    got = sync(wait, j)
        clock["steps"] += n
        clock["chunks"] += 1
        if hooks.collective:
            hooks.update(state)
            got, names = collective_reads()
        if pending is not None:
            act(pending[0], prev, pending[2])
            pending = None
        if ahead:
            pending = (done, wait, names)
            continue
        act(done, got, names)
        if "contact_rebuilds" in got:
            clock["contact_rebuilds"] = int(got["contact_rebuilds"])
            clock["contact_listed_max"] = (got["contact_listed"]
                                           / list_stats(model)[1])
        if due:
            frame(i_out)
            frame_times.append((i_out, done * model.dt))
            if cfg.checkpoint_every and i_out % cfg.checkpoint_every == 0:
                with span("hakai.checkpoint"):
                    hooks.save(cfg.checkpoint_path
                               or f"{cfg.out_dir}/ckpt_{i_out:03d}.npz")
            i_out += 1
    metrics.close()
    if write_output and frame_times and root:
        with span("hakai.pvd"):
            write_pvd(cfg.out_dir, frame_times)
    if verbose:
        print(f"\nwall: {_time.time() - t0:.2f}s for {time_num} steps")
    if timings is not None:
        clock["loop_s"] = (_time.perf_counter() - t_loop - clock["step_s"]
                           - framing)
        clock.update({k: v - graphs[k] for k, v in totals().items()})
        timings.update(clock)
    return hooks.final()
