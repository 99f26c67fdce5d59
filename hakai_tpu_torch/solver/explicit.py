"""Explicit central-difference time integration (mirrors the generic
``step()``, the packed chunk loop and ``run()`` of
``hakai_tpu/solver/explicit.py``).

A step is five things: on contact decks the contact force (activity
masks and broad phase in plain PyTorch, then the gather, narrow-phase and
scatter kernels), the central-difference update with amplitude-scaled
boundary conditions (plain PyTorch), the fused element kernel, the
assembly kernel, and on fracture decks the erosion table walk (plain
PyTorch).  The step counter and the current time stay on the
device: nothing in a chunk reads a value back to the host.

``run_chunk`` picks the loop as the JAX package does: the packed loop on
models that carry ``coord_e`` (the lowering forms it on meshes of 2,048
elements and nodes and more, unless ``gather_mode="xla"``), else the
generic :func:`step`, which keeps the unpacked state, zeroes a dead
element's stress and strain every step and reports its triaxiality from
the trial stress.  ``run()`` drives chunks from the host and writes VTK
frames, checkpoints and metrics between them, on one device or, with
``devices``, on element-sharded ranks (``parallel/sharding.py``), whose
steps are these same functions given a ``comm``.
"""
from __future__ import annotations

import sys
import time as _time

import numpy as np
import torch

from ..core.lowering import LoweredModel
from ..core.state import SimState, init_state
from ..io.vtk import write_pvd, write_vtk
from ..ops.assemble_cuda import assemble_internal_force
from ..ops.contact import contact_forces
from ..ops.element import triax_components
from ..ops.element_cuda import element_update, packed_element_step
from ..ops.erosion import erode
from ..utils.checkpoint import save_checkpoint
from ..utils.metrics import MetricsWriter, energy_guard, step_metrics
from .output import node_fields


def amplitude_values(model: LoweredModel, current_time):
    """Piecewise-linear amplitude interpolation, one value per table.  The
    first segment holding ``current_time`` wins; outside every segment the
    first segment is extrapolated."""
    T, V, n = model.amp_time, model.amp_value, model.amp_n
    t0, t1 = T[:, 0], T[:, 1]
    v0, v1 = V[:, 0], V[:, 1]
    found = torch.zeros(T.shape[0], dtype=torch.bool, device=T.device)
    for j in range(T.shape[1] - 1):
        inside = ((current_time >= T[:, j]) & (current_time <= T[:, j + 1])
                  & (j < n - 1) & ~found)
        t0 = torch.where(inside, T[:, j], t0)
        t1 = torch.where(inside, T[:, j + 1], t1)
        v0 = torch.where(inside, V[:, j], v0)
        v1 = torch.where(inside, V[:, j + 1], v1)
        found = found | inside
    return v0 + (v1 - v0) * (current_time - t0) / (t1 - t0)


def apply_bc(model: LoweredModel, disp_new, current_time):
    """Prescribed displacements: disp_new[dof] = value * amplitude (BC
    entries were deduplicated last-wins at lowering)."""
    ampv = amplitude_values(model, current_time)
    fac = torch.ones_like(disp_new)
    for a in range(ampv.shape[0]):
        fac = torch.where(model.bcd_amp == a, ampv[a], fac)
    return torch.where(model.bcd_mask, model.bcd_value * fac, disp_new)


def _integrate(model: LoweredModel, state: SimState, comm=None):
    """Contact + central difference + BCs.  Returns (t, disp_new, velo,
    cforce, dwork); cforce is the step's contact force (None on decks
    without contact) and dwork the [dW_ext, dW_int] increment
    pair, or None unless ``config.energy_check``.  Time and a1 = M/dt^2 are
    formed in the model dtype, as the JAX step forms them.

    ``comm`` (a :class:`~hakai_tpu_torch.parallel.sharding.ShardComm` or
    :class:`~hakai_tpu_torch.parallel.halo.HaloComm`) makes this a rank's
    step: its ``contact`` reads the life mask of every rank's elements and
    deals the narrow phase out over the ranks.  On a halo rank ``model``
    and ``state`` hold the rank's own node rows.

    The contact activity masks are formed every step from the step's life
    mask: they are pure functions of it, so this gives the bits the JAX
    chunk loop carries (it recomputes them only after a deletion) with no
    read back to the host."""
    dt = model.dt_t
    t = state.t + 1
    current_time = t.to(model.dtype) * dt
    a1 = model.diag_M / dt**2
    a2 = model.diag_M * model.config.damping_C / (2.0 * dt)
    cforce = external = None
    if model.pairs:
        cforce = external = (contact_forces(model, state) if comm is None
                             else comm.contact(model, state))
    force = -state.Q if external is None else external - state.Q
    numer = (force + a1 * (2.0 * state.disp - state.disp_pre)
             + a2 * state.disp_pre)
    disp_new = numer / (a1 + a2)
    disp_new = apply_bc(model, disp_new, current_time)
    disp_new = torch.where(model.node_exists, disp_new, 0.0)
    velo = (disp_new - state.disp) / dt
    dwork = None
    if model.config.energy_check:
        # discrete energy balance: with du_mid = (u_new - u_prev)/2,
        # dKE = (F_ext + F_c - Q) . du_mid exactly in real arithmetic, F_c
        # the constraint force realizing the prescribed motion at BC dofs
        du_mid = 0.5 * (disp_new - state.disp_pre)
        f_c = torch.where(model.bcd_mask, (a1 + a2) * disp_new - numer, 0.0)
        w_ext = f_c if external is None else external + f_c
        dwork = torch.stack([torch.sum(w_ext * du_mid),
                             torch.sum(state.Q * du_mid)])
    return t, disp_new, velo, cforce, dwork


def _assemble(model: LoweredModel, qe24, comm):
    """Q in the nodal dtype from this rank's qe (24, E)."""
    if comm is None:
        return assemble_internal_force(model, qe24, out_dtype=model.dtype)
    return comm.assemble(qe24, model.dtype)


def _finish(model: LoweredModel, state: SimState, t, disp_new, velo, cforce,
            res, triax, comm=None) -> SimState:
    """Assembly, erosion and the state swap of the generic step.  ``triax``
    is the element kernel's, of the final stress; on fracture decks
    ``erode`` walks the table on it and zeroes every dead element's stress
    and strain."""
    Q = _assemble(model, res.Qe.reshape(24, model.E), comm)
    flag = state.element_flag
    stress, strain = res.stress, res.strain
    if model.fracture_enabled:
        er = erode(model, stress, strain, res.eq_ps, triax, flag)
        flag, stress, strain = er.element_flag, er.stress, er.strain
    return state.replace(
        t=t, disp=disp_new, disp_pre=state.disp, velo=velo, Q=Q,
        stress=stress, strain=strain, eq_ps=res.eq_ps, yield_s=res.yield_s,
        triax=triax, element_flag=flag,
        contact_force=state.contact_force if cforce is None else cforce)


def step(model: LoweredModel, state: SimState, comm=None) -> SimState:
    """One generic step on the unpacked state.  The new position
    ``coord + disp`` and the increment ``disp_new - disp`` are formed in the
    nodal dtype and cast to the element dtype before the element kernel
    gathers them (in mixed mode its math, centring included, is float32).
    With ``comm``, ``model`` and ``state`` are a rank's element shard
    (:mod:`hakai_tpu_torch.parallel.sharding`)."""
    t, disp_new, velo, cforce, dwork = _integrate(model, state, comm)
    edt = model.edtype
    res, triax = element_update(
        model, (model.coord + disp_new).to(edt),
        (disp_new - state.disp).to(edt), state.stress, state.strain,
        state.eq_ps, state.yield_s, state.element_flag, want_triax=True)
    out = _finish(model, state, t, disp_new, velo, cforce, res, triax, comm)
    return out.replace(work=state.work if dwork is None
                       else state.work + dwork)


def step_fast_packed(model: LoweredModel, state: SimState, P, comm=None):
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
    chunk exit."""
    t, disp_new, velo, cforce, dwork = _integrate(model, state, comm)
    P_new, qe, triax, flag = packed_element_step(
        model, P, state.element_flag, disp_new, state.disp)
    Q = _assemble(model, qe, comm)
    work = state.work if dwork is None else state.work + dwork
    return state.replace(
        t=t, disp=disp_new, disp_pre=state.disp, velo=velo, Q=Q,
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
    erosion walk needs it every step).  With ``comm``, ``model`` and
    ``state`` are a rank's element shard (every per-element act of the
    chunk, its exit included, stays on the rank's elements)."""
    if model.coord_e is None:
        for _ in range(n_steps):
            state = step(model, state, comm)
        return state
    P = pack_gauss_state(state)
    for _ in range(n_steps):
        state, P = step_fast_packed(model, state, P, comm)
    return finish_packed(model, state, P)


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
    the frames, checkpoints, metrics and console lines, and the whole final
    state is returned, on ``device``.  With ``profile``, a torch.profiler
    trace of the run's loop (on ranks, rank 0's) goes to
    ``<profile>/trace.json``.  With a ``timings`` dict, fills in the host
    seconds spent in step chunks (each ends in a device sync) and in frame
    output.  Returns the final state."""
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
        with trace(profile):
            model = model.to(device)
            state = init_state(model) if state is None else state.to(device)
            return run_loop(model, state, lambda s, n: run_chunk(model, s, n),
                            LoopView(model, lambda s: s, True), verbose,
                            write_output, timings)
    if timings is not None:
        timings.update(clock)
    return state.to(device)


class LoopView:
    """What :func:`run_loop` reads of a rank's state between chunks, from
    ``view(state)``, the whole state (on element-sharded ranks a collective
    that every rank calls at the same points).  Only the ``root`` rank
    forms frames and metrics and writes checkpoints.  Halo ranks read
    through ``parallel.halo.HaloView``, whose methods are collectives."""

    def __init__(self, model: LoweredModel, view, root: bool):
        self.model, self.view, self.root = model, view, root
        self.sv = None

    def update(self, state):
        self.sv = self.view(state)

    def alive(self) -> int:
        return int(self.sv.element_flag.sum())

    def finite(self) -> bool:
        return bool(torch.isfinite(self.sv.disp).all())

    def energy_rel(self) -> float:
        return float(energy_guard(self.model, self.sv))

    def metrics(self) -> dict | None:
        return step_metrics(self.model, self.sv) if self.root else None

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


def run_loop(model: LoweredModel, state, chunk, hooks, verbose: bool = True,
             write_output: bool = True,
             timings: dict | None = None) -> SimState:
    """The host loop of :func:`run` on one rank: ``chunk(state, n)``
    advances the rank's state n steps; ``hooks`` (a :class:`LoopView`, or
    a halo rank's ``HaloView``) reads the alive count, the guards, metrics,
    frames and checkpoints from it between chunks, every rank at the same
    points; only ``hooks.root`` writes files and console lines.  ``model``
    is the whole model.  Returns ``hooks.final()``, the whole final
    state."""
    cfg = model.config
    root = hooks.root
    verbose = verbose and root
    time_num = model.time_num
    d_out = max(time_num // cfg.output_num, 1)
    n_frames = time_num // d_out if time_num else 0
    metrics = MetricsWriter(cfg.metrics_path if root else None)
    clock = {"step_s": 0.0, "frame_s": 0.0, "frames": 0, "steps": 0}

    def frame(index):
        t0 = _time.perf_counter()
        data = hooks.frame_data()
        if not root:
            return
        di_, ve_, fl_, nd = data
        co, el, fl, di, ve, nd_o = _deck_order_frame(model, di_, ve_, fl_,
                                                     nd)
        write_vtk(index, cfg.out_dir, co, el, fl, di, ve, nd_o,
                  model.n_node, model.n_element)
        clock["frame_s"] += _time.perf_counter() - t0
        clock["frames"] += 1

    hooks.update(state)
    frame_times = []
    if write_output:
        frame(0)
        frame_times.append((0, float(int(state.t)) * model.dt))

    t0 = _time.time()
    alive_prev = hooks.alive()
    done = int(state.t)
    i_out = done // d_out + 1
    while done < time_num:
        n = min(d_out, time_num - done)
        tc = _time.perf_counter()
        state = chunk(state, n)
        int(state.t)                                  # syncs the device
        clock["step_s"] += _time.perf_counter() - tc
        clock["steps"] += n
        done += n
        hooks.update(state)
        alive = hooks.alive()
        if cfg.check_nan and not hooks.finite():
            raise FloatingPointError(f"NaN/Inf in displacement at step {done}")
        if cfg.energy_check and cfg.energy_abort_rel > 0:
            rel = hooks.energy_rel()
            if rel > cfg.energy_abort_rel:
                raise FloatingPointError(
                    f"energy balance diverged at step {done}: "
                    f"|KE - KE0 - W_ext + W_int| = {rel:.3e} of the energy "
                    f"scale (> {cfg.energy_abort_rel:.3e}) — roundoff energy "
                    "injection; re-run with --precision f64 or mixed")
        if verbose and alive != alive_prev:
            print(f"Element deleted:{alive}/{model.n_element}")
            alive_prev = alive
        if verbose:
            sys.stdout.write(f"\r{done * model.dt:.4e} / "
                             f"{model.end_time:.4e}     ")
            sys.stdout.flush()
        if cfg.metrics_path is not None:
            vals = hooks.metrics()
            if root:
                metrics.record_raw(vals, model, done, _time.time() - t0)
        if write_output and done % d_out == 0 and i_out <= n_frames:
            frame(i_out)
            frame_times.append((i_out, done * model.dt))
            if cfg.checkpoint_every and i_out % cfg.checkpoint_every == 0:
                hooks.save(cfg.checkpoint_path
                           or f"{cfg.out_dir}/ckpt_{i_out:03d}.npz")
            i_out += 1
    metrics.close()
    if write_output and frame_times and root:
        write_pvd(cfg.out_dir, frame_times)
    if verbose:
        print(f"\nwall: {_time.time() - t0:.2f}s for {time_num} steps")
    if timings is not None:
        timings.update(clock)
    return hooks.final()
