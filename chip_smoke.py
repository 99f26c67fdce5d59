#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``hakai_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
without its last line):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (nvidia-smi) and the torch/CUDA versions;
2. build: compiles ``hakai_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
   and the host-IO helper ``csrc/host_io.cpp`` with the host compiler;
3. kernels: each kernel instantiation against its plain PyTorch version on
   the card, at the main paths' shapes (the 32x32x128 bar), with random
   inputs that engage the plastic branch, a dead element and padding
   lanes: the element kernel's packed entry in float32, float32 with the
   triaxiality output, float64, and mixed precision with the triaxiality
   output; its unpacked entry (the generic step's) in float32, float32
   with the triaxiality output and float64; the assembly in float32 and
   float32 -> float64 (mixed).  Kernel, plain and (assembly)
   ``index_add_`` times and the least time the card could take, the
   kernel's share of it, and each instantiation's registers, local
   (spill) bytes, shared memory and resident blocks an SM; where
   ``build/ref/`` holds the reference design's sources (REF_DIR: the
   parent commit's element, assembly, contact and interleave kernels),
   times for them, built into a library of their own, with every output
   bitwise the shipped kernels' on the same inputs and a REF_CHUNK-step
   chunk of [run]'s deck bitwise too;
4. trajectory: 100 steps of a plastic 16x16x64 bar on the card (kernels)
   and on the CPU (plain versions), compared;
5. main path of the first slice: the 32x32x128 bar (131,072 elements,
   float32) stepped with ``run_chunk`` for 50 and 400 steps (slope timing,
   as bench.py times the JAX package), counting kernel launches, checking
   that repeat runs from one state are bitwise equal; then a profiler trace;
6. fracture: the ductile 8x8x32 bar in mixed precision, 500 steps one at a
   time on the card and on the CPU; the deletion histories compared;
7. main path of the second slice: the ductile 32x32x128 bar in mixed
   precision through ``run()`` on the card for 10,000 steps with 5 VTK
   frames, a checkpoint every other frame, the energy balance and the metrics
   stream; launches counted, frames checked against the alive count, the
   first deletion located exactly from the checkpoints; then a trace;
   then host-io: the C++ helper's build (seconds, library), [cli]'s deck
   text (12.6 MB) parsed through the helper and through its Python twin
   (equal arrays) and [run]'s last frame written through either (equal
   bytes, and equal to [run]'s own frame), each timed on the host beside
   its CPU's model name;
8. contact, main path of the third slice: a flying 48^3 cube on a 96x96x1
   slab (119,808 elements), all-exterior contact with ductile erosion, in
   mixed precision through ``run()`` for 5,000 steps with 5 frames and a
   checkpoint at each: launches by kernel, frames against the alive count,
   the first contact and first deletion steps, a repeat chunk bitwise
   equal, the surviving block pairs; then a trace;
9. contact-kernels: the gather, narrow-phase and scatter kernels against
   their plain versions on that deck's state 25 steps after the first
   contact, in float32 (times and bounds) and float64, the narrow phase
   (cell-binned: a spatial hash of each side, probed in the 27 cells
   around each item) with every node's and triangle's accept count, timed
   in both types beside PR 7's block-loop kernel, and its CUDA launches a
   step counted by the profiler; its time as each of 2 ranks calls it
   under [sharded-contact]'s deal, the ranks' forces summed bitwise one
   device's; its time when built with FMA contraction; the scatter's
   resources and share of bound; given the reference design, the scatter
   bitwise the reference S, timed beside it, and a REF_CONTACT_CHUNK-step
   chunk of the deck with either S, every field bitwise;
10. contact-cpu: a small impact with erosion, cube off the slab's grid
   lines, one step at a time on the card and on the CPU (below 2,048
   elements: the generic step): the first contact steps and the deletion
   histories compared;
11. generic, main path of the fourth slice: the bench bar lowered with
   ``gather_mode="xla"`` (no ``coord_e``: the generic step and the unpacked
   element entry) through ``run_chunk``, slope-timed as in [main], with a
   trace; then the ductile bar in mixed precision with ``gather_mode="xla"``
   through ``run()`` for GENERIC_STEPS steps with frames, its first
   deletion and alive count beside [run]'s, and a trace;
12. generic-cpu: a ductile bar below 2,048 elements, one step at a time on
   the card and on the CPU, in float64 (deletion histories equal) and in
   mixed precision (the rule of [fracture]);
13. cli: ``python -m hakai_tpu_torch`` in a subprocess on a small deck
   written by ``scripts/inp_deck.py``, on the card and with ``--device
   cpu``, frames compared; then, each with the energy guard at its default
   (abort at 0.1 of the energy scale) and ``--metrics``, its peak
   ``energy_rel_error`` printed beside the 0.1: [run]'s ductile bar
   written as a deck and run through the CLI in mixed precision for its
   10,000 steps, every frame equal to [run]'s byte for byte; [contact]'s
   impact written as a deck, mixed, 5,000 steps, every frame equal to
   [contact]'s byte for byte; and both in float64, cut in depth (CLI_STEPS
   and CLI_CONTACT_STEPS, their amplitudes kept) without frames; the
   parse, lowering, step and frame seconds and the host-IO helper each
   run used;
14. grouped-asm (fifth slice, TPU kernels #9/#10): in the kernels phase,
   the grouped entry of the assembly kernel on the node-block-major
   grouping of the bench bar's incidence table, float32, float64 and
   float32 -> float64, against its plain version and bit for bit against
   the assembly kernel, timed with its bound and ``index_add_``; after the
   main path, the bench bar with the grouped plan through ``run_chunk``,
   bitwise equal to the main path's run;
15. sharded (fifth slice): one launch of two element-sharded ranks (gloo,
   sharing the card; NCCL with a card per rank where there are two): the
   bench bar in the packed loop and on the generic step, bitwise equal to
   one device, with us/step, the all-gathers' share and rank 0's device
   busy; single sharded steps around the next phases' events;
16. sharded-run: [run]'s deck cut to 2,000 steps through
   ``run(devices=2)``: first deletion, alive count, frames byte-identical
   to [run]'s, its checkpoint resumed on one device bitwise;
17. sharded-contact: [contact]'s deck cut to 400 steps through
   ``run(devices=2)``: first contact and first deletion, the alive count
   and the contact force against one device;
18. nccl: one NCCL rank on the bench bar, bitwise equal to ``run_chunk``;
   two NCCL ranks on one card refused;
19. halo (sixth slice), in [sharded]'s launch: the bench bar on two
   node-sharded halo ranks (gloo, sharing the card) in the packed loop
   and on the generic step, against one device at the f32 halo
   tolerances, with the partition, us/step, the exchanges' share and rank
   0's device busy; single halo steps around [run]'s first deletion and
   [contact]'s first contact and first deletion;
20. halo-run: [run]'s deck cut to 2,000 steps through ``run(halo=2)``:
   the alive count, frame 0 byte-identical to [run]'s and frame 1 within
   2e-5, its shard-major checkpoint reloaded to the returned state;
21. dma (TPU kernel #11): the streaming kernel in its three layouts at
   (72, 1,048,576) float32, bitwise its plain version, through the port's
   bandwidth probe (slope-timed us/pass and GB/s, ``torch.add`` beside it,
   the bound);
22. interleave (TPU kernel #12): the interleave kernel in its four modes
   at the TPU probe's 512 tiles x 60 builds from a (64, 8, 128) window,
   through the port's interleave probe (slope-timed us/pass and ns/build,
   each chain bitwise its plain version's), then each mode bitwise its
   plain version on a random window and timed alone beside the bound,
   with its resources; given the reference design, the probe on the
   reference kernel and each mode bitwise it, timed;
23. multihost (seventh slice): [cli]'s written deck through two CLI
   processes on loopback (``--multihost 127.0.0.1:P,2,K --halo 2``, one
   gloo rank each, sharing the card), each writing to a directory of its
   own: process 1 writes only its checkpoint shard files; process 0's
   frame 0 is byte-identical to [cli]'s and frames 1-2 within
   HALO_FRAME_REL, CELLS equal the alive counts, the manifest and both
   processes' files carry rows [0] and [1]; then two new processes resume
   from the first checkpoint, and their frame 2 is byte-identical to the
   first run's.

The line before the last is nvidia-smi's name and power limit; the one
before that the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""
import contextlib
import ctypes
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

SEED = 20261016
ROOT = os.path.dirname(os.path.abspath(__file__))
NX, NY, NZ = 32, 32, 128          # bench.py's bar
N1, N2 = 50, 400                  # bench.py's chunk sizes
REPEATS = 5                       # slope pairs and kernel timing batches
# kernel vs plain version, normwise: max|kernel - plain| <= tol * max|plain|.
# Both evaluate the same formulas in another association order (FMA
# contraction, einsum order, Gauss-point sum order): ~100 dependent f32
# operations give ~1e-6, so 1e-5 keeps a 10x margin and stays orders below
# the error of any wrong term.  The assembly sums <= 8 terms.  Mixed
# precision runs the float32 math on the same float32 inputs (both take
# the float64 differences before one cast), so it keeps the float32 bound.
TOL = {("element", "float32"): 1e-5, ("element", "float64"): 1e-12,
       ("element", "mixed"): 1e-5,
       ("assemble", "float32"): 1e-6, ("assemble", "float64"): 1e-14,
       ("assemble", "mixed"): 1e-6}
# the triaxiality mean/vm is a quotient of two rounded sums whose
# deviatoric differences cancel: 10x the element bound
TRIAX_TOL = {"float32": 1e-4, "float64": 1e-11, "mixed": 1e-4}
# card (kernels, f32) vs CPU (plain versions, f32) after 100 plastic steps,
# normwise.  Two f32 runs that round differently part at the rate an f32
# run parts from an f64 one: 2.4e-6 (disp) and 7.1e-4 (stress) at 200
# steps on this bar, measured on the card and on a CPU; the limits are
# about 10x that.
TRAJ_STEPS = 100
TRAJ_TOL = {"disp": 2e-5, "P": 5e-3}
# [fracture]: card vs CPU deletion histories of the mixed ductile bar.
# The two runs take the same float32 math in another rounding order and
# part at the f32 rate, ~1e-3 relative in stress after a few hundred
# plastic steps (the trajectory phase).  Erosion compares mean eq_ps with
# the fracture strain, so only an element within that band of its
# threshold can be deleted some steps apart, or on one side only.  Rule:
# the first deletion steps differ by at most FRAC_STEPS; every element
# deleted by step FRAC_N on one side only is, on the side that keeps it,
# within FRAC_BAND (10x the band) of its fracture strain; and such
# elements are at most FRAC_SHARE of the deleted set.
FRAC_N, FRAC_STEPS, FRAC_BAND, FRAC_SHARE = 500, 5, 1e-2, 0.05
# [run]: the second slice's main path
RUN_END = 1e-4                    # 10,000 steps at d_time = 1e-8
RUN_FRAMES = 5
RUN_CKPT_EVERY = 2                # a checkpoint at frames 2 and 4
RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke_run")
# [contact]: the third slice's main path.  v0 is 2.5x impact_model's
# default: at 8e4 mm/s the cube rebounds with eq_ps ~0.09 (CPU runs at
# n=8 and n=16), short of the 0.3 fracture strain; at 2e5 the n=8 cube
# loses its first elements within ~500 steps of contact
CONTACT_N, CONTACT_V0, CONTACT_DT, CONTACT_END = 48, 2.0e5, 1e-9, 5e-6
CONTACT_FRAMES = 5                # a checkpoint at every frame
CONTACT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke_contact")
CONTACT_REPEAT = 50               # steps of the bitwise repeat check
CONTACT_KERNEL_AFTER = 25         # [contact-kernels] state: steps after
#                                   the first contact
# [contact-kernels]: kernel vs plain version, normwise.  The narrow phase
# sums up to TB*n_blocks per-pair forces in another order (kernel:
# sequential within a block, the blocks in order; plain: PyTorch's
# reductions): the element kernel's bounds.  Its accept decisions are
# bitwise equal by construction (no FMA, same association); a decision
# that differs must lie within MARGIN of a threshold.  The scatter sums <= ~40 terms in
# another association than nothing: the assembly's bounds.
CONTACT_TOL = {("narrow", "float32"): 1e-5, ("narrow", "float64"): 1e-12,
               ("scatter", "mixed"): 1e-6, ("scatter", "float64"): 1e-14}
MARGIN = 1e-5
# narrow-phase operations the function needs, counted from csrc/contact.cu.
# A (triangle, node) pair whose cells are more than one apart needs none:
# the spatial hash never visits it.  Each in-range item needs its cell (3
# subtractions, 3 divisions, 3 ceilings), each in-range triangle its
# geometry (centroid, radius, normal, area, penalty, adjugate over the
# determinant: ~140); each pair within one cell the cell test and the
# circumradius cull (19); past that the solve and the accept window (24);
# an accepted pair the force and its sums (48).  Bytes it needs: the
# range masks and block-pair mask, each read once; of each in-range
# triangle its three corners and q0's velocity (12 values; on a self pair
# its element's 8 node ids), of each in-range node its position, velocity
# and mass (7 values) and its id; and every force column of the pair, 3
# values each, written once
NARROW_OPS = {"item": 9, "geometry": 140, "cell": 19, "dist": 24,
              "accept": 48}
# PR 7's block-loop narrow kernel at [contact-kernels]'s state, float32
# (PERF.md, PR 7 call 3), printed beside the cell-binned kernel's time
NARROW_PR7_MS = 2.4551
# [contact-cpu]: the tie-free impact, card vs CPU, one step at a time
CONTACT_CPU_N, CONTACT_CPU_STEPS = 4, 300
# [generic]: the mixed ductile bar through run() on the generic step, the
# [run] deck with its end time cut (its amplitude ramp kept, so the first
# GENERIC_STEPS steps are [run]'s), GENERIC_FRAMES frames
GENERIC_STEPS, GENERIC_FRAMES = 3000, 3
GENERIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke_generic")
# [generic-cpu]: ductile 4x4x16 bar pulled over 800 steps (first deletions
# near step 130), single steps on card and CPU
GCPU_STEPS = 300
# [cli]: [run]'s and [contact]'s decks at full depth in mixed precision;
# in float64, [run]'s deck cut to CLI_STEPS steps and [contact]'s to
# CLI_CONTACT_STEPS (past its first contact and deletion), each with
# CLI_F64_RECORDS metrics records.  [multihost] takes the cut bar deck with
# CLI_FRAMES frames, which land on [run]'s frame steps (every 2,000)
CLI_STEPS, CLI_FRAMES = 4000, 2
CLI_CONTACT_STEPS, CLI_F64_RECORDS = 2000, 20
# the CLI's default energy abort (cli.py: _resolve_energy_flags)
ENERGY_ABORT = 0.1
CLI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke_cli")
# [grouped-asm]: TPU kernels #9/#10 on the node-block-major grouping of the
# bench bar's incidence table (N = 141,312 = 69 tiles of 2,048 nodes)
GROUPED_R_TILE = 2048
# [sharded]: element-sharded runs on SHARD_RANKS ranks, one per card under
# NCCL where the machine has as many cards, else sharing the one card
# under gloo; the bench bar in both loops, SHARD_STEPS steps after
# SHARD_WARM dropped ones, then SHARD_TRACE traced ones (few steps keep the
# script short: gloo's steps on one card take 10-17 ms; the generic loop
# runs half as many to keep the script near its time)
SHARD_RANKS, SHARD_WARM, SHARD_TRACE = 2, 10, 10
SHARD_STEPS = {"packed f32": 200, "generic f32": 100}
# [sharded-run]: [run]'s deck cut to SHARD_RUN_STEPS steps (its amplitude
# ramp kept), frames at steps 0 and 2,000 and a checkpoint, resumed on one
# device for
# SHARD_RUN_RESUME steps; [run] and [generic] recorded the first deletion
# and the alive count at step 2,000
SHARD_RUN_STEPS, SHARD_RUN_RESUME = 2000, 100
SHARD_RUN_FIRST, SHARD_RUN_ALIVE = 1424, 129868
SHARD_RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "smoke_sharded_run")
# [sharded-contact]: [contact]'s deck cut to SHARD_CONTACT_STEPS steps;
# [contact] recorded the first contact and first deletion.  The narrow
# phase is dealt out by whole node and triangle blocks, so every sum runs
# on one rank in the single-device order: the state is bitwise the
# single-device one (dealing single block pairs, as JAX does, left the
# mixed contact force 0.39 of its scale apart at step 400 on the card)
SHARD_CONTACT_STEPS, CONTACT_FIRST, CONTACT_FIRST_DEL = 400, 252, 295
SHARD_CONTACT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build", "smoke_sharded_contact")
# the single steps that locate [sharded-run]'s and [sharded-contact]'s
# events start this many steps before them, from the one-device state
SHARD_LEAD = 2
# [nccl]: one NCCL rank on the card, the bench bar
NCCL_STEPS = 200
# [halo]: node-sharded runs on HALO_RANKS gloo ranks sharing the card, in
# [sharded]'s launch (SHARD_STEPS steps after SHARD_WARM, SHARD_TRACE
# traced).  A halo Q adds the ghost rows after the owned sum, so the f32
# bars part from one device at the f32 rate: held normwise to
# tests/test_halo.py's packed f32 tolerances (disp 3e-5, stress 3e-4)
HALO_RANKS = 2
HALO_TOL = {"disp": 3e-5, "stress": 3e-4}
# [halo-run]: [run]'s deck cut to SHARD_RUN_STEPS steps through
# run(halo=HALO_RANKS); the alive count within HALO_ALIVE_REL of
# SHARD_RUN_ALIVE, frame 1 within HALO_FRAME_REL (test_run_halo_packed_vtk)
HALO_ALIVE_REL, HALO_FRAME_REL = 1e-3, 2e-5
HALO_RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "smoke_halo_run")
# [dma]: TPU kernel #11 at benchmarks/dma_microbench.py's defaults
DMA_E, DMA_TE, DMA_N1, DMA_N2 = 1048576, 2048, 20, 120
# [interleave]: TPU kernel #12 at benchmarks/interleave_microbench.py's
# defaults (N_TILES, BUILDS; its window is 64 slabs) and chains
IL_TILES, IL_BUILDS, IL_N1, IL_N2 = 512, 60, 20, 120
# [multihost]: [cli]'s deck through two CLI processes of one rank each
MH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "smoke_multihost")
# H100 SXM peaks (NVIDIA data sheet, dense, no tensor cores): HBM
# 3.35 TB/s; 67 TFLOP/s float32, 34 TFLOP/s float64.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "mixed": 67e12}
# element-kernel operations per element, counted from csrc/element.cu (an
# FMA counts 2): per Gauss-point thread J and Gdu 270, det/inverse 55,
# g 45, B-bar and trial 60, return map 45, strain and sums 30, force
# moments 100, Qe fold 144, triaxiality 20 -> ~770, x 8 threads
ELEMENT_FLOP = 6200


# The reference design of the element kernel, kernel B, kernel S and TPU
# kernel #12's replacement: their sources as the parent commit has them,
# copied under build/ref/ before a run
#   mkdir -p build/ref && for f in element assemble contact interleave; do
#     git show HEAD:hakai_tpu_torch/csrc/$f.cu > build/ref/$f.cu; done
# [kernels] builds them into a library of their own and holds every
# element and assembly instantiation against them bit for bit, with their
# resources and times, and a chunk of [run]'s deck; [contact-kernels] and
# [interleave] do the same for S (and a chunk of [contact]'s deck) and
# #12.  Without them each says so and goes on.
REF_DIR = os.path.join(ROOT, "build", "ref")
REF_SOURCES = ("element", "assemble", "contact", "interleave")
REF_CHUNK = 1500                  # [run]'s deck past its first deletion
REF_CONTACT_CHUNK = 400           # [contact]'s deck past its first deletion


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def relerr(a, b) -> float:
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / (scale if scale > 0 else 1.0)


def time_ms(fn, reps=20, warm=3, repeats=REPEATS) -> float:
    """Median over ``repeats`` batches of the mean device time of one call.

    Before each call a 256 MB memset evicts the L2 cache (50 MB on an
    H100), so the call reads its inputs from device memory, as it does
    inside a step, where the element kernel streams ~110 MB between two
    assemblies; CUDA events on either side of the call time it alone.
    Each batch is queued behind a sleep kernel that outlasts the host's
    queueing of the batch, so no host launch cost enters the events (it
    exceeds the run time of the shorter kernels)."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def one(ev):
        flush.zero_()
        ev[0].record()
        fn()
        ev[1].record()

    def events():
        return [(torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = events()
    t = time.perf_counter()
    one(evs[0])                         # host time to queue one call
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    # cycles at up to 2 GHz: 1.5x the queueing time plus 1 ms, at most 1 s
    cycles = int(min(1.5 * reps * host_s + 1e-3, 1.0) * 2e9)
    out = []
    for _ in range(repeats):
        evs = events()
        torch.cuda._sleep(cycles)
        for ev in evs:
            one(ev)
        torch.cuda.synchronize()
        out.append(statistics.fmean(a.elapsed_time(b) for a, b in evs))
    return statistics.median(out)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, n_flop, kind):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_b, t_f = n_bytes / HBM_BPS, n_flop / PEAK_FLOPS[kind]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def build_reference():
    """The reference design's kernels (REF_DIR, REF_SOURCES) as a library
    of their own, with the pusai table loaded; None, said so, where REF_DIR
    lacks their sources."""
    import numpy as np

    from hakai_tpu_torch import _build
    from hakai_tpu_torch.ops.shape import pusai_hexa
    if not all(os.path.isfile(os.path.join(REF_DIR, f"{n}.cu"))
               for n in REF_SOURCES):
        log(f"[kernels] no reference sources in {REF_DIR} ("
            + ", ".join(f"{n}.cu" for n in REF_SOURCES) + "): the bitwise "
            "check against the reference design is skipped")
        return None
    t0 = time.perf_counter()
    nvcc = _build.nvcc_path()
    cmds, objs = [], []
    for n in REF_SOURCES:
        src = os.path.join(REF_DIR, f"{n}.cu")
        objs.append(os.path.join(REF_DIR, f"{n}.o"))
        cmds.append([nvcc, *_build.NVCC_FLAGS,
                     *_build.SOURCE_FLAGS.get(f"{n}.cu", ()), "-c", src,
                     "-o", objs[-1]])
    so = os.path.join(REF_DIR, "libref.so")
    out = _build._run_all(cmds) + _build._run_all(
        [[nvcc, "-shared", *objs, "-o", so]])
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    # the element, assembly and interleave entries take the shipped ones'
    # arguments; the reference S takes the CSR: src, ld, ptr, mid, col, N,
    # out, stream
    sigs = {n: _build._SIGNATURES[n] for n in _build._SIGNATURES
            if n.startswith(("hk_element", "hk_assemble",
                             "hk_blocked_assemble", "hk_set_pusai",
                             "hk_interleave_f32"))}
    sigs.update({n: (P, I, P, P, P, I, P, P) for n in
                 ("hk_scatter_f32", "hk_scatter_f64", "hk_scatter_f32_f64")})
    for n, argtypes in sigs.items():
        getattr(lib, n).argtypes = list(argtypes)
        getattr(lib, n).restype = ctypes.c_int
    lib.hk_error_string.argtypes = [I]
    lib.hk_error_string.restype = ctypes.c_char_p
    table = np.ascontiguousarray(pusai_hexa(8), np.float64)
    if lib.hk_set_pusai(table.ctypes.data) != 0:
        raise RuntimeError("reference design: hk_set_pusai failed")
    log(f"[kernels] reference design built from {REF_DIR} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[kernels] reference ptxas: {line.strip()}")
    return lib


class _Reference:
    """The port's library with its element, assembly and interleave entries
    taken from the reference build (the reference S takes the CSR: see
    reference_scatter)."""

    def __init__(self, new, old):
        self.new, self.old = new, old

    def __getattr__(self, name):
        old = name.startswith(("hk_element", "hk_assemble",
                               "hk_blocked_assemble", "hk_interleave_f32"))
        return getattr(self.old if old else self.new, name)


@contextlib.contextmanager
def reference(ref):
    """The port's wrappers launch the reference design's kernels."""
    from hakai_tpu_torch import _build
    shipped = _build._lib
    _build._lib = _Reference(shipped, ref)
    try:
        yield
    finally:
        _build._lib = shipped


def ref_scatter(ref, model, force, out_dtype):
    """The reference S (the parent commit's kernel, over the CSR) on
    ``force``: its (3, N) output."""
    import torch
    from hakai_tpu_torch import _build
    from hakai_tpu_torch.ops.contact_cuda import _SCATTER
    out = torch.empty((3, model.N), dtype=out_dtype, device=force.device)
    err = getattr(ref, _SCATTER[(force.dtype, out_dtype)])(
        force.data_ptr(), model.fs_width, model.fs_ptr.data_ptr(),
        model.fs_mid.data_ptr(), model.fs_col.data_ptr(), model.N,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(ref, err, "reference scatter kernel")
    return out


@contextlib.contextmanager
def reference_scatter(ref):
    """The contact path sums its forces with the reference S."""
    from hakai_tpu_torch.ops import contact
    shipped = contact.scatter_forces
    contact.scatter_forces = (lambda model, force, out_dtype=None:
                              ref_scatter(ref, model, force, out_dtype))
    try:
        yield
    finally:
        contact.scatter_forces = shipped


def resources(lib, which, model=None, slots=0) -> dict:
    """Resident blocks an SM, registers, static shared, local (spill) and
    dynamic shared bytes of element instantiation ``which`` (with
    ``model``'s hardening table) or of the assembly instantiation
    ``which`` that a launch over ``slots`` incidence slots takes."""
    from hakai_tpu_torch import _build
    out = (ctypes.c_int * 5)()
    if model is not None:
        err = lib.hk_element_resources(which, *model.hard_strain.shape, out)
    else:
        err = lib.hk_assemble_resources(which, slots, out)
    _build.check(lib, err, "resources")
    return dict(zip(("blocks", "registers", "smem", "local", "dyn"), out))


def _tensors(x):
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return [x]


def vs_reference(rec, ref, which, call, out_new, model=None, slots=0):
    """``rec`` gains the shipped instantiation's resources and, with a
    reference build, the reference design's resources and time on the same
    inputs; raises unless its outputs equal ``out_new`` bit for bit.
    ``model``: an element instantiation's; ``slots``: an assembly's V."""
    import torch
    from hakai_tpu_torch import _build
    rec["res"] = resources(_build.library(), which, model, slots)
    if ref is None:
        return
    with reference(ref):
        out_ref = call()
        torch.cuda.synchronize()
        rec["ref_ms"] = time_ms(call)
    rec["ref_res"] = resources(ref, which, model, slots)
    a, b = _tensors(out_new), _tensors(out_ref)
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("the kernel's outputs differ from the reference"
                             " design's")


def _res(r) -> str:
    return (f"{r['registers']} registers, {r['local']} B local a thread, "
            f"{r['smem']} B static + {r['dyn']} B dynamic shared, "
            f"{r['blocks']} blocks/SM")


def log_resources(rec, labels):
    """Each instantiation's resources and time as a share of its bound,
    beside the reference design's on the same inputs."""
    for key, label in labels.items():
        r = rec[key]
        line = (f"[kernels] {label}: {_res(r['res'])}; {r['ms']:.4f} ms, "
                f"{r['bound_ms'] / r['ms']:.3f} of its bound "
                f"{r['bound_ms']:.4f} ms")
        if "ref_ms" in r:
            line += (f" | reference design: {_res(r['ref_res'])}; "
                     f"{r['ref_ms']:.4f} ms, "
                     f"{r['bound_ms'] / r['ref_ms']:.3f} of its bound; "
                     "outputs bitwise equal")
        log(line)


def reference_chunk(model, ref):
    """REF_CHUNK steps of ``model`` from its initial state through
    run_chunk, with the shipped kernels and with the reference design's:
    every state field bit for bit, past the first deletion."""
    import torch
    from hakai_tpu_torch import init_state, run_chunk
    if ref is None:
        return
    s0 = init_state(model)
    new = run_chunk(model, s0, REF_CHUNK)
    with reference(ref):
        old = run_chunk(model, s0, REF_CHUNK)
    torch.cuda.synchronize()
    differ = [f.name for f in dataclasses.fields(new)
              if not torch.equal(getattr(new, f.name), getattr(old, f.name))]
    alive, n = int(new.element_flag.sum()), int(model.elem_exists.sum())
    log(f"[kernels] {REF_CHUNK} steps of [run]'s deck with the shipped and "
        f"the reference kernels: {n - alive} elements deleted; fields that "
        f"differ: {differ or 'none'}")
    if differ:
        raise AssertionError(f"the chunk differs from the reference: {differ}")
    if alive == n:
        raise AssertionError("the reference chunk deleted no element")


def kind_of(model) -> str:
    import torch
    if model.dtype != model.edtype:
        return "mixed"
    return "float32" if model.dtype == torch.float32 else "float64"


def with_padding(model, n_pad):
    """The model with its last ``n_pad`` elements turned into padding
    lanes (node ids 0, zero coordinates, no plasticity)."""
    elem = model.elem.clone()
    elem[:, -n_pad:] = 0
    coord_e = model.coord_e.clone()
    coord_e[..., -n_pad:] = 0
    hasp = model.has_plastic_e.clone()
    hasp[-n_pad:] = False
    return dataclasses.replace(model, elem=elem, coord_e=coord_e,
                               has_plastic_e=hasp)


def element_inputs(model, rng, device):
    """Random state that engages both return-map branches: stress ~300 MPa,
    yield in [755, 1055) around the trial von Mises stress, eq_ps across the
    hardening table, one dead element and 128 padding lanes.  P in the
    element dtype, disp/dprev in the nodal dtype."""
    import numpy as np
    import torch
    E, N = model.E, model.N
    disp = rng.normal(scale=1e-3, size=(3, N))
    dprev = disp + rng.normal(scale=2e-4, size=(3, N))
    P = np.concatenate([rng.normal(scale=300.0, size=(48, E)),
                        rng.normal(scale=1e-3, size=(6, E)),
                        np.zeros((2, E)),
                        rng.uniform(0.0, 0.3, size=(8, E)),
                        755.0 + rng.uniform(0.0, 300.0, size=(8, E))])
    flag = np.ones(E, bool)
    flag[3] = False
    flag[-128:] = False

    def t(a, dt):
        return torch.as_tensor(a, device=device).to(dt).contiguous()
    return (t(P, model.edtype), torch.as_tensor(flag, device=device),
            t(disp, model.dtype), t(dprev, model.dtype))


def check_element(model, rng, name, want_triax=False, ref=None):
    """Kernel vs plain version on one random state, and bitwise against
    the reference design ``ref`` where there is one; returns the JSON
    record's numbers."""
    import torch
    from hakai_tpu_torch.ops.element import element_core_packed_plain
    from hakai_tpu_torch.ops.element_cuda import element_core_packed
    P, flag, disp, dprev = element_inputs(model, rng, model.device)
    out_k = element_core_packed(model, P, flag, disp, dprev, want_triax)
    out_p = element_core_packed_plain(model, P, flag, disp, dprev, want_triax)
    torch.cuda.synchronize()
    (Pk, qk), (Pp, qp) = out_k[:2], out_p[:2]
    kind = kind_of(model)
    tol = TOL[("element", kind)]
    errs = {"stress": relerr(Pk[:48], Pp[:48]),
            "strain": relerr(Pk[48:54], Pp[48:54]),
            "eq_ps": relerr(Pk[56:64], Pp[56:64]),
            "yield": relerr(Pk[64:72], Pp[64:72]),
            "qe": relerr(qk, qp)}
    max_abs = max((Pk - Pp).abs().max().item(), (qk - qp).abs().max().item())
    msg = ""
    if want_triax:
        terr = relerr(out_k[2], out_p[2])
        max_abs = max(max_abs, (out_k[2] - out_p[2]).abs().max().item())
        msg = f" triax={terr:.3e} (tol {TRIAX_TOL[kind]:g})"
        if not terr <= TRIAX_TOL[kind]:
            raise AssertionError(f"element kernel triax disagrees: {terr}")
    plastic = (Pp[56:64] != P[56:64]).double().mean().item()
    log(f"[kernels] element {name} {kind} E={model.E}: rel errs "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {tol:g}){msg}; max_abs={max_abs:.3e}; plastic GP share "
        f"{plastic:.3f}")
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"element kernel disagrees: {bad}")
    if not 0.05 < plastic < 0.95:
        raise AssertionError(f"inputs do not engage both branches: {plastic}")
    if Pk[54:56].abs().max().item() != 0.0:
        raise AssertionError("P rows 54:56 are not zero")
    if qk[:, ~flag].abs().max().item() != 0.0:
        raise AssertionError("dead/padding lanes carry force")
    rec = {"max_abs_err": max_abs}
    rec["ms"] = time_ms(lambda: element_core_packed(model, P, flag, disp,
                                                    dprev, want_triax))
    rec["plain_ms"] = time_ms(lambda: element_core_packed_plain(
        model, P, flag, disp, dprev, want_triax), reps=5)
    moved = nbytes(model.elem, model.coord_e, disp, dprev, P, model.G_e,
                   model.lam_e, model.mat_id, model.has_plastic_e, flag,
                   model.hard_strain, model.hard_slope, model.hard_n,
                   *out_k)
    rec["bound_ms"], rec["bound_by"] = bound(moved, ELEMENT_FLOP * model.E,
                                             kind)
    rec["library_ms"] = None
    vs_reference(rec, ref, ("float32", "float64", "mixed").index(kind)
                 + 5 * want_triax, lambda: element_core_packed(
                     model, P, flag, disp, dprev, want_triax), out_k, model)
    log(f"[kernels] element {name} {kind}{' +triax' if want_triax else ''}: "
        f"kernel {rec['ms']:.4f} ms ({rec['bound_ms'] / rec['ms']:.3f} of "
        f"bound), plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {moved / 1e6:.1f} MB,"
        f" {ELEMENT_FLOP * model.E / 1e9:.2f} GFLOP)")
    return rec


def update_inputs(model, rng, device):
    """The generic step's element-update arguments from
    :func:`element_inputs`: the nodal position coord + disp and the
    increment disp - dprev in the element dtype, the unpacked Gauss-point
    state and the life mask."""
    P, flag, disp, dprev = element_inputs(model, rng, device)
    E, edt = model.E, model.edtype
    return ((model.coord + disp).to(edt), (disp - dprev).to(edt),
            P[:48].reshape(6, 8, E).contiguous(), P[48:54].contiguous(),
            P[56:64].contiguous(), P[64:72].contiguous(), flag)


def check_update(model, rng, name, want_triax=False, ref=None):
    """The unpacked entry (TPU kernel #3) against its plain version on one
    random state, and bitwise against the reference design ``ref`` where
    there is one; returns the JSON record's numbers."""
    import torch
    from hakai_tpu_torch.ops.element import (element_core_plain,
                                             gather_element_nodes,
                                             triax_stress)
    from hakai_tpu_torch.ops.element_cuda import element_update
    u = update_inputs(model, rng, model.device)

    def plain():
        pos_e, du = gather_element_nodes(model, u[0], u[1])
        res = element_core_plain(model, pos_e, du, *u[2:])
        return (res, triax_stress(res.stress)) if want_triax else res
    out_k = element_update(model, *u, want_triax=want_triax)
    out_p = plain()
    torch.cuda.synchronize()
    rk, rp = (out_k[0], out_p[0]) if want_triax else (out_k, out_p)
    kind = kind_of(model)
    tol = TOL[("element", kind)]
    errs = {k: relerr(getattr(rk, k), getattr(rp, k))
            for k in ("stress", "strain", "eq_ps", "yield_s", "Qe")}
    max_abs = max((getattr(rk, k) - getattr(rp, k)).abs().max().item()
                  for k in errs)
    msg = ""
    if want_triax:
        terr = relerr(out_k[1], out_p[1])
        max_abs = max(max_abs, (out_k[1] - out_p[1]).abs().max().item())
        msg = f" triax={terr:.3e} (tol {TRIAX_TOL[kind]:g})"
        if not terr <= TRIAX_TOL[kind]:
            raise AssertionError(f"unpacked element triax disagrees: {terr}")
    plastic = (rp.eq_ps != u[4]).double().mean().item()
    log(f"[kernels] element_update {name} {kind} E={model.E}: rel errs "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {tol:g}){msg}; max_abs={max_abs:.3e}; plastic GP share "
        f"{plastic:.3f}")
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"unpacked element kernel disagrees: {bad}")
    if not 0.05 < plastic < 0.95:
        raise AssertionError(f"inputs do not engage both branches: {plastic}")
    if rk.Qe[..., ~u[-1]].abs().max().item() != 0.0:
        raise AssertionError("dead/padding lanes carry force")
    rec = {"max_abs_err": max_abs}
    rec["ms"] = time_ms(lambda: element_update(model, *u,
                                               want_triax=want_triax))
    rec["plain_ms"] = time_ms(plain, reps=5)
    outs = [rk.Qe, rk.stress, rk.strain, rk.eq_ps, rk.yield_s]
    if want_triax:
        outs.append(out_k[1])
    moved = nbytes(model.elem, *u, model.G_e, model.lam_e, model.mat_id,
                   model.has_plastic_e, model.hard_strain, model.hard_slope,
                   model.hard_n, *outs)
    rec["bound_ms"], rec["bound_by"] = bound(moved, ELEMENT_FLOP * model.E,
                                             kind)
    rec["library_ms"] = None
    vs_reference(rec, ref, 3 + (kind == "float64") + 5 * want_triax,
                 lambda: element_update(model, *u, want_triax=want_triax),
                 out_k, model)
    log(f"[kernels] element_update {name} {kind}"
        f"{' +triax' if want_triax else ''}: kernel {rec['ms']:.4f} ms "
        f"({rec['bound_ms'] / rec['ms']:.3f} of bound), "
        f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}: {moved / 1e6:.1f} MB, "
        f"{ELEMENT_FLOP * model.E / 1e9:.2f} GFLOP)")
    return rec


def index_add_yardstick(model, qe, out_dtype, ref):
    """One PyTorch call for the assembly's sum (another order): index_add_
    of the (3, 8E) qe columns into the nodes of elem, in qe's dtype.
    (its normwise distance from ``ref``, its ms)."""
    import torch
    idx = model.elem.flatten().long()
    src = qe.view(3, 8 * model.E)
    Q0 = torch.zeros((3, model.N), dtype=qe.dtype, device=qe.device)
    lib = Q0.clone().index_add_(1, idx, src)
    return (relerr(lib.to(out_dtype), ref),
            time_ms(lambda: Q0.clone().index_add_(1, idx, src)))


def check_assemble(model, rng, name, out_dtype=None, ref=None):
    """Kernel B against its plain version on one random qe, and bitwise
    against the reference design ``ref`` where there is one; returns the
    JSON record's numbers."""
    import torch
    from hakai_tpu_torch.ops.assemble_cuda import assemble_internal_force
    from hakai_tpu_torch.ops.element import assemble_internal_force_plain
    qe = torch.as_tensor(rng.normal(scale=100.0, size=(24, model.E)),
                         device=model.device).to(model.edtype).contiguous()
    out_dtype = qe.dtype if out_dtype is None else out_dtype
    Qk = assemble_internal_force(model, qe, out_dtype)
    Qp = assemble_internal_force_plain(model, qe).to(out_dtype)
    torch.cuda.synchronize()
    kind = kind_of(model)
    tol = TOL[("assemble", kind)]
    err = relerr(Qk, Qp)
    max_abs = (Qk - Qp).abs().max().item()
    log(f"[kernels] assemble {name} {kind} N={model.N}: {qe.dtype} -> "
        f"{Qk.dtype}, rel err {err:.3e} (tol {tol:g}); max_abs={max_abs:.3e}")
    if Qk.dtype != out_dtype:
        raise AssertionError(f"assembly wrote {Qk.dtype}, not {out_dtype}")
    if not err <= tol:
        raise AssertionError(f"assembly kernel disagrees: {err}")
    if not torch.equal(Qk, assemble_internal_force(model, qe, out_dtype)):
        raise AssertionError("assembly kernel is not deterministic")
    rec = {"max_abs_err": max_abs}
    rec["ms"] = time_ms(lambda: assemble_internal_force(model, qe,
                                                        out_dtype))
    rec["plain_ms"] = time_ms(
        lambda: assemble_internal_force_plain(model, qe).to(out_dtype),
        reps=10)
    rec["library_err"], rec["library_ms"] = index_add_yardstick(
        model, qe, out_dtype, Qp)
    moved = nbytes(qe, model.inc_idx, model.inc_mask, Qk)
    rec["bound_ms"], rec["bound_by"] = bound(moved, 24 * model.E, kind)
    vs_reference(rec, ref, ("float32", "float64", "mixed").index(kind),
                 lambda: assemble_internal_force(model, qe, out_dtype), Qk,
                 slots=model.inc_idx.shape[0])
    log(f"[kernels] assemble {name} {kind}: kernel {rec['ms']:.4f} ms "
        f"({rec['bound_ms'] / rec['ms']:.3f} of bound), plain "
        f"{rec['plain_ms']:.4f} ms, index_add_ {rec['library_ms']:.4f} ms "
        f"(rel err {rec['library_err']:.1e}), bound {rec['bound_ms']:.4f} ms"
        f" ({rec['bound_by']}: {moved / 1e6:.1f} MB)")
    return rec


def trajectory():
    import torch
    from hakai_tpu_torch import SolverConfig, init_state, lower, run_chunk
    from hakai_tpu_torch.pre.synthetic import bar_model
    from hakai_tpu_torch.solver.explicit import pack_gauss_state
    bar = bar_model(16, 16, 64, d_time=5e-8, end_time=1e-4)
    out = {}
    for dev, dt in (("cuda", "float32"), ("cpu", "float32"),
                    ("cpu", "float64")):
        m = lower(bar, SolverConfig(dtype=dt), device=dev)
        t0 = time.perf_counter()
        s = run_chunk(m, init_state(m), TRAJ_STEPS)
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"[trajectory] {dev} {dt}: {TRAJ_STEPS} steps in "
            f"{time.perf_counter() - t0:.2f} s")
        out[(dev, dt)] = (s.disp.cpu().double(),
                          pack_gauss_state(s).cpu().double(), s)
    (dg, Pg, sg), (dc, Pc, _), (d64, P64, _) = (
        out[("cuda", "float32")], out[("cpu", "float32")],
        out[("cpu", "float64")])
    errs = {"disp": relerr(dg, dc), "P": relerr(Pg, Pc)}
    env = {"disp": relerr(dc, d64), "P": relerr(Pc, P64)}
    eq_max = sg.eq_ps.max().item()
    log(f"[trajectory] cuda vs cpu (f32): disp {errs['disp']:.3e} "
        f"P {errs['P']:.3e} (tol {TRAJ_TOL}); cpu f32 vs f64: disp "
        f"{env['disp']:.3e} P {env['P']:.3e}; eq_ps max {eq_max:.4f}")
    if not all(torch.isfinite(x).all() for x in (dg, Pg)):
        raise AssertionError("trajectory is not finite")
    if not eq_max > 0:
        raise AssertionError("trajectory did not engage plasticity")
    bad = {k: v for k, v in errs.items() if not v <= TRAJ_TOL[k]}
    if bad:
        raise AssertionError(f"card and CPU trajectories part: {bad}")


def _wrappers() -> dict:
    from hakai_tpu_torch.ops.assemble_cuda import (assemble_internal_force,
                                                   blocked_assemble)
    from hakai_tpu_torch.ops.contact_cuda import narrow_phase, scatter_forces
    from hakai_tpu_torch.ops.element_cuda import (element_core_packed,
                                                  element_update)
    from hakai_tpu_torch.ops.gather_cuda import gather_cols
    from hakai_tpu_torch.ops.interleave_cuda import interleave
    from hakai_tpu_torch.ops.stream_cuda import stream_add1
    return {"element": element_core_packed, "update": element_update,
            "assemble": assemble_internal_force, "grouped": blocked_assemble,
            "gather": gather_cols,
            "narrow": narrow_phase, "scatter": scatter_forces,
            "stream": stream_add1, "interleave": interleave}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        for k in getattr(fn, "launches_by", ()):
            fn.launches_by[k] = 0


def read_counts() -> dict:
    out = {}
    for name, fn in _wrappers().items():
        out[name] = fn.launches
        out.update({f"{name}[{k}]": v
                    for k, v in getattr(fn, "launches_by", {}).items() if v})
    return out


def main_path(model, smi_line, tag="[main]",
              counts=("element", "assemble", "element[float32]")):
    """run_chunk on ``model`` from its initial state, slope-timed; every
    count named in ``counts`` must equal the steps run."""
    import torch
    from hakai_tpu_torch import init_state, run_chunk
    state0 = init_state(model)

    def run_sync(k):
        t0 = time.perf_counter()
        s = run_chunk(model, state0, k)
        _ = float(s.disp.sum())         # scalar readback forces completion
        return s, time.perf_counter() - t0

    run_sync(N1)                        # warm-up (allocator, first launches)
    reset_counts()
    per_step, runs = [], []
    for _ in range(REPEATS):
        s1, t1 = run_sync(N1)
        s2, t2 = run_sync(N2)
        per_step.append((t2 - t1) / (N2 - N1))
        runs.append(s2)
    launches = read_counts()
    steps = REPEATS * (N1 + N2)
    log(f"{tag} launches {launches} for {steps} steps")
    if any(launches.get(k) != steps for k in counts):
        raise AssertionError(f"kernel launches {launches} != steps {steps}")
    fields = ("disp", "velo", "Q", "stress", "strain", "eq_ps", "yield_s",
              "triax")
    for name, s in (("n1", s1), ("n2", s2)):
        for f in fields:
            if not torch.isfinite(getattr(s, f)).all():
                raise AssertionError(f"{name} run: {f} is not finite")
    if int(s2.t) != N2 or tuple(s2.disp.shape) != (3, model.N):
        raise AssertionError("main path state has the wrong step or shape")
    if not all(torch.equal(getattr(runs[0], f), getattr(s, f))
               for s in runs[1:] for f in fields):
        raise AssertionError("runs from one state are not bitwise equal")
    top = s2.disp[2][model.bcd_amp[2] == 0].mean().item()
    us = sorted(x * 1e6 for x in per_step)
    med = statistics.median(us)
    log(f"{tag} {model.n_element} elements, N={model.N}, slope of "
        f"T({N2}) - T({N1}) over {REPEATS} pairs: median {med:.2f} us/step "
        f"(min {us[0]:.2f}, max {us[-1]:.2f}) -> "
        f"hex8_element_steps_per_sec={model.n_element / med * 1e6:.6e}; "
        f"{REPEATS} runs bitwise equal; pulled-face uz {top:.6e} "
        f"[{smi_line}]")
    return launches, s2, med


def trace(model, state, smi_line, tag, n=40):
    """Device time per step by kernel, from torch.profiler (CUPTI):
    (busy us a step, untraced us a step, {kernel: launches a step})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hakai_tpu_torch import run_chunk
    run_chunk(model, state, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_chunk(model, state, n)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / n * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_chunk(model, state, n)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / n
    by_name, count = {}, {}
    ours = ("element_kernel", "assemble_kernel", "gather_cols_kernel",
            "narrow_bin", "narrow_scan", "narrow_sort", "narrow_probe",
            "scatter_kernel")
    for e in dev:
        key = next((k for k in ours if k in e.name), "PyTorch ops")
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / n
        count[key] = count.get(key, 0) + 1 / n
    log(f"[trace] {tag}: {n} steps: {len(dev) / n:.1f} device kernels/step, "
        f"device busy {busy:.2f} us/step: "
        + ", ".join(f"{k} {v:.2f} us ({count[k]:.1f} a step)"
                    for k, v in sorted(by_name.items()))
        + f"; the same {n} steps untraced {wall_us:.2f} us/step [{smi_line}]")
    return busy, wall_us, count


def fracture_margin(model, state):
    """(E,) mean eq_ps over the fracture strain at the mean triaxiality
    (1 = at the threshold; 0 where the triaxiality is negative)."""
    import torch
    from hakai_tpu_torch.ops.erosion import element_means, fracture_strain
    v_e, t_e = element_means(state.eq_ps, state.triax)
    return torch.where(t_e >= 0, v_e / fracture_strain(model, t_e), 0.0)


def fracture():
    """The ductile 8x8x32 bar in mixed precision, one step at a time to
    step FRAC_N on the card and on the CPU: the deletion histories."""
    import numpy as np
    import torch
    from hakai_tpu_torch import SolverConfig, init_state, lower, run_chunk
    from hakai_tpu_torch.pre.synthetic import bar_model
    from hakai_tpu_torch.solver.explicit import pack_gauss_state
    bar = bar_model(8, 8, 32, d_time=5e-8, end_time=1e-4, ductile=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = lower(bar, SolverConfig(dtype="mixed"), device=dev)
        s = init_state(m)
        died = np.full(m.E, -1)
        exists = m.elem_exists.cpu().numpy()
        t0 = time.perf_counter()
        for step in range(1, FRAC_N + 1):
            s = run_chunk(m, s, 1)
            flag = s.element_flag.cpu().numpy()
            died[(died < 0) & ~flag & exists] = step
        log(f"[fracture] {dev}: {FRAC_N} steps in "
            f"{time.perf_counter() - t0:.2f} s; first deletion at step "
            f"{died[died > 0].min() if (died > 0).any() else None}, "
            f"{(died > 0).sum()} of {m.n_element} deleted")
        runs[dev] = (m, s, died)
    (mg, sg, dg), (mc, sc, dc) = runs["cuda"], runs["cpu"]
    if not (dc > 0).any():
        raise AssertionError("the CPU run deleted no element")
    errs = {"disp": relerr(sg.disp.cpu(), sc.disp),
            "P": relerr(pack_gauss_state(sg).cpu().double(),
                        pack_gauss_state(sc).double())}
    only, keep, first = one_sided(mg, sg, dg, mc, sc, dc)
    same_step = ((dg > 0) & (dc > 0) & (dg == dc)).sum()
    log(f"[fracture] card vs cpu at step {FRAC_N}: disp {errs['disp']:.3e} "
        f"P {errs['P']:.3e}; first deletion {first[0]} vs {first[1]}; "
        f"deleted {(dg > 0).sum()} vs {(dc > 0).sum()}, {same_step} at the "
        f"same step, {len(only)} on one side only (margins on the keeping "
        f"side: {[round(float(x), 5) for x in keep]}); rule: first steps "
        f"within {FRAC_STEPS}, one-sided elements within {FRAC_BAND:g} of "
        f"their fracture strain and <= {FRAC_SHARE:g} of the deleted set")
    if not torch.isfinite(sg.disp).all():
        raise AssertionError("card fracture run is not finite")
    deletion_rule(only, keep, first, dc)


def one_sided(mg, sg, dg, mc, sc, dc):
    """(elements deleted on one side only, their margins on the side that
    keeps them, (card, CPU) first deletion steps) of two deletion
    histories (the step each element died, -1 alive)."""
    import numpy as np
    only = np.nonzero((dg > 0) != (dc > 0))[0]
    margin = {"cuda": fracture_margin(mg, sg).cpu().numpy(),
              "cpu": fracture_margin(mc, sc).numpy()}
    # on the side that keeps the element, how close it is to its threshold
    keep = [margin["cuda"][e] if dg[e] < 0 else margin["cpu"][e]
            for e in only]
    first = (dg[dg > 0].min() if (dg > 0).any() else -1, dc[dc > 0].min())
    return only, keep, first


def deletion_rule(only, keep, first, dc):
    """The [fracture] rule on two deletion histories; raises if broken."""
    if abs(int(first[0]) - int(first[1])) > FRAC_STEPS:
        raise AssertionError(f"first deletions part: {first}")
    if any(not x >= 1.0 - FRAC_BAND for x in keep) or \
            len(only) > FRAC_SHARE * (dc > 0).sum():
        raise AssertionError(f"deleted sets part beyond the f32 band: "
                             f"{only.tolist()} margins {keep}")


def vtk_cells(path) -> int:
    with open(path) as f:
        for line in f:
            if line.startswith("CELLS "):
                return int(line.split()[1])
    raise AssertionError(f"{path} has no CELLS line")


def second_path(model, smi_line):
    """run() on the card: the ductile bar, mixed, RUN_FRAMES frames, a
    checkpoint every RUN_CKPT_EVERY frames, energy balance and metrics."""
    import torch
    from hakai_tpu_torch import init_state, run, run_chunk
    from hakai_tpu_torch.utils.checkpoint import load_checkpoint
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    os.makedirs(RUN_DIR)
    timings = {}
    reset_counts()
    t0 = time.perf_counter()
    final = run(model, timings=timings)
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps = model.time_num
    log(f"\n[run] launches {launches} for {steps} steps")
    if (launches["element"] != steps or launches["assemble"] != steps
            or launches.get("element[mixed+triax]") != steps
            or launches.get("assemble[hk_assemble_f32_f64]") != steps):
        raise AssertionError(f"kernel launches {launches} != steps {steps}")
    for f in ("disp", "velo", "Q", "stress", "eq_ps", "triax"):
        if not torch.isfinite(getattr(final, f)).all():
            raise AssertionError(f"[run] {f} is not finite")
    alive = int(final.element_flag.sum())
    frames = sorted(p for p in os.listdir(RUN_DIR) if p.endswith(".vtk"))
    cells = [vtk_cells(os.path.join(RUN_DIR, p)) for p in frames]
    with open(os.path.join(RUN_DIR, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    d_out = steps // RUN_FRAMES
    by_step = {r["step"]: int(r["alive_elements"]) for r in recs}
    want = [model.n_element] + [by_step[i * d_out]
                                for i in range(1, len(frames))]
    log(f"[run] frames {frames} + collection.pvd "
        f"{os.path.exists(os.path.join(RUN_DIR, 'collection.pvd'))}; "
        f"CELLS {cells}, alive by metrics {want}; energy_rel_error "
        f"{recs[-1]['energy_rel_error']:.3e}; eq_ps max "
        f"{recs[-1]['eq_plastic_strain_max']:.4f}")
    if len(frames) != RUN_FRAMES + 1 or cells != want:
        raise AssertionError(f"frames {frames} with CELLS {cells} != {want}")
    if cells[-1] != alive or alive >= model.n_element:
        raise AssertionError(f"no element deleted ({alive} alive)")
    # the first deletion, exactly: from the last checkpoint before the
    # first frame with a deletion, one step at a time (chunks compose
    # bitwise, so this retraces the run)
    k = next(i for i, c in enumerate(cells) if c < model.n_element)
    ckpts = sorted(p for p in os.listdir(RUN_DIR) if p.startswith("ckpt_"))
    if ckpts != [f"ckpt_{i:03d}.npz" for i in range(
            RUN_CKPT_EVERY, RUN_FRAMES + 1, RUN_CKPT_EVERY)]:
        raise AssertionError(f"checkpoints {ckpts}")
    ck = (k - 1) // RUN_CKPT_EVERY * RUN_CKPT_EVERY
    s = (init_state(model) if ck == 0 else load_checkpoint(
        os.path.join(RUN_DIR, f"ckpt_{ck:03d}.npz"), init_state(model)))
    while int(s.element_flag.sum()) == model.n_element:
        s = run_chunk(model, s, 1)
    first = int(s.t)
    if not (k - 1) * d_out < first <= k * d_out:
        raise AssertionError(f"first deletion {first} outside frame {k}")
    us = timings["step_s"] / timings["steps"] * 1e6
    log(f"[run] {model.n_element} elements mixed ductile, {steps} steps: "
        f"step loop {timings['step_s']:.2f} s = {us:.2f} us/step "
        f"({model.n_element / us * 1e6:.6e} elem-steps/s) without frame "
        f"output; {timings['frames']} frames in {timings['frame_s']:.2f} s; "
        f"run() wall {wall:.2f} s; first deletion at step {first}, "
        f"{alive} of {model.n_element} alive at step {steps} "
        f"[{smi_line}]")
    return launches, final, us, first, by_step


def contact_model(smi_line):
    """The third slice's deck: a flying 48^3 steel cube on a fixed 96x96x1
    slab, all-exterior contact with ductile erosion, mixed precision."""
    import torch
    from hakai_tpu_torch import SolverConfig, lower
    from hakai_tpu_torch.ops.contact_cuda import narrow_buckets
    from hakai_tpu_torch.pre.synthetic import impact_model
    shutil.rmtree(CONTACT_DIR, ignore_errors=True)
    os.makedirs(CONTACT_DIR)
    t0 = time.perf_counter()
    m = lower(impact_model(n=CONTACT_N, v0=CONTACT_V0, d_time=CONTACT_DT,
                           end_time=CONTACT_END),
              SolverConfig(dtype="mixed", energy_check=True,
                           output_num=CONTACT_FRAMES, checkpoint_every=1,
                           out_dir=CONTACT_DIR, metrics_path=os.path.join(
                               CONTACT_DIR, "metrics.jsonl")), device="cuda")
    torch.cuda.synchronize()
    log(f"[contact] impact_model(n={CONTACT_N}, v0={CONTACT_V0:g}, d_time="
        f"{CONTACT_DT:g}, end_time={CONTACT_END:g}) mixed: {m.n_element} "
        f"elements (E={m.E}), {m.n_node} nodes (N={m.N}), renumbered="
        f"{m.node_new2old is not None}, lowered in "
        f"{time.perf_counter() - t0:.2f} s; cfl_dt {m.cfl_dt:.6e} s, d_time "
        f"{m.dt:g} = {m.dt / m.cfl_dt:.3f} of it; {m.time_num} steps")
    if m.dt > m.cfl_dt:
        raise AssertionError(f"d_time {m.dt} exceeds cfl_dt {m.cfl_dt}")
    for p in m.pairs:
        log(f"[contact] pair nodes of instance {p.i_instance} vs triangles of"
            f" {p.j_instance}: 2F={p.tri_nodes.shape[1]} Ci="
            f"{p.cand_nodes.shape[0]} Cj={p.jnode_nodes.shape[0]} TB={p.tb} "
            f"nb={p.nb} block grid {p.tri_chunks}x{p.n_chunks}, narrow-phase"
            f" hash buckets B="
            f"{narrow_buckets(p.tri_nodes.shape[1], p.cand_nodes.shape[0])}; "
            f"kinematics "
            f"columns R={m.ckin_idx.shape[0]}, force table "
            f"{m.fs_col.shape[0]} entries over {m.fs_width} columns")
    return m


def block_pairs(model, state) -> list:
    """Surviving (triangle block, node block) pairs per directional pair,
    and whether the pair's boxes overlap, from the broad phase on
    ``state`` (one host read each, outside any timed region)."""
    from hakai_tpu_torch.ops.contact import (broad_phase, contact_activity,
                                             contact_kinematics)
    from hakai_tpu_torch.ops.contact_cuda import pair_constants
    edt = model.edtype
    kin = contact_kinematics(model, (model.coord + state.disp).to(edt),
                             state.velo.to(edt))
    act = contact_activity(model, state.element_flag)
    out = []
    for i, p in enumerate(model.pairs):
        bp = broad_phase(p, kin, model.ckin_slices[i], act[i],
                         pair_constants(model, p))
        out.append((int(bp.pair_ok.sum()), bool(bp.overlap)))
    return out


def step_until(model, s, pred, limit):
    """One step at a time from ``s`` until ``pred(state)``; that state."""
    from hakai_tpu_torch import run_chunk
    for _ in range(limit):
        if pred(s):
            return s
        s = run_chunk(model, s, 1)
    raise AssertionError(f"not reached within {limit} steps of {int(s.t)}")


def contact_path(model, smi_line):
    """run() on the card: the impact deck, CONTACT_FRAMES frames, a
    checkpoint at every frame, the energy balance and metrics; launches
    counted, frames checked against the alive count, the first contact
    and the first deletion located exactly, a repeat chunk compared."""
    import torch
    from hakai_tpu_torch import init_state, run, run_chunk
    from hakai_tpu_torch.utils.checkpoint import load_checkpoint
    timings = {}
    reset_counts()
    t0 = time.perf_counter()
    final = run(model, timings=timings)
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps, n_pairs = model.time_num, len(model.pairs)
    log(f"\n[contact] launches {launches} for {steps} steps")
    want = {"element[mixed+triax]": steps,
            "assemble[hk_assemble_f32_f64]": steps, "gather": steps,
            "narrow": n_pairs * steps, "scatter": steps}
    if any(launches.get(k) != v for k, v in want.items()):
        raise AssertionError(f"kernel launches {launches} != {want}")
    for f in ("disp", "velo", "Q", "stress", "eq_ps", "triax",
              "contact_force"):
        if not torch.isfinite(getattr(final, f)).all():
            raise AssertionError(f"[contact] {f} is not finite")
    alive = int(final.element_flag.sum())
    frames = sorted(p for p in os.listdir(CONTACT_DIR) if p.endswith(".vtk"))
    cells = [vtk_cells(os.path.join(CONTACT_DIR, p)) for p in frames]
    with open(os.path.join(CONTACT_DIR, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    d_out = steps // CONTACT_FRAMES
    by_step = {r["step"]: int(r["alive_elements"]) for r in recs}
    want_cells = [model.n_element] + [by_step[i * d_out]
                                      for i in range(1, len(frames))]
    fmax = [r["contact_force_max"] for r in recs]
    log(f"[contact] frames {frames} + collection.pvd "
        f"{os.path.exists(os.path.join(CONTACT_DIR, 'collection.pvd'))}; "
        f"CELLS {cells}, alive by metrics {want_cells}; contact_force_max by "
        f"frame {[f'{x:.4e}' for x in fmax]}; energy_rel_error "
        f"{recs[-1]['energy_rel_error']:.3e}; eq_ps max "
        f"{recs[-1]['eq_plastic_strain_max']:.4f}")
    if len(frames) != CONTACT_FRAMES + 1 or cells != want_cells:
        raise AssertionError(f"frames {frames} CELLS {cells} != {want_cells}")
    if cells[-1] != alive or alive >= model.n_element:
        raise AssertionError(f"no element deleted ({alive} alive)")
    # first contact, exactly, one step at a time from the start
    s = step_until(model, init_state(model),
                   lambda s: bool(s.contact_force.abs().max() > 0), d_out)
    first_contact = int(s.t)
    # a state with contact active for the kernel checks
    s_kern = run_chunk(model, s, CONTACT_KERNEL_AFTER)
    # first deletion, exactly: from the checkpoint before its frame
    k = next(i for i, c in enumerate(cells) if c < model.n_element)
    s = (init_state(model) if k == 1 else load_checkpoint(
        os.path.join(CONTACT_DIR, f"ckpt_{k - 1:03d}.npz"), init_state(model)))
    s = step_until(model, s, lambda s: int(s.element_flag.sum())
                   < model.n_element, d_out)
    first_del = int(s.t)
    if not ((k - 1) * d_out < first_del <= k * d_out
            and first_contact < first_del):
        raise AssertionError(f"first deletion {first_del} outside frame {k}")
    # one chunk twice from one checkpoint: bitwise equal
    ck = load_checkpoint(os.path.join(CONTACT_DIR, "ckpt_001.npz"),
                         init_state(model))
    a, b = (run_chunk(model, ck, CONTACT_REPEAT) for _ in range(2))
    fields = ("disp", "velo", "Q", "stress", "eq_ps", "element_flag",
              "contact_force", "work")
    if not all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields):
        raise AssertionError("repeat chunks from one checkpoint differ")
    us = timings["step_s"] / timings["steps"] * 1e6
    blocks = {"at kernel state": block_pairs(model, s_kern),
              "at the end": block_pairs(model, final)}
    log(f"[contact] {model.n_element} elements, {steps} steps: step loop "
        f"{timings['step_s']:.2f} s = {us:.2f} us/step without frame output; "
        f"{timings['frames']} frames in {timings['frame_s']:.2f} s; run() "
        f"wall {wall:.2f} s; first contact at step {first_contact}, first "
        f"deletion at step {first_del}, {alive} of {model.n_element} alive at"
        f" step {steps}; repeat {CONTACT_REPEAT}-step chunks from ckpt_001 "
        f"bitwise equal; surviving block pairs per pair (count, overlap) "
        f"{blocks} [{smi_line}]")
    return launches, final, us, s_kern


def _time_pair(fn, plain, reps=20, plain_reps=3, plain_repeats=REPEATS):
    """(kernel ms, plain ms) of two callables, the method of time_ms."""
    return time_ms(fn, reps=reps), time_ms(plain, reps=plain_reps, warm=1,
                                           repeats=plain_repeats)


def check_gather(kin_src, idx, kind):
    import torch
    from hakai_tpu_torch.ops.gather_cuda import gather_cols, gather_cols_plain
    out = gather_cols(kin_src, idx)
    ref = gather_cols_plain(kin_src, idx)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"gather kernel ({kind}) is not bitwise equal")
    rec = {"max_abs_err": (out - ref).abs().max().item()}
    rec["ms"], rec["plain_ms"] = _time_pair(
        lambda: gather_cols(kin_src, idx), lambda: gather_cols_plain(kin_src,
                                                                     idx))
    idx64 = idx.long()
    rec["library_ms"] = time_ms(lambda: torch.index_select(kin_src, 1, idx64))
    moved = nbytes(kin_src, idx, out)
    rec["bound_ms"], rec["bound_by"] = bound(moved, 0, kind)
    log(f"[contact-kernels] gather {kind} (6, {kin_src.shape[1]}) -> "
        f"{tuple(out.shape)}: bitwise equal; kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, index_select {rec['library_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms ({moved / 1e6:.1f} MB)")
    return rec, out


def _margins(pair, kin, ksl, bp, consts, tri, node):
    """Per listed (triangle, node slot) pair, the smallest relative distance
    of an accept test from its threshold: x1, x2, 1-x1-x2, d, d_lim-d,
    Rmax-dp, and the grid-cell boundaries of both cells."""
    import torch
    from hakai_tpu_torch.ops.contact_cuda import (constants_on, kin_views,
                                                  tri_geometry)
    q0, q1, q2, _, pos_i, _, _ = kin_views(kin, ksl)
    c = constants_on(consts, kin.dtype, kin.device)
    ctr, rmax, _, _, im = tri_geometry(q0[:, tri], q1[:, tri], q2[:, tri], c)
    p = pos_i[:, node]
    dp = torch.sqrt(((p - ctr) ** 2).sum(dim=0))
    b = p - q0[:, tri]
    x1, x2, d = ((r * b).sum(dim=0) for r in im)
    cell = [((x - bp.all_min[:, None]) / c["ddiv"]) for x in (q0[:, tri], p)]
    frac = torch.stack([(y - torch.round(y)).abs().amin(dim=0) for y in cell])
    dl = consts.d_lim
    m = torch.stack([x1.abs(), x2.abs(), (1 - x1 - x2).abs(), d.abs() / dl,
                     (dl - d).abs() / dl, (rmax - dp).abs() / rmax,
                     *frac])
    return m.amin(dim=0)


def check_narrow(model, kin, acts, kind):
    """Kernel N against its plain version per pair, on the card's state, as
    a step calls it: forces, and every node's and every triangle's count of
    accepted pairs.  A count can differ only where a decision lies on a
    threshold: the pairs of a node and a triangle whose counts both differ
    must include one within MARGIN of a threshold for each of them."""
    import torch
    from hakai_tpu_torch.ops.contact import broad_phase
    from hakai_tpu_torch.ops.contact_cuda import (narrow_phase,
                                                  narrow_phase_plain,
                                                  pair_constants)
    tol = CONTACT_TOL[("narrow", kind)]
    force = torch.empty((3, model.fs_width), dtype=kin.dtype,
                        device=kin.device)
    again = torch.empty_like(force)
    stages = dict.fromkeys(("blocks", "tested", "tri_in", "node_in", "cell",
                            "dist", "accept"), 0)
    args, max_abs, worst, n_diff = [], 0.0, 0.0, [0, 0]
    for i, p in enumerate(model.pairs):
        ksl, consts = model.ckin_slices[i], pair_constants(model, p)
        # the float64 instantiation takes the masses in its type
        p = dataclasses.replace(p, cand_mass=p.cand_mass.to(kin.dtype))
        bp = broad_phase(p, kin, ksl, acts[i], consts)
        off_i, off_t = model.fs_offsets[i]
        cols = ((off_i, p.Cp), (off_t, p.Tp))
        per_node, per_tri = narrow_phase(p, kin, ksl, bp, consts, force,
                                         (off_i, off_t), count=True)
        narrow_phase(p, kin, ksl, bp, consts, again, (off_i, off_t))
        fi, ft, info = narrow_phase_plain(p, kin, ksl, bp, consts,
                                          record=True)
        torch.cuda.synchronize()
        if not all(torch.equal(force[:, a:a + n], again[:, a:a + n])
                   for a, n in cols):
            raise AssertionError(f"narrow phase ({kind}) pair {i}: a launch "
                                 f"without counts gives other forces")
        ki, kt = force[:, off_i:off_i + p.Cp], force[:, off_t:off_t + p.Tp]
        errs = (relerr(ki, fi), relerr(kt, ft))
        max_abs = max(max_abs, (ki - fi).abs().max().item(),
                      (kt - ft).abs().max().item())
        worst = max(worst, *errs)
        hit = info["pairs"]
        d_node = torch.nonzero(per_node != torch.bincount(
            hit[:, 1], minlength=p.Cp)).reshape(-1)
        d_tri = torch.nonzero(per_tri != torch.bincount(
            hit[:, 0], minlength=p.Tp)).reshape(-1)
        if len(d_node) or len(d_tri):
            if len(d_node) * len(d_tri) > 1 << 22 or not (len(d_node)
                                                          and len(d_tri)):
                raise AssertionError(f"narrow phase ({kind}) pair {i}: counts"
                                     f" of {len(d_node)} nodes and "
                                     f"{len(d_tri)} triangles differ")
            tt, nn = torch.meshgrid(d_tri, d_node, indexing="ij")
            close = (_margins(p, kin, ksl, bp, consts, tt.reshape(-1),
                              nn.reshape(-1)) <= MARGIN).reshape(tt.shape)
            if not (bool(close.any(dim=0).all())
                    and bool(close.any(dim=1).all())):
                raise AssertionError(f"narrow phase ({kind}) pair {i}: "
                                     f"accept decisions differ away from a "
                                     f"threshold")
        n_diff[0] += len(d_node)
        n_diff[1] += len(d_tri)
        n_blocks = int(bp.pair_ok.sum())
        for k, v in (("blocks", n_blocks), ("tested", n_blocks * p.tb * p.nb),
                     ("tri_in", int(bp.tri_in.sum())),
                     ("node_in", int(bp.node_in.sum())),
                     ("cell", info["cell"]), ("dist", info["dist"]),
                     ("accept", info["accept"])):
            stages[k] += v
        acc = (int(per_node.sum()), int(per_tri.sum()))
        log(f"[contact-kernels] narrow {kind} pair {i}: {n_blocks} block pairs"
            f"; accepts kernel {acc[0]} (node side) {acc[1]} (triangle side), "
            f"plain {info['accept']}; counts differ at {len(d_node)} nodes "
            f"and {len(d_tri)} triangles (each with a pair within {MARGIN:g}"
            f" of a threshold); force_i {errs[0]:.3e} force_t {errs[1]:.3e} "
            f"(tol {tol:g}); a launch without counts: bitwise equal")
        if acc[0] != info["accept"] or acc[1] != info["accept"]:
            raise AssertionError(f"narrow phase ({kind}) accept counts differ")
        if not max(errs) <= tol:
            raise AssertionError(f"narrow phase ({kind}) disagrees: {errs}")
        args.append((p, ksl, bp, consts, (off_i, off_t)))
    if stages["accept"] == 0:
        raise AssertionError("no contact pair accepted: contact not active")
    return args, force, stages, {"max_abs_err": max_abs, "rel": worst,
                                 "differ": n_diff}


def fmad_cost(args, kin, force):
    """Kernel N built as nvcc builds by default, with FMA contraction,
    against the library the port ships (contact.cu with -fmad=false): the
    time of the main path's narrow-phase calls and the normwise difference
    of their forces.  Builds a second library (another key) and restores
    the port's after."""
    import torch
    from hakai_tpu_torch import _build
    from hakai_tpu_torch.ops.contact_cuda import narrow_phase

    def calls(out):
        return lambda: [narrow_phase(p, kin, ksl, bp, c, out, o)
                        for p, ksl, bp, c, o in args]
    shipped = _build._lib, _build.SOURCE_FLAGS
    fused = torch.empty_like(force)
    try:
        _build._lib = None
        _build.SOURCE_FLAGS = {k: tuple(f for f in v if f != "-fmad=false")
                               for k, v in shipped[1].items()}
        t0 = time.perf_counter()
        _build.library()
        built_s = time.perf_counter() - t0
        calls(fused)()
        torch.cuda.synchronize()
        ms = time_ms(calls(fused), reps=10)
    finally:
        _build._lib, _build.SOURCE_FLAGS = shipped
    ms_after = time_ms(calls(force), reps=10)
    err = max(relerr(fused[:, a:a + n], force[:, a:a + n])
              for p, _, _, _, (oi, ot) in args
              for a, n in ((oi, p.Cp), (ot, p.Tp)))
    return ms, ms_after, err, built_s


def rank_shares(args, kin, force, world=2):
    """Kernel N as each of ``world`` ranks calls it on the main path's
    sharded contact (``deal_block_pairs``): each rank's calls timed, and
    the ranks' force buffers summed checked bitwise equal to ``force``, one
    device's.  Returns each rank's ms."""
    import torch
    from hakai_tpu_torch.ops.contact import deal_block_pairs
    from hakai_tpu_torch.ops.contact_cuda import narrow_phase
    total, ms = torch.zeros_like(force), []
    for r in range(world):
        shares = [deal_block_pairs(bp.pair_ok, r, world)
                  for _, _, bp, _, _ in args]
        out = torch.empty_like(force)

        def calls(out=out, shares=shares):
            for (p, ksl, bp, c, o), sides in zip(args, shares):
                narrow_phase(p, kin, ksl, bp, c, out, o, sides=sides)
        calls()
        total += out
        ms.append(time_ms(calls, reps=10))
    torch.cuda.synchronize()
    for p, _, _, _, (oi, ot) in args:
        for a, n in ((oi, p.Cp), (ot, p.Tp)):
            if not torch.equal(total[:, a:a + n], force[:, a:a + n]):
                raise AssertionError("narrow phase: the ranks' shares do not "
                                     "sum to one device's forces")
    return ms


def check_scatter(model, force, out_dtype, kind, ref_lib=None):
    """Kernel S against its plain version (and, given the reference
    library, bitwise against the reference S) on ``force``; times, bound,
    resources."""
    import torch
    from hakai_tpu_torch import _build
    from hakai_tpu_torch.ops.contact_cuda import (scatter_forces,
                                                  scatter_forces_plain)
    tol = CONTACT_TOL[("scatter", kind)]
    g = scatter_forces(model, force, out_dtype)
    ref = scatter_forces_plain(model, force, out_dtype)
    torch.cuda.synchronize()
    err = relerr(g, ref)
    if g.dtype != out_dtype or not err <= tol:
        raise AssertionError(f"scatter kernel ({kind}) disagrees: {err}")
    if not torch.equal(g, scatter_forces(model, force, out_dtype)):
        raise AssertionError("scatter kernel is not deterministic")
    rec = {"max_abs_err": (g - ref).abs().max().item()}
    rec["ms"], rec["plain_ms"] = _time_pair(
        lambda: scatter_forces(model, force, out_dtype),
        lambda: scatter_forces_plain(model, force, out_dtype))
    out = (ctypes.c_int * 5)()
    which = {torch.float32: 0, torch.float64: 1}[force.dtype]
    which = 2 if force.dtype != out_dtype else which
    _build.check(_build.library(), _build.library().hk_scatter_resources(
        which, model.fs_emax, out), "scatter resources")
    rec["res"] = dict(zip(("blocks", "registers", "smem", "local", "dyn"),
                          out))
    if ref_lib is not None:
        if not torch.equal(g, ref_scatter(ref_lib, model, force, out_dtype)):
            raise AssertionError(f"scatter kernel ({kind}) differs from the "
                                 "reference S")
        rec["ref_ms"] = time_ms(lambda: ref_scatter(ref_lib, model, force,
                                                    out_dtype))
    # one PyTorch call for the same sum (another order, atomics): index_add_
    # of the signed contributions into their nodes
    ptr = model.fs_ptr.long()
    node = torch.repeat_interleave(torch.arange(model.N, device=force.device),
                                   ptr[1:] - ptr[:-1])
    sign = torch.where(torch.arange(model.fs_col.shape[0],
                                    device=force.device)
                       < model.fs_mid.long()[node], 1.0, -1.0).to(force.dtype)
    contrib = force[:, model.fs_col.long()] * sign
    zero = torch.zeros((3, model.N), dtype=force.dtype, device=force.device)
    rec["library_ms"] = time_ms(lambda: zero.clone().index_add_(1, node,
                                                                contrib))
    moved = nbytes(model.fs_ptr, model.fs_mid, model.fs_col, force, g)
    rec["bound_ms"], rec["bound_by"] = bound(
        moved, 3 * model.fs_col.shape[0], kind)
    vs = (f"; the reference S {rec['ref_ms']:.4f} ms "
          f"({rec['bound_ms'] / rec['ref_ms']:.3f} of its bound), outputs "
          "bitwise equal" if "ref_ms" in rec else
          "; no reference S (REF_DIR) to hold it against")
    log(f"[contact-kernels] scatter {kind} -> {g.dtype}: rel err {err:.3e} "
        f"(tol {tol:g}); kernel {rec['ms']:.4f} ms "
        f"({rec['bound_ms'] / rec['ms']:.3f} of its bound; blocks of "
        f"{model.fs_nb} nodes, at most {model.fs_emax} entries; "
        f"{_res(rec['res'])}), plain {rec['plain_ms']:.4f} ms, index_add_ "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({moved / 1e6:.1f} MB){vs}")
    return rec


def reference_contact_chunk(model, ref):
    """REF_CONTACT_CHUNK steps of [contact]'s deck from its initial state
    through run_chunk, with the shipped S and with the reference S: every
    state field bit for bit, past the first contact and first deletion."""
    import torch
    from hakai_tpu_torch import init_state, run_chunk
    if ref is None:
        return
    s0 = init_state(model)
    new = run_chunk(model, s0, REF_CONTACT_CHUNK)
    with reference_scatter(ref):
        old = run_chunk(model, s0, REF_CONTACT_CHUNK)
    torch.cuda.synchronize()
    differ = [f.name for f in dataclasses.fields(new)
              if not torch.equal(getattr(new, f.name), getattr(old, f.name))]
    alive, n = int(new.element_flag.sum()), int(model.elem_exists.sum())
    log(f"[contact-kernels] {REF_CONTACT_CHUNK} steps of [contact]'s deck "
        f"with the shipped and the reference S: contact force max "
        f"{new.contact_force.abs().max().item():.4e}, {n - alive} elements "
        f"deleted; fields that differ: {differ or 'none'}")
    if differ:
        raise AssertionError(f"the contact chunk differs from the reference"
                             f" S's: {differ}")
    if alive == n:
        raise AssertionError("the reference contact chunk deleted no "
                             "element")


def contact_kernels(model, state, smi_line, n_launch, ref=None):
    """Kernels G, N and S against their plain versions on the deck's own
    state with contact active, in the main path's types (f32 math, f64
    store) and in float64; times and bounds, N's in both types beside its
    ``n_launch`` CUDA launches a step (from the deck's trace)."""
    import torch
    from hakai_tpu_torch.ops.contact import contact_activity
    from hakai_tpu_torch.ops.contact_cuda import (narrow_phase,
                                                  narrow_phase_plain)
    acts = contact_activity(model, state.element_flag)
    edt = model.edtype
    posvel = torch.cat([(model.coord + state.disp).to(edt),
                        state.velo.to(edt)])
    recs = {}
    for kind, dt in (("float32", torch.float32), ("float64", torch.float64)):
        rec_g, kin = check_gather(posvel.to(dt), model.ckin_idx, kind)
        args, force, stages, rec_n = check_narrow(model, kin, acts, kind)
        out_dtype = torch.float64
        rec_s = check_scatter(model, force, out_dtype,
                              "mixed" if dt == torch.float32 else kind, ref)
        recs[kind] = (rec_g, rec_n, rec_s)

        def step_calls(out=force):
            for p, ksl, bp, c, o in args:
                narrow_phase(p, kin, ksl, bp, c, out, o)
        # N's time: every pair's call, as in a step
        rec_n["ms"], rec_n["plain_ms"] = _time_pair(
            step_calls, lambda: [narrow_phase_plain(p, kin, ksl, bp, c)
                                 for p, ksl, bp, c, _ in args], reps=10,
            plain_reps=1, plain_repeats=1)   # one call of 3-5 s: one batch
        st = stages
        flop = (NARROW_OPS["item"] * (st["tri_in"] + st["node_in"])
                + NARROW_OPS["geometry"] * st["tri_in"]
                + NARROW_OPS["cell"] * st["cell"]
                + NARROW_OPS["dist"] * st["dist"]
                + NARROW_OPS["accept"] * st["accept"])
        item = kin.element_size()
        moved = sum(nbytes(bp.tri_in, bp.node_in, bp.pair_ok)
                    + int(bp.tri_in.sum()) * (12 * item
                                              + 32 * bool(p.is_self))
                    + int(bp.node_in.sum()) * (7 * item + 4)
                    + item * 3 * (p.Cp + p.Tp)
                    for p, _, bp, _, _ in args)
        rec_n["bound_ms"], rec_n["bound_by"] = bound(moved, flop, kind)
        rec_n["library_ms"] = None
        log(f"[contact-kernels] narrow {kind}: {st['blocks']} block pairs, "
            f"{st['tested']:.4e} pairs in them, {st['cell']} within one cell"
            f", {st['dist']} past the radius cull, {st['accept']} accepted; "
            f"kernel {rec_n['ms']:.4f} ms (PR 7's block-loop kernel, float32:"
            f" {NARROW_PR7_MS} ms), plain {rec_n['plain_ms']:.4f} ms, bound "
            f"{rec_n['bound_ms']:.4f} ms ({rec_n['bound_by']}: "
            f"{flop / 1e9:.4f} GFLOP needed, {moved / 1e6:.1f} MB); "
            f"{n_launch:.1f} CUDA launches a step (the trace's narrow_bin, "
            f"narrow_scan, narrow_sort, narrow_probe) for {len(args)} "
            f"wrapper calls [{smi_line}]")
        if kind == "float64":
            break
        ms_ranks = rank_shares(args, kin, force)
        log(f"[contact-kernels] narrow {kind} dealt over {len(ms_ranks)} "
            f"ranks as [sharded-contact] deals it (deal_block_pairs; a rank "
            f"lists only its own blocks' items): "
            + ", ".join(f"rank {r} {t:.4f} ms" for r, t in
                        enumerate(ms_ranks))
            + f" against {rec_n['ms']:.4f} ms on one device; the ranks' "
            f"forces summed: bitwise one device's [{smi_line}]")
        ms_fma, ms_after, err_fma, built_s = fmad_cost(args, kin, force)
        log(f"[contact-kernels] narrow {kind} built with FMA contraction "
            f"(nvcc's default; built in {built_s:.2f} s): {ms_fma:.4f} ms "
            f"against {rec_n['ms']:.4f} ms before and {ms_after:.4f} ms after"
            f" it for the shipped -fmad=false build; forces differ by "
            f"{err_fma:.3e} normwise [{smi_line}]")
    reference_contact_chunk(model, ref)
    return recs["float32"]


def contact_cpu():
    """The tie-free impact (cube off the slab's grid lines; the ductile
    table of the JAX package's multi-host impact test), n=CONTACT_CPU_N,
    mixed, one step at a time on the card and on the CPU: the same first
    contact step and the [fracture] rule on the deletion histories."""
    import numpy as np
    import torch
    from hakai_tpu_torch import SolverConfig, init_state, lower, run_chunk
    from hakai_tpu_torch.pre.synthetic import impact_model, offset_instance
    deck = offset_instance(impact_model(n=CONTACT_CPU_N, v0=8.0e4,
                                        d_time=1e-8, end_time=1e-5),
                           1, 0.013, 0.017)
    deck.materials[0].ductile = np.array([[0.02, 0.0, 30.0],
                                          [0.01, 0.3, 30.0]])
    runs = {}
    for dev in ("cuda", "cpu"):
        m = lower(deck, SolverConfig(dtype="mixed"), device=dev)
        s = init_state(m)
        died = np.full(m.E, -1)
        exists = m.elem_exists.cpu().numpy()
        contact = None
        t0 = time.perf_counter()
        for step in range(1, CONTACT_CPU_STEPS + 1):
            s = run_chunk(m, s, 1)
            flag = s.element_flag.cpu().numpy()
            died[(died < 0) & ~flag & exists] = step
            if contact is None and bool(s.contact_force.abs().max() > 0):
                contact = step
        log(f"[contact-cpu] {dev}: {CONTACT_CPU_STEPS} steps in "
            f"{time.perf_counter() - t0:.2f} s; first contact at step "
            f"{contact}, first deletion at step "
            f"{died[died > 0].min() if (died > 0).any() else None}, "
            f"{(died > 0).sum()} of {m.n_element} deleted")
        runs[dev] = (m, s, died, contact)
    (mg, sg, dg, cg), (mc, sc, dc, cc) = runs["cuda"], runs["cpu"]
    if cc is None or cg != cc:
        raise AssertionError(f"first contact steps differ: {cg} vs {cc}")
    if not (dc > 0).any():
        raise AssertionError("the CPU run deleted no element")
    only, keep, first = one_sided(mg, sg, dg, mc, sc, dc)
    errs = {"disp": relerr(sg.disp.cpu(), sc.disp),
            "contact_force": relerr(sg.contact_force.cpu(), sc.contact_force)}
    log(f"[contact-cpu] card vs cpu at step {CONTACT_CPU_STEPS}: disp "
        f"{errs['disp']:.3e}; first contact {cg} vs {cc}; first deletion "
        f"{first[0]} vs {first[1]}; deleted {(dg > 0).sum()} vs "
        f"{(dc > 0).sum()}, {((dg > 0) & (dg == dc)).sum()} at the same step,"
        f" {len(only)} on one side only (margins {[round(float(x), 5) for x in keep]})"
        f"; rule of [fracture]")
    if not torch.isfinite(sg.disp).all():
        raise AssertionError("card contact run is not finite")
    deletion_rule(only, keep, first, dc)


def generic_run(smi_line, run_first, run_alive):
    """run() on the generic step: [run]'s deck (the mixed ductile bar)
    lowered with gather_mode="xla", its end time cut to GENERIC_STEPS
    steps (the amplitude ramp kept), GENERIC_FRAMES frames with a
    checkpoint at each, energy balance and metrics; launches counted,
    frames checked against the alive count, the first deletion located
    exactly and set beside [run]'s (another loop: they need not agree)."""
    import torch
    from hakai_tpu_torch import SolverConfig, init_state, lower, run
    from hakai_tpu_torch.pre.synthetic import bar_model
    from hakai_tpu_torch.utils.checkpoint import load_checkpoint
    shutil.rmtree(GENERIC_DIR, ignore_errors=True)
    os.makedirs(GENERIC_DIR)
    deck = bar_model(NX, NY, NZ, d_time=1e-8, end_time=RUN_END, ductile=True)
    deck.end_time = (GENERIC_STEPS + 0.5) * deck.d_time
    t0 = time.perf_counter()
    model = lower(deck, SolverConfig(
        dtype="mixed", gather_mode="xla", output_num=GENERIC_FRAMES,
        energy_check=True, checkpoint_every=1, out_dir=GENERIC_DIR,
        metrics_path=os.path.join(GENERIC_DIR, "metrics.jsonl")),
        device="cuda")
    torch.cuda.synchronize()
    log(f"[generic] mixed ductile bar, gather_mode=xla: E={model.E} "
        f"N={model.N} coord_e={model.coord_e is not None} renumbered="
        f"{model.node_new2old is not None}, lowered in "
        f"{time.perf_counter() - t0:.2f} s")
    if model.coord_e is not None or model.time_num != GENERIC_STEPS:
        raise AssertionError("the generic deck is not on the generic step")
    timings = {}
    reset_counts()
    t0 = time.perf_counter()
    final = run(model, timings=timings)
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps = model.time_num
    log(f"\n[generic] launches {launches} for {steps} steps")
    want = {"update": steps, "update[float32+triax]": steps,
            "assemble[hk_assemble_f32_f64]": steps, "element": 0}
    if any(launches.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"kernel launches {launches} != {want}")
    for f in ("disp", "velo", "Q", "stress", "eq_ps", "triax"):
        if not torch.isfinite(getattr(final, f)).all():
            raise AssertionError(f"[generic] {f} is not finite")
    alive = int(final.element_flag.sum())
    frames = sorted(p for p in os.listdir(GENERIC_DIR) if p.endswith(".vtk"))
    cells = [vtk_cells(os.path.join(GENERIC_DIR, p)) for p in frames]
    with open(os.path.join(GENERIC_DIR, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    d_out = steps // GENERIC_FRAMES
    by_step = {r["step"]: int(r["alive_elements"]) for r in recs}
    want_cells = [model.n_element] + [by_step[i * d_out]
                                      for i in range(1, len(frames))]
    if len(frames) != GENERIC_FRAMES + 1 or cells != want_cells:
        raise AssertionError(f"frames {frames} CELLS {cells} != {want_cells}")
    if alive >= model.n_element:
        raise AssertionError(f"no element deleted ({alive} alive)")
    k = next(i for i, c in enumerate(cells) if c < model.n_element)
    s = (init_state(model) if k == 1 else load_checkpoint(
        os.path.join(GENERIC_DIR, f"ckpt_{k - 1:03d}.npz"),
        init_state(model)))
    s = step_until(model, s, lambda s: int(s.element_flag.sum())
                   < model.n_element, d_out)
    first = int(s.t)
    us = timings["step_s"] / timings["steps"] * 1e6
    common = sorted(set(by_step) & set(run_alive))
    log(f"[generic] {model.n_element} elements mixed ductile on the generic "
        f"step, {steps} steps: step loop {timings['step_s']:.2f} s = "
        f"{us:.2f} us/step ({model.n_element / us * 1e6:.6e} elem-steps/s) "
        f"without frame output; {timings['frames']} frames in "
        f"{timings['frame_s']:.2f} s; run() wall {wall:.2f} s; CELLS "
        f"{cells}; energy_rel_error {recs[-1]['energy_rel_error']:.3e}; "
        f"first deletion at step {first} (packed [run]: {run_first}); "
        f"alive by step {[(t, by_step[t], run_alive[t]) for t in common]} "
        f"(generic, packed); {alive} alive at step {steps} [{smi_line}]")
    return model, launches, final, us


def generic_cpu():
    """The ductile 4x4x16 bar (below 2,048 elements: the generic step),
    pulled over 800 steps, one step at a time to GCPU_STEPS on the card
    and on the CPU: in float64 the deletion histories are equal; in mixed
    precision they follow the rule of [fracture]."""
    import numpy as np
    import torch
    from hakai_tpu_torch import SolverConfig, init_state, lower, run_chunk
    from hakai_tpu_torch.pre.synthetic import bar_model
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=4e-5, ductile=True)
    for kind in ("float64", "mixed"):
        runs = {}
        for dev in ("cuda", "cpu"):
            m = lower(bar, SolverConfig(dtype=kind), device=dev)
            if m.coord_e is not None:
                raise AssertionError("the deck is not on the generic step")
            s = init_state(m)
            died = np.full(m.E, -1)
            exists = m.elem_exists.cpu().numpy()
            t0 = time.perf_counter()
            for step in range(1, GCPU_STEPS + 1):
                s = run_chunk(m, s, 1)
                flag = s.element_flag.cpu().numpy()
                died[(died < 0) & ~flag & exists] = step
            runs[dev] = (m, s, died, time.perf_counter() - t0)
        (mg, sg, dg, tg), (mc, sc, dc, tc) = runs["cuda"], runs["cpu"]
        only, keep, first = one_sided(mg, sg, dg, mc, sc, dc)
        equal = bool(np.array_equal(dg, dc))
        log(f"[generic-cpu] {kind}: {GCPU_STEPS} single steps in {tg:.2f} s "
            f"(card) and {tc:.2f} s (CPU); first deletion {first[0]} vs "
            f"{first[1]}; deleted {(dg > 0).sum()} vs {(dc > 0).sum()} of "
            f"{mg.n_element}; histories equal: {equal}; disp "
            f"{relerr(sg.disp.cpu(), sc.disp):.3e}, triax "
            f"{relerr(sg.triax.cpu(), sc.triax):.3e} normwise")
        if not torch.isfinite(sg.disp).all() or not (dc > 0).any():
            raise AssertionError(f"[generic-cpu] {kind}: no deletion or "
                                 "not finite")
        if kind == "float64" and not equal:
            raise AssertionError("float64 deletion histories differ")
        deletion_rule(only, keep, first, dc)


def vtk_sections(text):
    """A legacy VTK file as [(header line, [data lines])]."""
    out, lines = [], text.splitlines()
    out.append(("\n".join(lines[:4]), []))
    for line in lines[4:]:
        if line[:1].isalpha():
            out.append((line, []))
        else:
            out[-1][1].append(line)
    return out


def frames_close(dir_a, dir_b, rel=1e-6):
    """Frames of two runs: the same files and section headers, equal
    connectivity and cell types, every float field within ``rel`` of its
    largest magnitude.  Returns (frames, byte-identical lines share)."""
    import numpy as np
    names = sorted(p for p in os.listdir(dir_a) if p.endswith(".vtk"))
    if names != sorted(p for p in os.listdir(dir_b) if p.endswith(".vtk")):
        raise AssertionError(f"frame files differ: {dir_a} {dir_b}")
    same = total = 0
    for name in names:
        with open(os.path.join(dir_a, name)) as fa, \
                open(os.path.join(dir_b, name)) as fb:
            ref, got = vtk_sections(fa.read()), vtk_sections(fb.read())
        if [h for h, _ in got] != [h for h, _ in ref]:
            raise AssertionError(f"{name}: section headers differ")
        for (head, a), (_, b) in zip(ref, got):
            same += sum(x == y for x, y in zip(a, b))
            total += len(a)
            if head.startswith(("CELLS", "CELL_TYPES")):
                if a != b:
                    raise AssertionError(f"{name}: {head} differs")
            elif a:
                xa = np.array([x.split() for x in a], np.float64)
                xb = np.array([x.split() for x in b], np.float64)
                scale = max(np.abs(xa).max(), 1e-300)
                if not np.abs(xa - xb).max() <= rel * scale:
                    raise AssertionError(f"{name}: {head} differs")
    return names, same / max(total, 1)


def run_cli(args, timeout):
    """``python -m hakai_tpu_torch`` with ``args`` from the checkout's
    root; (stdout, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "hakai_tpu_torch", *args],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"CLI {args} exited {r.returncode}:\n"
                             f"{r.stderr[-3000:]}")
    return r.stdout, time.perf_counter() - t0


def cli_phase(smi_line):
    """The CLI: a small written deck on the card and on the CPU, frames
    compared; then [run]'s and [contact]'s decks through the CLI, mixed at
    full depth (frames byte for byte) and f64 cut in depth, each with the
    energy guard at its default and its peak energy_rel_error printed."""
    import re
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from inp_deck import write_deck
    from hakai_tpu_torch.pre.synthetic import bar_model, impact_model
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    small = write_deck(os.path.join(CLI_DIR, "small.inp"), bar_model(
        4, 4, 16, d_time=5e-8, end_time=4e-5, ductile=True))
    heads = {}
    for dev in ("cuda", "cpu"):
        out, sec = run_cli([small, "--out-dir", os.path.join(CLI_DIR, dev),
                            "--output-num", "10", "--device", dev], 600)
        heads[dev] = [x for x in re.split(r"[\r\n]", out)
                      if x.startswith(("nNode", "nElement", "time_num",
                                       "element", "Element"))
                      or "Element deleted" in x]
        log(f"[cli] small deck --device {dev}: {sec:.2f} s in all")
    heads = {k: [x[x.index("Element"):] if "Element deleted" in x else x
                 for x in v] for k, v in heads.items()}
    names, share = frames_close(os.path.join(CLI_DIR, "cuda"),
                                os.path.join(CLI_DIR, "cpu"))
    log(f"[cli] small deck: console lines {heads['cuda']} (card) equal to "
        f"the CPU's: {heads['cuda'] == heads['cpu']}; {len(names)} frames "
        f"within 1e-6 of each field's scale, {share:.4f} of the data lines "
        f"byte-identical")
    if heads["cuda"] != heads["cpu"] or not any(
            "Element deleted" in x for x in heads["cuda"]):
        raise AssertionError(f"[cli] console lines differ: {heads}")
    from hakai_tpu_torch import _build
    _build.host_library()
    host_lib = _build.HOST_INFO["path"]
    big = bar_model(NX, NY, NZ, d_time=1e-8, end_time=RUN_END, ductile=True)
    t0 = time.perf_counter()
    path = write_deck(os.path.join(CLI_DIR, "bar.inp"), big)
    t_write = time.perf_counter() - t0
    log(f"[cli] [run]'s deck ({big.n_element} elements, "
        f"{os.path.getsize(path) / 1e6:.1f} MB, written in {t_write:.2f} s)")
    cli_run("[run]'s deck", path, "bar", "mixed", RUN_END / 1e-8,
            RUN_FRAMES, RUN_DIR, host_lib, smi_line)
    big.end_time = (CLI_STEPS + 0.5) * big.d_time      # the ramp kept
    cut = write_deck(os.path.join(CLI_DIR, "bar_cut.inp"), big)
    cli_run("[run]'s deck", cut, "bar_f64", "f64", CLI_STEPS,
            CLI_F64_RECORDS, None, host_lib, smi_line, RUN_END / 1e-8)
    impact = impact_model(n=CONTACT_N, v0=CONTACT_V0, d_time=CONTACT_DT,
                          end_time=CONTACT_END)
    t0 = time.perf_counter()
    path = write_deck(os.path.join(CLI_DIR, "impact.inp"), impact)
    t_write = time.perf_counter() - t0
    log(f"[cli] [contact]'s deck ({impact.n_element} elements, "
        f"{os.path.getsize(path) / 1e6:.1f} MB, written in {t_write:.2f} s)")
    cli_run("[contact]'s deck", path, "impact", "mixed",
            CONTACT_END / CONTACT_DT, CONTACT_FRAMES, CONTACT_DIR, host_lib,
            smi_line)
    impact.end_time = (CLI_CONTACT_STEPS + 0.5) * impact.d_time
    cut = write_deck(os.path.join(CLI_DIR, "impact_cut.inp"), impact)
    cli_run("[contact]'s deck", cut, "impact_f64", "f64", CLI_CONTACT_STEPS,
            CLI_F64_RECORDS, None, host_lib, smi_line,
            CONTACT_END / CONTACT_DT)


def cli_run(what, deck, tag, precision, steps, frames, ref_dir, host_lib,
            smi_line, cut_from=None):
    """One of the CLI's owed runs: ``deck`` (of ``steps`` steps, cut in
    depth from ``cut_from``) through ``python -m hakai_tpu_torch`` at
    ``precision``, the energy guard at its default and ``--metrics`` on,
    ``frames`` chunks; with ``ref_dir``, its frames byte-identical to that
    run's, else no frames.  Prints the peak ``energy_rel_error`` beside the
    guard's abort."""
    steps = int(round(steps))
    out_dir = os.path.join(CLI_DIR, tag)
    metrics = out_dir + ".jsonl"
    args = [deck, "--precision", precision, "--out-dir", out_dir,
            "--output-num", str(frames), "--metrics", metrics, "--timings"]
    out, sec = run_cli(args + ([] if ref_dir else ["--no-output"]), 900)
    if f"time_num:{steps}" not in out:
        raise AssertionError(f"[cli] time_num line: {out[:400]}")
    timing = next(x for x in out.splitlines() if x.startswith("timings:"))
    helper = next(x for x in out.splitlines() if x.startswith("host-io:"))
    if helper != f"host-io: C++ helper {host_lib}":
        raise AssertionError(f"[cli] {helper!r}, not {host_lib}")
    with open(metrics) as f:
        errs = [json.loads(x)["energy_rel_error"] for x in f]
    peak = max(errs)
    same, said = [], "no frames"
    if ref_dir:
        for i in range(frames + 1):
            name = f"file{i:03d}.vtk"
            with open(os.path.join(out_dir, name), "rb") as fa, \
                    open(os.path.join(ref_dir, name), "rb") as fb:
                same.append(fa.read() == fb.read())
        said = (f"frames at steps "
                f"{[i * steps // frames for i in range(frames + 1)]} "
                f"byte-identical to {os.path.basename(ref_dir)}'s: {same}")
    cut = f" (cut in depth from {cut_from:.0f})" if cut_from else ""
    log(f"[cli] {what} through the CLI, {precision}, {steps} steps{cut}: "
        f"{timing}; {helper}; subprocess {sec:.2f} s in all; peak "
        f"energy_rel_error {peak:.3e} over {len(errs)} records (the "
        f"guard's default abort: {ENERGY_ABORT}); {said} [{smi_line}]")
    if len(errs) != frames or not peak <= ENERGY_ABORT:
        raise AssertionError(f"[cli] energy records {errs}")
    if not all(same):
        raise AssertionError(f"[cli] frames differ from {ref_dir}'s")


def host_cpu() -> str:
    """The host CPU: /proc/cpuinfo's model name (else its vendor, family
    and model numbers, else the machine type) and the logical cores."""
    import platform
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, sep, value = line.partition(":")
                if not sep:
                    if info:
                        break           # the first processor's block
                    continue
                info.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    name = info.get("model name") or " ".join(
        f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model")
        if k in info) or platform.machine()
    return f"{name}, {os.cpu_count()} logical cores"


def host_io_phase(model, state, smi_line):
    """[host-io]: the C++ helper's build; [cli]'s deck text parsed through
    the helper and through its Python twin, and [run]'s last frame (from
    ``state``) written through the helper and through the twins, each
    timed; equal arrays, equal bytes, and the frame equal to [run]'s."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from inp_deck import deck_text
    from hakai_tpu_torch import _build
    from hakai_tpu_torch.io import native, vtk
    from hakai_tpu_torch.pre.synthetic import bar_model
    from hakai_tpu_torch.solver.explicit import _deck_order_frame
    from hakai_tpu_torch.solver.output import node_fields
    info = dict(_build.HOST_INFO)
    text = deck_text(bar_model(NX, NY, NZ, d_time=1e-8, end_time=RUN_END,
                               ductile=True))
    t0 = time.perf_counter()
    got = native.parse_numbers(text)
    t_helper = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = native.parse_numbers_plain(text)
    t_plain = time.perf_counter() - t0
    parsed_same = (got.shape == ref.shape and np.array_equal(got, ref)
                   and np.array_equal(np.signbit(got), np.signbit(ref)))
    nd = node_fields(model, state.stress, state.strain, state.eq_ps,
                     state.triax)
    frame = _deck_order_frame(model, state.disp, state.velo,
                              state.element_flag, nd)
    index = RUN_FRAMES
    out = os.path.join(RUN_DIR, "host_io")
    t0 = time.perf_counter()
    a = vtk.write_vtk(index, os.path.join(out, "helper"), *frame,
                      model.n_node, model.n_element)
    f_helper = time.perf_counter() - t0
    keep = vtk.format_e_rows, vtk.format_i_rows
    vtk.format_e_rows = native.format_e_rows_plain
    vtk.format_i_rows = native.format_i_rows_plain
    try:
        t0 = time.perf_counter()
        b = vtk.write_vtk(index, os.path.join(out, "plain"), *frame,
                          model.n_node, model.n_element)
        f_plain = time.perf_counter() - t0
    finally:
        vtk.format_e_rows, vtk.format_i_rows = keep
    with open(a, "rb") as fa, open(b, "rb") as fb, \
            open(os.path.join(RUN_DIR, f"file{index:03d}.vtk"), "rb") as fr:
        ba, bb, br = fa.read(), fb.read(), fr.read()
    log(f"[host-io] helper {info['path']} (compiler {info['compiler'][0]}),"
        f" built={info['built']} in {info['seconds']:.3f} s; [cli]'s deck "
        f"text {len(text) / 1e6:.1f} MB, {len(got)} numbers: helper "
        f"{t_helper:.3f} s, twin {t_plain:.3f} s, equal arrays "
        f"{parsed_same}; [run]'s frame {index} ({len(ba) / 1e6:.1f} MB): "
        f"write_vtk through the helper {f_helper:.3f} s, through the twins "
        f"{f_plain:.3f} s, equal bytes {ba == bb}, equal to [run]'s frame "
        f"{ba == br}; host CPU {host_cpu()} [{smi_line}]")
    if not (parsed_same and ba == bb == br):
        raise AssertionError("[host-io] the helper and its twins differ")
    shutil.rmtree(out)


def grouped_plan(model):
    """The node-block-major grouping of ``model``'s incidence table as a
    grouped plan on its device: output tile b sums its V slot tiles of
    GROUPED_R_TILE nodes in the order v = 0..V-1 (vl = V)."""
    import numpy as np
    from hakai_tpu_torch.ops.assemble_cuda import plan_assemble
    idx, mask = (x.cpu().numpy() for x in (model.inc_idx, model.inc_mask))
    V, N = idx.shape
    nblk = -(-N // GROUPED_R_TILE)

    def grouped(a):
        return np.pad(a, ((0, 0), (0, nblk * GROUPED_R_TILE - N))).reshape(
            V, nblk, GROUPED_R_TILE).transpose(1, 0, 2).reshape(-1)
    return plan_assemble(grouped(idx), grouped(mask), 8 * model.E, V,
                         GROUPED_R_TILE).to(model.device)


def check_grouped(model, rng, name, out_dtype=None, ref=None):
    """The grouped entry (TPU kernels #9/#10) against its plain version and
    bitwise against kernel B on one random qe, and bitwise against the
    reference design ``ref`` where there is one; returns the JSON record's
    numbers."""
    import torch
    from hakai_tpu_torch.ops.assemble_cuda import (assemble_internal_force,
                                                   blocked_assemble,
                                                   blocked_assemble_plain)
    qe = torch.as_tensor(rng.normal(scale=100.0, size=(24, model.E)),
                         device=model.device).to(model.edtype).contiguous()
    out_dtype = qe.dtype if out_dtype is None else out_dtype
    plan = grouped_plan(model)
    src = qe.view(3, 8 * model.E)
    Ok = blocked_assemble(src, plan, out_dtype)
    Op = blocked_assemble_plain(src, plan).to(out_dtype)
    QB = assemble_internal_force(model, qe, out_dtype)
    torch.cuda.synchronize()
    kind = kind_of(model)
    tol = TOL[("assemble", kind)]
    err = relerr(Ok, Op)
    max_abs = (Ok - Op).abs().max().item()
    same = torch.equal(Ok[:, :model.N], QB)
    log(f"[grouped-asm] {name} {kind} N={model.N}, vl={plan.vl}, r_tile="
        f"{plan.r_tile}, r_pad={plan.r_pad}: {qe.dtype} -> {Ok.dtype}, rel "
        f"err {err:.3e} (tol {tol:g}); max_abs={max_abs:.3e}; bitwise equal "
        f"to kernel B: {same}")
    if Ok.dtype != out_dtype or tuple(Ok.shape) != (3, plan.r_pad // plan.vl):
        raise AssertionError(f"grouped entry wrote {Ok.dtype} {Ok.shape}")
    if not err <= tol:
        raise AssertionError(f"grouped assembly kernel disagrees: {err}")
    if not same:
        raise AssertionError("grouped entry differs from kernel B")
    if not torch.equal(Ok, blocked_assemble(src, plan, out_dtype)):
        raise AssertionError("grouped assembly kernel is not deterministic")
    rec = {"max_abs_err": max_abs}
    rec["ms"] = time_ms(lambda: blocked_assemble(src, plan, out_dtype))
    rec["plain_ms"] = time_ms(
        lambda: blocked_assemble_plain(src, plan).to(out_dtype), reps=10)
    rec["library_err"], rec["library_ms"] = index_add_yardstick(
        model, qe, out_dtype, Op[:, :model.N])
    moved = nbytes(src, plan.idx, plan.mask, Ok)
    ops = 3 * int(plan.mask.sum())
    rec["bound_ms"], rec["bound_by"] = bound(moved, ops, kind)
    vs_reference(rec, ref, 3 + ("float32", "float64", "mixed").index(kind),
                 lambda: blocked_assemble(src, plan, out_dtype), Ok,
                 slots=plan.vl)
    log(f"[grouped-asm] {name} {kind}: kernel {rec['ms']:.4f} ms "
        f"({rec['bound_ms'] / rec['ms']:.3f} of bound; kernel B "
        f"on the same qe: see [kernels]), plain {rec['plain_ms']:.4f} ms, "
        f"index_add_ {rec['library_ms']:.4f} ms (rel err "
        f"{rec['library_err']:.1e}), bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}: {moved / 1e6:.1f} MB, {ops / 1e6:.2f} Mop)")
    return rec


def grouped_path(model, ref, smi_line):
    """run_chunk on ``model`` carrying the grouped plan, N2 steps from its
    initial state: every step assembles through the grouped entry and
    none through kernel B, and the state equals ``ref`` (the same run
    without the plan) bit for bit."""
    import torch
    from hakai_tpu_torch import init_state, run_chunk
    grouped = dataclasses.replace(model, plan_asm=grouped_plan(model))
    reset_counts()
    t0 = time.perf_counter()
    s = run_chunk(grouped, init_state(grouped), N2)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts()
    want = {"grouped": N2, "grouped[hk_blocked_assemble_f32]": N2,
            "assemble": 0, "element": N2}
    diff = [f.name for f in dataclasses.fields(s)
            if not torch.equal(getattr(s, f.name), getattr(ref, f.name))]
    log(f"[grouped-asm] bench bar with a grouped plan_asm through run_chunk, "
        f"{N2} steps in {sec:.2f} s: launches {launches}; fields differing "
        f"from the run without the plan: {diff} [{smi_line}]")
    if any(launches.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"kernel launches {launches} != {want}")
    if diff:
        raise AssertionError(f"the grouped run differs in {diff}")
    return launches


def shard_backend():
    """(backend, words): NCCL with a rank per card where the machine has
    SHARD_RANKS cards, else gloo with the ranks sharing the one card."""
    import torch
    if torch.cuda.device_count() >= SHARD_RANKS:
        return "nccl", f"{SHARD_RANKS} ranks, one per card"
    return "gloo", f"{SHARD_RANKS} ranks sharing one card (not scaling)"


def cut_to(model, steps, **cfg):
    """``model`` with its run cut to ``steps`` steps (the amplitude tables
    kept, so the steps are the full run's) and its config changed."""
    return dataclasses.replace(
        model, time_num=steps, end_time=steps * model.dt,
        config=dataclasses.replace(model.config, **cfg))


def _top(rec) -> str:
    """A traced job's host ops of the most self time, as 'name us; ...'."""
    return "; ".join(f"{k} {us:.1f}" for k, us in rec["host_top"])


def state_diff(a, b) -> list:
    """The state fields in which ``a`` and ``b`` differ (any device)."""
    import torch
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name).cpu(),
                               getattr(b, f.name).cpu())]


def sharded_phase(bench, gen, cut, impact, smi_line):
    """One launch of SHARD_RANKS ranks running sharded chunks: the bench
    bar in the packed loop and on the generic step (bitwise against one
    device, us/step, the all-gathers' share, rank 0's device busy), then
    the single steps around [sharded-run]'s first deletion and
    [sharded-contact]'s first contact and first deletion, from the one
    device states SHARD_LEAD steps before them (a sharded run is bitwise
    the one-device run, so these are its states too).  Returns (the
    launch's records, the one-device states the jobs started from)."""
    import torch
    from hakai_tpu_torch import init_state, run_chunk
    from hakai_tpu_torch.parallel.dist import launch
    from hakai_tpu_torch.parallel.sharding import chunk_rank
    backend, setup = shard_backend()
    starts = {"cut": run_chunk(cut, init_state(cut),
                               SHARD_RUN_FIRST - SHARD_LEAD)}
    starts["contact"] = run_chunk(impact, init_state(impact),
                                  CONTACT_FIRST - SHARD_LEAD)
    starts["contact_del"] = run_chunk(impact, starts["contact"],
                                      CONTACT_FIRST_DEL - CONTACT_FIRST)
    single = [1] * SHARD_LEAD
    jobs = [dict(model=bench.to("cpu"), chunks=[SHARD_STEPS["packed f32"]],
                 warm=SHARD_WARM, trace=SHARD_TRACE),
            dict(model=gen.to("cpu"), chunks=[SHARD_STEPS["generic f32"]],
                 warm=SHARD_WARM, trace=SHARD_TRACE),
            dict(model=cut.to("cpu"), state=starts["cut"].to("cpu"),
                 chunks=single)]
    impact_cpu = impact.to("cpu")
    jobs += [dict(model=impact_cpu, state=starts[k].to("cpu"), chunks=single)
             for k in ("contact", "contact_del")]
    # [halo]'s jobs, in the same launch (jobs 5-9)
    jobs += [dict(j, halo=True) for j in jobs[:5]]
    t0 = time.perf_counter()
    res = launch(chunk_rank, SHARD_RANKS, "cuda", backend, jobs)
    log(f"[sharded] {backend}, {setup}: one launch of {len(jobs)} jobs "
        f"([halo]'s included) in {time.perf_counter() - t0:.2f} s (spawn, "
        f"model transfer, partitions and every chunk)")
    refs = {}
    for tag, m, r, kernel in (("packed f32", bench, res[0],
                               "element_core_packed"),
                              ("generic f32", gen, res[1],
                               "element_update")):
        n = SHARD_STEPS[tag]
        refs[tag] = ref = run_chunk(m, init_state(m), n)
        diff = state_diff(r["state"], ref)
        sec, coll = r["seconds"][0], r["collective_s"][0]
        us = sec / n * 1e6
        log(f"[sharded] bench bar {tag}, {n} steps: {us:.2f} "
            f"us/step on the host clock, all-gathers {coll * 1e3:.2f} ms = "
            f"{coll / sec:.4f} of the chunk (CUDA events); rank 0 device "
            f"busy {r['busy_us']:.2f} us/step, {r['kernels']:.1f} kernels/"
            f"step, idle share {1.0 - r['busy_us'] / us:.4f} of its step; "
            f"rank 0 host ops of the most self time (us/step, traced) "
            f"{_top(r)}; rank 0 launches {r['launches']}; fields differing "
            f"from one "
            f"device: {diff} [{smi_line}]")
        want = {kernel: n, "assemble_internal_force": n}
        if any(r["launches"][k] != v for k, v in want.items()):
            raise AssertionError(f"[sharded] launches {r['launches']}")
        if diff:
            raise AssertionError(f"[sharded] {tag} differs in {diff}")
        r.update(us=us, share=coll / sec)
    if not (int(starts["cut"].element_flag.sum()) == cut.n_element
            and float(starts["contact"].contact_force.abs().max()) == 0.0
            and int(starts["contact_del"].element_flag.sum())
            == impact.n_element):
        raise AssertionError("[sharded] a job starts past its event")
    return res, starts, refs


def halo_phase(res, refs, cut, impact, smi_line):
    """[halo]: the halo jobs of [sharded]'s launch (``res``: the bench bar
    packed and generic, then the single steps from [sharded]'s one-device
    states): each bar against one device's state (``refs``) normwise at
    HALO_TOL, with its partition, us/step, the exchanges' share and rank
    0's trace; the first deletion and first contact and first deletion to
    the step.  Returns rank 0's launches by the kernels JSON's keys."""
    counts = {}

    def count(key, n):
        counts[key] = counts.get(key, 0) + n
    for (tag, kernel, key), r in zip(
            (("packed f32", "element_core_packed", "element[float32]"),
             ("generic f32", "element_update", "update[float32+triax]")),
            res[:2]):
        p, ref, n = r["partition"], refs[tag], SHARD_STEPS[tag]
        errs = {k: relerr(getattr(r["state"], k).to(ref.disp.device),
                          getattr(ref, k)) for k in HALO_TOL}
        sec, coll = r["seconds"][0], r["collective_s"][0]
        us = sec / n * 1e6
        log(f"[halo] bench bar {tag}, {HALO_RANKS} gloo ranks sharing the "
            f"card: partition No={p['No']} H={p['H']} W={p['W']} El={p['El']}"
            f" packed={p['packed']}, {p['exchange_bytes']} B on the "
            f"exchanges a step and rank; {n} steps: {us:.2f} us/"
            f"step on the host clock, exchanges {coll * 1e3:.2f} ms = "
            f"{coll / sec:.4f} of the chunk (CUDA events); rank 0 device busy"
            f" {r['busy_us']:.2f} us/step, {r['kernels']:.1f} kernels/step, "
            f"idle share {1.0 - r['busy_us'] / us:.4f} of its step; rank 0 "
            f"host ops of the most self time (us/step, traced) {_top(r)}; "
            f"rank 0 launches {r['launches']}; normwise from one device: "
            + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {HALO_TOL}) [{smi_line}]")
        want = {kernel: n, "assemble_internal_force": n}
        if any(r["launches"][k] != v for k, v in want.items()):
            raise AssertionError(f"[halo] launches {r['launches']}")
        bad = {k: v for k, v in errs.items() if not v <= HALO_TOL[k]}
        if bad or p["packed"] != (tag == "packed f32"):
            raise AssertionError(f"[halo] {tag} parts from one device: {bad}")
        count(key, r["launches"][kernel])
        count("assemble[hk_assemble_f32]",
              r["launches"]["assemble_internal_force"])
    a, c, d = res[2]["alive"], res[3]["contact_max"], res[4]["alive"]
    events = (a[-2] == cut.n_element > a[-1], c[-2] == 0 < c[-1],
              d[-2] == impact.n_element > d[-1])
    log(f"[halo] single halo steps from the one-device states: [run]'s deck "
        f"alive {a} (first deletion at {SHARD_RUN_FIRST}: {events[0]}), "
        f"[contact]'s contact force max {c} (first contact at "
        f"{CONTACT_FIRST}: {events[1]}) and alive {d} (first deletion at "
        f"{CONTACT_FIRST_DEL}: {events[2]}); partitions "
        f"{[r['partition'] for r in res[2:4]]}")
    if not all(events):
        raise AssertionError("[halo] an event moved from its step")
    for r in res[2:]:
        L = r["launches"]
        count("element[mixed+triax]", L["element_core_packed"])
        count("assemble[hk_assemble_f32_f64]", L["assemble_internal_force"])
        for k, name in (("gather", "gather_cols"), ("narrow", "narrow_phase"),
                        ("scatter", "scatter_forces")):
            count(k, L[name])
    return counts


def vtk_close(path_a, path_b, rel):
    """Two frames (test_run_halo_packed_vtk's rule): the same text but for
    their floats, and each float within ``rel`` relative and ``rel`` of the
    frame's largest magnitude.  Returns (largest deviation over the frame's
    scale, the share of byte-identical lines).  The floats are compared as
    one array: a full-width frame has millions of them."""
    import numpy as np
    import re
    num = re.compile(r"-?\d+\.\d+e[+-]\d+")
    with open(path_a) as fa, open(path_b) as fb:
        ta, tb = fa.read(), fb.read()
    if num.sub("#", ta) != num.sub("#", tb):
        raise AssertionError(f"{path_b}: text other than floats differs "
                             f"from {path_a}")
    xa, xb = (np.array(num.findall(t), float) for t in (ta, tb))
    scale = float(np.abs(xa).max())
    dev = np.abs(xa - xb)
    bad = np.nonzero(dev > rel * np.abs(xb) + rel * scale)[0]
    if len(bad):
        raise AssertionError(f"{path_b}: float {bad[0]}: {xa[bad[0]]!r} vs "
                             f"{xb[bad[0]]!r}")
    la, lb = ta.splitlines(), tb.splitlines()
    return (float(dev.max()) / scale,
            sum(a == b for a, b in zip(la, lb)) / len(la))


def halo_run(cut, smi_line):
    """[halo-run]: run(halo=HALO_RANKS) of [run]'s deck cut to
    SHARD_RUN_STEPS steps (metrics and the energy balance on, a shard-major
    checkpoint at its one frame): the alive count near [run]'s, the frames'
    CELLS equal to it, frame 0 byte-identical to [run]'s and frame 1 within
    HALO_FRAME_REL, the checkpoint reloaded here to the returned state."""
    from hakai_tpu_torch import run
    from hakai_tpu_torch.parallel.halo import (gather_state,
                                               is_halo_checkpoint,
                                               load_halo_checkpoint,
                                               partition)
    hcut = cut_to(cut, SHARD_RUN_STEPS, out_dir=HALO_RUN_DIR,
                  metrics_path=os.path.join(HALO_RUN_DIR, "metrics.jsonl"))
    shutil.rmtree(HALO_RUN_DIR, ignore_errors=True)
    os.makedirs(HALO_RUN_DIR)
    timings = {}
    t0 = time.perf_counter()
    final = run(hcut, halo=HALO_RANKS, dist_backend="gloo", timings=timings)
    wall = time.perf_counter() - t0
    alive = int(final.element_flag.sum())
    cells = [vtk_cells(os.path.join(HALO_RUN_DIR, f"file{i:03d}.vtk"))
             for i in range(2)]
    with open(os.path.join(HALO_RUN_DIR, "file000.vtk"), "rb") as fa, \
            open(os.path.join(RUN_DIR, "file000.vtk"), "rb") as fb:
        same0 = fa.read() == fb.read()
    dev1, same1 = vtk_close(os.path.join(RUN_DIR, "file001.vtk"),
                            os.path.join(HALO_RUN_DIR, "file001.vtk"),
                            HALO_FRAME_REL)
    ck = os.path.join(HALO_RUN_DIR, "ckpt_001.npz")
    hm = partition(hcut, HALO_RANKS)
    back = gather_state(hm, load_halo_checkpoint(ck, hm))
    diff = state_diff(back, final)
    with open(os.path.join(HALO_RUN_DIR, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    us = timings["step_s"] / timings["steps"] * 1e6
    log(f"[halo-run] run(halo={HALO_RANKS}, dist_backend='gloo'), ranks "
        f"sharing the card: [run]'s deck cut to {SHARD_RUN_STEPS} steps, "
        f"partition No={hm.No} H={hm.H} El={hm.El} packed="
        f"{hm.coord_e is not None}; step loop {timings['step_s']:.2f} s = "
        f"{us:.2f} us/step, {timings['frames']} frames in "
        f"{timings['frame_s']:.2f} s, run() wall {wall:.2f} s (spawn "
        f"included); {alive} alive at step {SHARD_RUN_STEPS} ([run]: "
        f"{SHARD_RUN_ALIVE}), frames' CELLS {cells}; frame 0 byte-identical "
        f"to [run]'s: {same0}; frame 1 within {dev1:.3e} of its scale, "
        f"{same1:.4f} of its lines byte-identical; energy_rel_error "
        f"{recs[-1]['energy_rel_error']:.3e} (halo metrics); shard-major "
        f"checkpoint {is_halo_checkpoint(ck)}, reloaded here, fields "
        f"differing from the returned state: {diff} [{smi_line}]")
    if (abs(alive - SHARD_RUN_ALIVE) > HALO_ALIVE_REL * SHARD_RUN_ALIVE
            or cells != [cut.n_element, alive] or not same0 or diff
            or len(recs) != 1):
        raise AssertionError("[halo-run] differs")
    return us


def dma_phase(smi_line):
    """[dma]: TPU kernel #11's replacement through the port's bandwidth
    probe (the probe's passes are the launches counted), then each layout
    bitwise against its plain version on random data and timed alone
    (cold L2), with torch.add's time and the bound.  Returns (the strided
    layout's record, the probe's launches)."""
    import torch
    from hakai_tpu_torch.ops.stream_cuda import (LAYOUTS, layout_shape,
                                                 stream_add1,
                                                 stream_add1_plain)
    from hakai_tpu_torch.probes.dma import REPEATS, probe
    reset_counts()
    slopes = probe(DMA_E, DMA_TE, DMA_N1, DMA_N2, "cuda",
                   out=lambda line: log(f"[dma] {line}"))
    launches = read_counts()
    want = len(LAYOUTS) * (DMA_N1 + REPEATS * (DMA_N1 + DMA_N2))
    if launches["stream"] != want:
        raise AssertionError(f"[dma] launches {launches} != {want}")
    moved = 2 * 72 * DMA_E * 4
    bound_ms, bound_by = bound(moved, 72 * DMA_E, "float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    recs = {}
    for layout in LAYOUTS:
        x = torch.randn(layout_shape(layout, DMA_E, DMA_TE), generator=gen,
                        device="cuda") * 1e3
        o = torch.empty_like(x)
        k = stream_add1(x, layout, out=o, TE=DMA_TE)
        p = stream_add1_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"[dma] {layout} differs from plain")
        rec = {"max_abs_err": (k - p).abs().max().item(),
               "ms": time_ms(lambda: stream_add1(x, layout, out=o,
                                                 TE=DMA_TE)),
               "plain_ms": time_ms(lambda: stream_add1_plain(x)),
               "library_ms": time_ms(lambda: torch.add(x, 1.0, out=o)),
               "bound_ms": bound_ms, "bound_by": bound_by}
        recs[layout] = rec
        del x, o, k, p
        log(f"[dma] {layout}: bitwise its plain version; kernel "
            f"{rec['ms']:.4f} ms = {moved / rec['ms'] / 1e6:.1f} GB/s (cold "
            f"L2, events), probe slope {slopes[layout] * 1e6:.3f} us/pass = "
            f"{moved / slopes[layout] / 1e9:.1f} GB/s, "
            f"{slopes[layout] / slopes['torch.add']:.4f} of torch.add's; plain "
            f"{rec['plain_ms']:.4f} ms, torch.add {rec['library_ms']:.4f} ms"
            f" (slope {slopes['torch.add'] * 1e6:.3f} us/pass), bound "
            f"{bound_ms:.4f} ms ({bound_by}: {moved} B at 3.35 TB/s) "
            f"[{smi_line}]")
    return recs["strided"], launches["stream"]


def interleave_phase(smi_line, ref=None):
    """[interleave]: TPU kernel #12's replacement through the port's
    interleave probe (the probe's passes are the launches counted), then
    each mode bitwise against its plain version on a random window and
    timed alone (cold L2) beside the bound, with its resources; given the
    reference library, the probe again on the reference kernel, and each
    mode bitwise against it, timed.  Returns {mode: record}."""
    import torch
    from hakai_tpu_torch import _build
    from hakai_tpu_torch.ops.interleave_cuda import (MODES, OFFSETS,
                                                     interleave,
                                                     interleave_plain)
    from hakai_tpu_torch.probes.interleave import W, bound_s, probe
    reset_counts()
    slopes = probe(IL_TILES, IL_BUILDS, IL_N1, IL_N2, "cuda",
                   out=lambda line: log(f"[interleave] {line}"))
    counts = read_counts()
    ref_slopes = {}
    if ref is not None:
        with reference(ref):
            ref_slopes = probe(IL_TILES, IL_BUILDS, IL_N1, IL_N2, "cuda",
                               out=lambda line: log(
                                   f"[interleave] reference: {line}"),
                               place=False)
    # per mode: a warm chain of n2, the timed n1 and n2, the checked n2
    want = 3 * IL_N2 + IL_N1
    launches = {m: counts.get(f"interleave[{m}]", 0) for m in MODES}
    if any(v != want for v in launches.values()):
        raise AssertionError(f"[interleave] launches {launches} != {want}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    recs = {}
    for mode in MODES:
        src = torch.randn((W, 8, 128), generator=gen, device="cuda") * 100.0
        out = torch.empty((IL_TILES * 8, 128), device="cuda")
        k = interleave(src, mode, IL_TILES, IL_BUILDS, out=out)
        p = interleave_plain(src, mode, IL_TILES, IL_BUILDS)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"[interleave] {mode} differs from plain")
        b_s, by = bound_s(mode, IL_TILES, IL_BUILDS)
        rec = {"max_abs_err": (k - p).abs().max().item(),
               "ms": time_ms(lambda: interleave(src, mode, IL_TILES,
                                                IL_BUILDS, out=out)),
               "plain_ms": time_ms(lambda: interleave_plain(
                   src, mode, IL_TILES, IL_BUILDS)),
               "library_ms": None, "bound_ms": b_s * 1e3, "bound_by": by,
               "launches": launches[mode]}
        res = (ctypes.c_int * 5)()
        offs = (ctypes.c_int * 8)(*OFFSETS)
        _build.check(_build.library(), _build.library()
                     .hk_interleave_resources(W, IL_BUILDS, IL_TILES,
                                              MODES[mode],
                                              ctypes.addressof(offs), res),
                     "interleave resources")
        rec["res"] = dict(zip(("blocks", "registers", "smem", "local",
                               "dyn"), res))
        vs = "; no reference kernel (REF_DIR) to hold it against"
        if ref is not None:
            with reference(ref):
                k_ref = interleave(src, mode, IL_TILES, IL_BUILDS)
                torch.cuda.synchronize()
                ref_ms = time_ms(lambda: interleave(src, mode, IL_TILES,
                                                    IL_BUILDS, out=out))
            if not torch.equal(k, k_ref):
                raise AssertionError(f"[interleave] {mode} differs from the "
                                     "reference kernel")
            vs = (f"; the reference kernel {ref_ms:.4f} ms alone, slope "
                  f"{ref_slopes[mode] * 1e6:.3f} us/pass, outputs bitwise "
                  "equal")
        recs[mode] = rec
        log(f"[interleave] {mode}: bitwise its plain version; kernel "
            f"{rec['ms']:.4f} ms (cold L2, events; "
            f"{rec['bound_ms'] / rec['ms']:.4f} of its bound; "
            f"{_res(rec['res'])}), probe slope "
            f"{slopes[mode] * 1e6:.3f} us/pass = "
            f"{slopes[mode] / (IL_TILES * IL_BUILDS) * 1e9:.4f} ns/build; "
            f"plain {rec['plain_ms']:.4f} ms; bound {rec['bound_ms']:.5f} ms"
            f" ({by}); no single PyTorch call computes a build{vs} "
            f"[{smi_line}]")
    return recs


def _cli_pair(tag, deck, extra):
    """The CLI on ``deck`` as the two processes of a multi-host run
    (``--multihost 127.0.0.1:P,2,K``, ``--halo 2`` over gloo), each with
    its own output directory MH_DIR/<tag>K and metrics file, plus
    ``extra(K)``; returns the processes' standard outputs."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hakai_tpu_torch", deck, "--precision",
         "mixed", "--halo", "2", "--dist-backend", "gloo", "--multihost",
         f"127.0.0.1:{port},2,{k}", "--output-num", str(CLI_FRAMES),
         "--out-dir", os.path.join(MH_DIR, f"{tag}{k}"), "--metrics",
         os.path.join(MH_DIR, f"{tag}{k}.jsonl"), "--timings"] + extra(k),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"[multihost] {tag} process {k} exited "
                                 f"{p.returncode}:\n{err[-3000:]}")
    return [o for o, _ in outs]


def multihost_phase(smi_line):
    """[multihost]: run A, [cli]'s deck in two CLI processes with a
    checkpoint at each frame; run B, two new processes resumed from run A's
    first checkpoint.  Returns run A's us/step."""
    import numpy as np
    shutil.rmtree(MH_DIR, ignore_errors=True)
    os.makedirs(MH_DIR)
    deck = os.path.join(CLI_DIR, "bar_cut.inp")
    t0 = time.perf_counter()
    outs = _cli_pair("a", deck, lambda k: ["--checkpoint-every", "1"])
    wall_a = time.perf_counter() - t0
    a0, a1 = (os.path.join(MH_DIR, f"a{k}") for k in (0, 1))
    left = sorted(os.listdir(a1)) if os.path.isdir(a1) else []
    if left != ["ckpt_001.npz.p1.npz", "ckpt_002.npz.p1.npz"] or \
            os.path.exists(os.path.join(MH_DIR, "a1.jsonl")):
        raise AssertionError(f"[multihost] process 1 wrote {left}")
    if any(f"time_num:{CLI_STEPS}" not in o for o in outs):
        raise AssertionError("[multihost] a process lacks the deck's lines")
    names = [f"file{i:03d}.vtk" for i in range(CLI_FRAMES + 1)]
    with open(os.path.join(a0, names[0]), "rb") as fa, \
            open(os.path.join(CLI_DIR, "bar", names[0]), "rb") as fb:
        same0 = fa.read() == fb.read()
    devs = [vtk_close(os.path.join(CLI_DIR, "bar", n), os.path.join(a0, n),
                      HALO_FRAME_REL) for n in names[1:]]
    with open(os.path.join(MH_DIR, "a0.jsonl")) as f:
        alive = [int(json.loads(x)["alive_elements"]) for x in f]
    final = np.load(os.path.join(a0, "final.ckpt.npz"))
    cells = [vtk_cells(os.path.join(a0, n)) for n in names]
    rows = []
    for i in (1, 2):
        name = f"ckpt_{i:03d}.npz"
        with np.load(os.path.join(a0, name)) as man:
            rows.append([int(x) for x in man["halo_manifest"]])
        for k, d in ((0, a0), (1, a1)):
            with np.load(os.path.join(d, f"{name}.p{k}.npz")) as f:
                rows.append([int(x) for x in f["halo_rows"]])
    timing = next(x for x in outs[0].splitlines()
                  if x.startswith("timings:"))
    steps_s = float(timing.split("steps ")[1].split(" s")[0])
    us = steps_s / CLI_STEPS * 1e6
    shutil.copy(os.path.join(a0, "ckpt_001.npz"), a1)   # the other host's
    t0 = time.perf_counter()
    _cli_pair("b", deck, lambda k: ["--resume", os.path.join(
        MH_DIR, f"a{k}", "ckpt_001.npz")])
    wall_b = time.perf_counter() - t0
    with open(os.path.join(MH_DIR, "b0", names[-1]), "rb") as fa, \
            open(os.path.join(a0, names[-1]), "rb") as fb:
        same_b = fa.read() == fb.read()
    log(f"[multihost] [cli]'s deck ({CLI_STEPS} steps, mixed) as 2 CLI "
        f"processes x 1 gloo rank (--halo 2 --multihost 127.0.0.1:P,2,K), "
        f"both ranks on cuda:0 of one card: {timing} (process 0); "
        f"{us:.2f} us/step; run A {wall_a:.2f} s in all; process 1 wrote "
        f"only {left}; frame 0 byte-identical to [cli]'s: {same0}; frames "
        f"1-{CLI_FRAMES} within {max(d for d, _ in devs):.3e} of their "
        f"scale ({[round(s, 4) for _, s in devs]} of their lines "
        f"byte-identical); CELLS {cells}, alive {alive}, final "
        f"{int(final['element_flag'].sum())}; manifest and rows per "
        f"checkpoint {rows}; run B (resumed from ckpt_001 in two new "
        f"processes, {wall_b:.2f} s): frame {CLI_FRAMES} byte-identical to "
        f"run A's: {same_b} [{smi_line}]")
    if (not same0 or not same_b or cells[1:] != alive
            or cells[-1] != int(final["element_flag"].sum())
            or rows != [[2], [0], [1]] * 2):
        raise AssertionError("[multihost] differs")
    return us


def sharded_run(cut, job, start, smi_line):
    """run(devices=SHARD_RANKS) of [run]'s deck cut to SHARD_RUN_STEPS
    steps: its frames byte-identical to [run]'s at steps 0 and 2,000, its
    final state and checkpoint equal to the one-device run's, the
    checkpoint resuming there bitwise; the first deletion from
    [sharded]'s single steps (``job``, from the one-device state
    ``start``)."""
    from hakai_tpu_torch import init_state, run, run_chunk
    from hakai_tpu_torch.utils.checkpoint import load_checkpoint
    backend, setup = shard_backend()
    n = cut.n_element
    a = job["alive"]
    first = (SHARD_RUN_FIRST if a[-2] == n and a[-1] < n
             and int(start.t) == SHARD_RUN_FIRST - SHARD_LEAD else None)
    shutil.rmtree(SHARD_RUN_DIR, ignore_errors=True)
    os.makedirs(SHARD_RUN_DIR)
    timings = {}
    t0 = time.perf_counter()
    final = run(cut, devices=SHARD_RANKS, dist_backend=backend,
                timings=timings)
    wall = time.perf_counter() - t0
    same = []
    for i in range(2):
        name = f"file{i:03d}.vtk"
        with open(os.path.join(SHARD_RUN_DIR, name), "rb") as fa, \
                open(os.path.join(RUN_DIR, name), "rb") as fb:
            same.append(fa.read() == fb.read())
    ref = run_chunk(cut, start, SHARD_RUN_STEPS - int(start.t))
    ck = load_checkpoint(os.path.join(SHARD_RUN_DIR, "ckpt_001.npz"),
                         init_state(cut))
    ck_diff, final_diff = state_diff(ck, ref), state_diff(final, ref)
    resume_diff = state_diff(run_chunk(cut, ck, SHARD_RUN_RESUME),
                             run_chunk(cut, ref, SHARD_RUN_RESUME))
    alive = int(final.element_flag.sum())
    us = timings["step_s"] / timings["steps"] * 1e6
    log(f"\n[sharded-run] run(devices={SHARD_RANKS}, dist_backend="
        f"{backend!r}), {setup}: [run]'s deck cut to {SHARD_RUN_STEPS} steps,"
        f" step loop {timings['step_s']:.2f} s = {us:.2f} us/step, "
        f"{timings['frames']} frames in {timings['frame_s']:.2f} s, run() "
        f"wall {wall:.2f} s (spawn included); first deletion at step {first}"
        f" (sharded single steps from step {int(start.t)}: alive {a}), "
        f"{alive} alive at step {SHARD_RUN_STEPS}; frames 0 and 1 "
        f"byte-identical to [run]'s: {same}; fields differing from one "
        f"device: final {final_diff}, checkpoint {ck_diff}, "
        f"{SHARD_RUN_RESUME} steps resumed on one device {resume_diff} "
        f"[{smi_line}]")
    if first != SHARD_RUN_FIRST or alive != SHARD_RUN_ALIVE:
        raise AssertionError(f"[sharded-run] deletions {a}, {alive} alive")
    if not all(same) or ck_diff or final_diff or resume_diff:
        raise AssertionError("[sharded-run] differs from one device")
    return us


def sharded_contact(impact, jobs, starts, smi_line):
    """run(devices=SHARD_RANKS) of [contact]'s deck cut to
    SHARD_CONTACT_STEPS steps: the alive count, the contact force and
    every other field equal to one device's; the first contact and first
    deletion from [sharded]'s single steps (``jobs``, from the one-device
    states ``starts``)."""
    from hakai_tpu_torch import run, run_chunk
    backend, setup = shard_backend()
    n = impact.n_element
    c, a = jobs[0]["contact_max"], jobs[1]["alive"]
    first_c = CONTACT_FIRST if c[-2] == 0 and c[-1] > 0 else None
    first_d = CONTACT_FIRST_DEL if a[-2] == n and a[-1] < n else None
    shutil.rmtree(SHARD_CONTACT_DIR, ignore_errors=True)
    os.makedirs(SHARD_CONTACT_DIR)
    timings = {}
    t0 = time.perf_counter()
    final = run(impact, devices=SHARD_RANKS, dist_backend=backend,
                timings=timings)
    wall = time.perf_counter() - t0
    ref = run_chunk(impact, starts["contact_del"],
                    SHARD_CONTACT_STEPS - int(starts["contact_del"].t))
    alive, alive_ref = (int(s.element_flag.sum()) for s in (final, ref))
    err = relerr(final.contact_force, ref.contact_force)
    diff = state_diff(final, ref)
    cells = vtk_cells(os.path.join(SHARD_CONTACT_DIR, "file001.vtk"))
    us = timings["step_s"] / timings["steps"] * 1e6
    log(f"[sharded-contact] run(devices={SHARD_RANKS}, dist_backend="
        f"{backend!r}), {setup}: [contact]'s deck cut to "
        f"{SHARD_CONTACT_STEPS} steps, step loop {timings['step_s']:.2f} s "
        f"= {us:.2f} us/step, run() wall {wall:.2f} s; first contact at "
        f"step {first_c} (sharded single steps from step "
        f"{int(starts['contact'].t)}: contact_force max {c}), first "
        f"deletion at step {first_d} (from step "
        f"{int(starts['contact_del'].t)}: alive {a}); {alive} alive at step "
        f"{SHARD_CONTACT_STEPS} (one device: {alive_ref}, frame CELLS "
        f"{cells}); contact force {err:.3e} from one device's, normwise; "
        f"fields differing from one device: {diff} [{smi_line}]")
    if first_c != CONTACT_FIRST or first_d != CONTACT_FIRST_DEL:
        raise AssertionError(f"[sharded-contact] first contact/deletion "
                             f"{c} {a}")
    if alive != alive_ref or cells != alive or diff:
        raise AssertionError("[sharded-contact] differs from one device")
    return us


def nccl_phase(bench, smi_line):
    """The NCCL backend driven on the card: one rank, the bench bar,
    bitwise equal to run_chunk; with one card, two NCCL ranks refused."""
    import torch
    from hakai_tpu_torch import init_state, run, run_chunk
    from hakai_tpu_torch.parallel.dist import launch
    from hakai_tpu_torch.parallel.sharding import chunk_rank
    refused = "not tried: the machine has a card per rank"
    if torch.cuda.device_count() < 2:
        try:
            run(bench, devices=2, dist_backend="nccl", write_output=False)
        except ValueError as e:
            refused = f"refused: {e}"
        else:
            raise AssertionError("NCCL ran two ranks on one card")
    t0 = time.perf_counter()
    r = launch(chunk_rank, 1, "cuda", "nccl",
               [dict(model=bench.to("cpu"), chunks=[NCCL_STEPS],
                     warm=SHARD_WARM, trace=SHARD_TRACE)])[0]
    sec = time.perf_counter() - t0
    diff = state_diff(r["state"], run_chunk(bench, init_state(bench),
                                            NCCL_STEPS))
    us = r["seconds"][0] / NCCL_STEPS * 1e6
    log(f"[nccl] one rank under nccl, bench bar, {NCCL_STEPS} steps after "
        f"{SHARD_WARM} dropped ones (the communicator forms at the first "
        f"collective): {us:.2f} us/step, all-gathers "
        f"{r['collective_s'][0] / r['seconds'][0]:.4f} of the chunk (CUDA "
        f"events); {SHARD_TRACE} traced steps: device busy "
        f"{r['busy_us']:.2f} us/step, {r['kernels']:.1f} kernels/step, idle "
        f"share {1.0 - r['busy_us'] / us:.4f}; host ops of the most self "
        f"time (us/step, traced) {_top(r)}; {sec:.2f} s with the spawn; "
        f"launches {r['launches']}; fields differing from "
        f"run_chunk: {diff}; two NCCL ranks on one card {refused} "
        f"[{smi_line}]")
    if diff or r["launches"]["element_core_packed"] != NCCL_STEPS:
        raise AssertionError("[nccl] differs from run_chunk")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import hakai_tpu_torch  # noqa: F401  (fails outside a checkout)
    from hakai_tpu_torch import SolverConfig, _build, lower
    from hakai_tpu_torch.pre.synthetic import bar_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def lap(what):
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")
    smi_line = smi()
    log(f"[device] {smi_line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {_build.BUILD_INFO['path']} built="
        f"{_build.BUILD_INFO['built']} in {time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    _build.host_library()
    log(f"[build] host-IO helper {_build.HOST_INFO['path']} built="
        f"{_build.HOST_INFO['built']} in {_build.HOST_INFO['seconds']:.2f} s "
        f"({' '.join(_build.HOST_INFO['compiler'])} "
        f"{' '.join(_build.HOST_FLAGS)})")
    ref = build_reference()

    rng = np.random.default_rng(SEED)
    models = {}
    for kind, ductile, end in (("float32", False, 1.0),
                               ("float64", False, 1.0),
                               ("mixed", True, RUN_END)):
        t0 = time.perf_counter()
        cfg = SolverConfig(dtype=kind, node_pad=128, elem_pad=128)
        if kind == "mixed":
            cfg = SolverConfig(dtype=kind, output_num=RUN_FRAMES,
                               energy_check=True,
                               checkpoint_every=RUN_CKPT_EVERY,
                               out_dir=RUN_DIR,
                               metrics_path=os.path.join(RUN_DIR,
                                                         "metrics.jsonl"))
        models[kind] = m = lower(bar_model(nx=NX, ny=NY, nz=NZ, d_time=1e-8,
                                           end_time=end, ductile=ductile),
                                 cfg, device="cuda")
        torch.cuda.synchronize()
        log(f"[lower] {NX}x{NY}x{NZ} bar {kind} ductile={ductile}: E={m.E} "
            f"N={m.N} V={m.inc_idx.shape[0]} renumbered="
            f"{m.node_new2old is not None} in "
            f"{time.perf_counter() - t0:.2f} s")
    bench, bench64, mixed = (models[k] for k in ("float32", "float64",
                                                 "mixed"))

    rec = {
        "f32": check_element(with_padding(bench, 128), rng, "bench",
                             ref=ref),
        "f32_triax": check_element(with_padding(bench, 128), rng, "bench",
                                   want_triax=True, ref=ref),
        "f64": check_element(with_padding(bench64, 128), rng, "bench",
                             ref=ref),
        "mixed": check_element(with_padding(mixed, 128), rng, "bench",
                               want_triax=True, ref=ref),
        "u_f32": check_update(with_padding(bench, 128), rng, "bench",
                              ref=ref),
        "u_f32_triax": check_update(with_padding(bench, 128), rng, "bench",
                                    want_triax=True, ref=ref),
        "u_f64": check_update(with_padding(bench64, 128), rng, "bench",
                              ref=ref),
        "asm_f32": check_assemble(bench, rng, "bench", ref=ref),
        "asm_f64": check_assemble(bench64, rng, "bench", ref=ref),
        "asm_mixed": check_assemble(mixed, rng, "bench", torch.float64,
                                    ref=ref),
        "gasm_f32": check_grouped(bench, rng, "bench", ref=ref),
        "gasm_f64": check_grouped(bench64, rng, "bench", ref=ref),
        "gasm_mixed": check_grouped(mixed, rng, "bench", torch.float64,
                                    ref=ref),
    }
    log_resources(rec, {
        "f32": "element packed float32", "f32_triax": "element packed "
        "float32 +triax", "f64": "element packed float64", "mixed":
        "element packed mixed +triax", "u_f32": "element unpacked float32",
        "u_f32_triax": "element unpacked float32 +triax", "u_f64":
        "element unpacked float64", "asm_f32": "kernel B float32",
        "asm_f64": "kernel B float64", "asm_mixed": "kernel B "
        "float32->float64", "gasm_f32": "grouped float32", "gasm_f64":
        "grouped float64", "gasm_mixed": "grouped float32->float64"})
    reference_chunk(mixed, ref)
    del bench64, models
    lap("[kernels] and [grouped-asm] kernels")
    dma_rec, dma_launches = dma_phase(smi_line)
    lap("[dma]")
    il_recs = interleave_phase(smi_line, ref)
    lap("[interleave]")

    trajectory()
    lap("[trajectory]")
    launches1, final, step_us = main_path(bench, smi_line)
    busy_us = trace(bench, final, smi_line, "float32 elastic")[0]
    log(f"[trace] float32 elastic: device idle share "
        f"{1.0 - busy_us / step_us:.4f} of the median untraced step "
        f"({busy_us:.2f} of {step_us:.2f} us)")
    launches_g = grouped_path(bench, final, smi_line)
    lap("[main], its [trace] and [grouped-asm]'s run")

    fracture()
    lap("[fracture]")
    launches2, final2, run_us, run_first, run_alive = second_path(mixed,
                                                                  smi_line)
    busy2 = trace(mixed, final2, smi_line, "mixed ductile")[0]
    log(f"[trace] mixed ductile: device idle share "
        f"{1.0 - busy2 / run_us:.4f} of the run() step ({busy2:.2f} of "
        f"{run_us:.2f} us)")
    cut = cut_to(mixed, SHARD_RUN_STEPS, output_num=1, checkpoint_every=1,
                 out_dir=SHARD_RUN_DIR,
                 metrics_path=os.path.join(SHARD_RUN_DIR, "metrics.jsonl"))
    lap("[run] and its [trace]")
    host_io_phase(mixed, final2, smi_line)
    del mixed, final2
    lap("[host-io]")

    impact = contact_model(smi_line)
    launches3, final3, contact_us, s_kern = contact_path(impact, smi_line)
    busy3, wall3, per3 = trace(impact, s_kern, smi_line, "contact impact",
                               n=20)
    log(f"[trace] contact impact: device idle share {1.0 - busy3 / wall3:.4f}"
        f" of the same steps untraced ({busy3:.2f} of {wall3:.2f} us; run()"
        f" averaged {contact_us:.2f} us/step over its 5,000 steps)")
    crec = contact_kernels(impact, s_kern, smi_line, sum(
        v for k, v in per3.items() if k.startswith("narrow_")), ref)
    impact_cut = cut_to(impact, SHARD_CONTACT_STEPS, output_num=1,
                        checkpoint_every=0, out_dir=SHARD_CONTACT_DIR,
                        metrics_path=None)
    del impact, final3, s_kern
    lap("[contact], its [trace] and [contact-kernels]")
    contact_cpu()
    lap("[contact-cpu]")

    t0 = time.perf_counter()
    gen = lower(bar_model(nx=NX, ny=NY, nz=NZ, d_time=1e-8, end_time=1.0),
                SolverConfig(dtype="float32", gather_mode="xla", node_pad=128,
                             elem_pad=128), device="cuda")
    torch.cuda.synchronize()
    log(f"[lower] {NX}x{NY}x{NZ} bar float32 gather_mode=xla: E={gen.E} "
        f"N={gen.N} coord_e={gen.coord_e is not None} in "
        f"{time.perf_counter() - t0:.2f} s")
    if gen.coord_e is not None:
        raise AssertionError("the gather_mode=xla bar carries coord_e")
    launches4, final4, gen_us = main_path(
        gen, smi_line, "[generic]", ("update", "assemble",
                                     "update[float32+triax]"))
    busy4 = trace(gen, final4, smi_line, "generic float32 elastic")[0]
    log(f"[trace] generic float32 elastic: device idle share "
        f"{1.0 - busy4 / gen_us:.4f} of the median untraced step "
        f"({busy4:.2f} of {gen_us:.2f} us)")
    del final4
    gen_mixed, launches5, final5, gen_run_us = generic_run(
        smi_line, run_first, run_alive)
    busy5 = trace(gen_mixed, final5, smi_line, "generic mixed ductile")[0]
    log(f"[trace] generic mixed ductile: device idle share "
        f"{1.0 - busy5 / gen_run_us:.4f} of the run() step ({busy5:.2f} of "
        f"{gen_run_us:.2f} us)")
    del gen_mixed, final5
    lap("[generic] and its [trace]s")
    generic_cpu()
    lap("[generic-cpu]")
    cli_phase(smi_line)
    lap("[cli]")
    shard, starts, refs = sharded_phase(bench, gen, cut, impact_cut,
                                        smi_line)
    lap("[sharded]")
    launches_h = halo_phase(shard[5:], refs, cut, impact_cut, smi_line)
    lap("[halo]")
    sharded_run(cut, shard[2], starts["cut"], smi_line)
    lap("[sharded-run]")
    sharded_contact(impact_cut, shard[3:], starts, smi_line)
    lap("[sharded-contact]")
    nccl_phase(bench, smi_line)
    lap("[nccl]")
    halo_run(cut, smi_line)
    lap("[halo-run]")
    multihost_phase(smi_line)
    lap("[multihost]")

    if any(k.split(".")[0] in ("jax", "jaxlib", "hakai_tpu")
           for k in sys.modules):
        raise AssertionError("the port's smoke run imported jax or the JAX "
                             "package")
    src = "hakai_tpu/ops/element_pallas.py"

    def entry(name, source, replaces, count, r):
        # launches: the variant's launches in the six main-path runs and
        # on [halo]'s rank 0
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(x.get(count, 0) for x in
                                (launches1, launches2, launches3, launches4,
                                 launches5, launches_g, launches_h)),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
    el, asm, cu = ("hakai_tpu_torch/csrc/element.cu",
                   "hakai_tpu_torch/csrc/assemble.cu",
                   "hakai_tpu_torch/csrc/contact.cu")
    gp = "hakai_tpu/ops/gather_pallas.py"
    # the instantiations the six main paths run, and the float64 element
    # and the float64 and mixed grouped ones, which none runs (their
    # launches are 0); the float32+triax
    # packed element, float32 unpacked element without triax, float64
    # assembly and float64 contact instantiations are checked (and the
    # first three timed) in [kernels] and [contact-kernels] and reported on
    # their lines.  A narrow_phase launch is one wrapper call for one pair,
    # which launches its four kernels (narrow_bin, narrow_scan,
    # narrow_sort, narrow_probe).
    kernels = [
        entry("element_core_packed[float32]", el, f"{src}:210",
              "element[float32]", rec["f32"]),
        entry("element_core_packed[float64]", el,
              "hakai_tpu/ops/element.py:389 (XLA; no TPU kernel takes f64)",
              "element[float64]", rec["f64"]),
        entry("element_core_packed[mixed+triax]", el,
              f"{src}:561 and {src}:93", "element[mixed+triax]",
              rec["mixed"]),
        entry("element_update[float32+triax]", el, f"{src}:25 (call :63)",
              "update[float32+triax]", rec["u_f32_triax"]),
        entry("element_update[float64]", el,
              f"{src}:25 (call :63; f64 takes the XLA math there)",
              "update[float64]", rec["u_f64"]),
        entry("assemble_internal_force[float32]", asm,
              "hakai_tpu/ops/gather_pallas.py:413",
              "assemble[hk_assemble_f32]", rec["asm_f32"]),
        entry("assemble_internal_force[float32->float64]", asm,
              "hakai_tpu/ops/gather_pallas.py:413",
              "assemble[hk_assemble_f32_f64]", rec["asm_mixed"]),
        entry("blocked_assemble[float32]", asm,
              f"{gp}:479 and :539 (blocked_assemble, {gp}:589)",
              "grouped[hk_blocked_assemble_f32]", rec["gasm_f32"]),
        entry("blocked_assemble[float64]", asm,
              f"{gp}:596 (blocked_assemble's XLA path: no TPU kernel takes "
              "f64)", "grouped[hk_blocked_assemble_f64]", rec["gasm_f64"]),
        entry("blocked_assemble[float32->float64]", asm,
              f"{gp}:479 and :539 (blocked_assemble, {gp}:589)",
              "grouped[hk_blocked_assemble_f32_f64]", rec["gasm_mixed"]),
        entry("gather_cols[float32]", "hakai_tpu_torch/csrc/gather.cu",
              f"{gp}:413, :361 and :314 (blocked_gather, {gp}:660)",
              "gather", crec[0]),
        entry("narrow_phase[float32]", cu,
              "hakai_tpu/ops/contact.py:252 (XLA block loop; no TPU kernel)",
              "narrow", crec[1]),
        entry("scatter_forces[float32->float64]", cu,
              f"{gp}:413 and :361 (scatter-as-gather, "
              "hakai_tpu/ops/contact.py:375)", "scatter", crec[2]),
        dict(entry("stream_add1[float32]", "hakai_tpu_torch/csrc/stream.cu",
                   "benchmarks/dma_microbench.py:35 (copy_kernel; "
                   "pallas_call :42)", "stream", dma_rec),
             launches=dma_launches),
    ] + [dict(entry(f"interleave[{mode}]", "hakai_tpu_torch/csrc/interleave.cu",
                    "benchmarks/interleave_microbench.py:33 (kernel; "
                    "pallas_call :62)", "interleave", r),
              launches=r["launches"]) for mode, r in il_recs.items()]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
