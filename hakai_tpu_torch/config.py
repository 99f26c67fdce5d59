"""Solver configuration.

The reference hard-codes its knobs in source and tells users to edit them per
deck (HAKAI-v0.0.1/input/readme-for-inp.txt:4-16).  Here every knob is a
config field; deck values (dt, end time, mass scaling) always win.

This is the port's own copy of ``hakai_tpu/config.py``, field for field, so
a configuration means the same in both packages.  The port ignores the
TPU-only knobs ``mxu_precision``, ``elem_slab``, ``chunk_unroll`` and
``fused_gather``, and reads ``gather_mode`` only where the JAX lowering's
padding and renumbering rule does (their comments below describe the JAX
package and its TPU measurements, not the port).  Of
``element_kernel`` it accepts "auto", "pallas_mxu" and "pallas", which all
reach the same CUDA element kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ContactConfig:
    """Contact penalty model knobs (reference values at HAKAI_j.jl:2254-2259)."""
    myu: float = 0.25          # Coulomb friction coefficient (HAKAI_j.jl:2255)
    kc: float = 1.0            # penalty scale, instance-instance (kc_o, :2256)
    kc_self: float = 1.0       # penalty scale, self-contact (kc_s, :2257)
    Cr: float = 0.0            # damping ratio, instance-instance (Cr_o, :2258)
    Cr_self: float = 0.0       # damping ratio, self-contact (Cr_s, :2259)
    d_lim_scale: float = 0.3   # max accepted depth = scale*elementMinSize (:2254)
    ddiv_scale: float = 1.1    # broad-phase cell = scale*elementMaxSize (:2331)
    ddiv_scale_self: float = 0.6  # cell size for self-contact (:2333)
    # static capacities for compacted active sets (None = auto from mesh)
    tri_capacity: int | None = None
    node_capacity: int | None = None
    node_block: int = 2048     # narrow-phase node-tile size (memory bound)
    tri_block: int = 512       # narrow-phase triangle-tile size
    # self-contact tile knobs; swept on the crash tube (scratch sweep,
    # 2026-08-17): finer tiles LOSE — (256,256) 2.43 ms vs (512,2048)
    # 1.63 ms/step — per-trip loop overhead beats the extra AABB-cull
    # selectivity, so the defaults match the cross-pair tiles
    node_block_self: int = 2048
    tri_block_self: int = 512
    # Fracture-free decks: cull the re-exposure (twin) inventory at lowering
    # — element_flag can never change without a damage table, so the masks
    # are compile-time constants (N22k: 127k -> 43k triangles).  Disable to
    # keep the full inventory (e.g. to drive element_flag by hand).
    static_cull: bool = True


@dataclass(frozen=True)
class SolverConfig:
    dtype: str = "float64"       # state dtype; "float64" matches the reference
    integ_num: int = 8           # Gauss points per hex (HAKAI_j.jl:177)
    output_num: int = 100        # VTK frames per run (HAKAI_j.jl:471)
    damping_C: float = 0.0       # mass-proportional damping (HAKAI_j.jl:217)
    node_pad: int = 8            # pad n_node to a multiple (TPU lanes: use 128)
    elem_pad: int = 8            # pad n_element to a multiple
    contact: ContactConfig = field(default_factory=ContactConfig)
    out_dir: str = "temp"        # VTK output directory (reference: "temp\\")
    steps_per_call: int | None = None  # host-loop chunk; None = d_out
    check_nan: bool = False      # abort-on-NaN guard between chunks
    gather_mode: str = "auto"    # "auto" | "xla": mesh gathers via the Pallas
    #                              blocked-gather kernel when plans fit (TPU)
    renumber: str = "auto"       # "auto" | "always" | "off": RCM-renumber
    #                              scattered meshes so gather plans / halo
    #                              widths fit ("always": unconditional —
    #                              the halo path needs bounded bandwidth
    #                              even when plans fit)
    element_kernel: str = "auto"  # "auto": MXU-assisted packed Pallas
    #                              kernel when eligible (TPU backend, f32
    #                              element math, E % 1024 == 0 — wins both
    #                              regimes: 131k 1.67e8 vs 1.56e8, 1M
    #                              1.285e8 vs 6.98e7 elem-steps/s), else
    #                              the fused XLA path.  "xla": force the
    #                              fused XLA path.  "pallas_mxu": require
    #                              the MXU kernel.  "pallas": the earlier
    #                              VPU-only packed kernel (loses to XLA;
    #                              kept for comparison; see docs/PERF.md)
    fused_gather: str = "auto"    # "auto": the MXU packed kernel resolves
    #                              disp/dprev element copies from nodal
    #                              windows in-kernel (GatherPhysPlan) on
    #                              pure-f32 decks whose mesh admits the
    #                              plan — the kernel is DMA-bandwidth
    #                              bound and the materialized (3,8,E)
    #                              streams were 200 MB/step at 1M.
    #                              "off": always gather separately.
    mxu_precision: str = "highest"  # f32 matmul passes in the MXU element
    #                              kernel: "highest" = 6-pass bf16 (exact
    #                              f32), "high" = 3-pass bf16 (~1e-6 rel
    #                              error, ~2x faster contractions).  The
    #                              J/Gdu/Qe contractions are ~2/3 of the
    #                              kernel's MXU time at K=24; see
    #                              docs/PERF.md for the measured tradeoff.
    elem_slab: int = 0           # element-math slab size (fori_loop slabs of
    #                              the element-local math); 0 off (measured
    #                              slower at 1M: the slab loop's DUS carries
    #                              cost more than the HBM spill it avoids),
    #                              >0 explicit (multiple of 128)
    chunk_unroll: int = 0        # unroll factor for the chunk step loop.
    #                              0 (default) = no unroll: the TPU sweep
    #                              (benchmarks/sweep_unroll_n22k.py) shows
    #                              cross-step fusion is a net LOSS even on
    #                              the launch-bound deck it was built for
    #                              (U=1 1255 us/step vs U=4 2195).
    #                              Explicit values are applied as-is: a
    #                              factor that does not divide d_out trades
    #                              bitwise-exact resume for throughput
    #                              (XLA fuses a chunk's tail steps
    #                              differently from its body).
    metrics_path: str | None = None  # JSONL per-chunk diagnostics stream
    checkpoint_every: int = 0    # save resumable checkpoint every N frames
    checkpoint_path: str | None = None
    energy_check: bool = False   # accumulate the discrete energy balance
    #                              (external/constraint work vs kinetic +
    #                              internal work) in-state; the residual is
    #                              exactly zero in real arithmetic for the
    #                              central-difference update, so its growth
    #                              measures roundoff-energy injection — the
    #                              instability mode that precedes the f32
    #                              crash-deck blow-up by thousands of steps
    #                              (docs/PERF.md precision section).  Costs
    #                              two (3,N) dot-reductions per step; off by
    #                              default to keep the hot path unchanged.
    energy_abort_rel: float = 0.0  # abort (FloatingPointError) when
    #                              |energy residual| exceeds this fraction of
    #                              the run's energy scale between chunks;
    #                              0 = report in metrics only, never abort
