"""Command-line entry point of the port (mirrors ``hakai_tpu/cli.py``).

Reference CLI: ``julia HAKAI_j.jl <file.inp>`` (HAKAI_j.jl:3729-3735).
Here: ``python -m hakai_tpu_torch <file.inp> [options]``, on the GPU
unless ``--device cpu`` is given.

The flags keep the JAX package's names, defaults and meaning, apart from
three that drive XLA or the TPU's matrix unit and mean nothing on the card
(``--compile-cache``, ``--mxu-precision``, ``--chunk-unroll``).
``--devices n`` runs the element-sharded loop and ``--halo n`` the
node-sharded halo decomposition on n ranks over ``torch.distributed``,
with ``--dist-backend`` (the port's counterpart of JAX's choice of
collectives backend) choosing NCCL or gloo; ``--resume`` of a shard-major
halo checkpoint needs the matching ``--halo``.  ``--profile`` traces the
run's loop, on ranks rank 0's.

``--multihost ADDR:PORT,NPROC,PID`` (or ``auto`` in an Open MPI or SLURM
job, read as ``jax.distributed.initialize()`` reads them on a GPU host)
makes this process one of NPROC that run the same command: ``--devices n`` and
``--halo n`` then count ranks over every process, n / NPROC in each
(``parallel.dist.initialize``).  Every process prints the deck's lines
and returns the final state; process 0 alone writes frames, metrics,
``collection.pvd`` and ``final.ckpt.npz``, while a halo run's checkpoints
are one file a process plus process 0's manifest.

``--timings`` also prints which host-IO path parsed the deck and wrote the
frames: the path of the C++ helper's shared library.
"""
from __future__ import annotations

import argparse
import os
import re
import time

# what --multihost auto reads, in jax.distributed.initialize()'s order of
# detection on a GPU host: an Open MPI job (jax/_src/clusters/
# ompi_cluster.py: OmpiCluster), then a SLURM job step (slurm_cluster.py:
# SlurmCluster); both take the port from JAX_COORDINATOR_PORT where it is
# set (cluster.py: ClusterEnv.auto_detect_unset_distributed_params)
OMPI_VARS = ("OMPI_MCA_orte_hnp_uri", "OMPI_COMM_WORLD_SIZE",
             "OMPI_COMM_WORLD_RANK")
SLURM_VARS = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
              "SLURM_PROCID", "SLURM_LOCALID")
PORT_VAR = "JAX_COORDINATOR_PORT"


def _missing(env, names) -> list[str]:
    return [v for v in names if v not in env]


def ompi_spec(env=None) -> tuple[str, int, int]:
    """(coordinator address, process count, process id) of an Open MPI
    job: the launcher's first IP address in ``OMPI_MCA_orte_hnp_uri`` at a
    port in [61440, 65535] from the job id (or ``JAX_COORDINATOR_PORT``),
    ``OMPI_COMM_WORLD_SIZE`` and ``OMPI_COMM_WORLD_RANK``."""
    env = os.environ if env is None else env
    missing = _missing(env, OMPI_VARS)
    if missing:
        raise SystemExit(
            "--multihost auto reads an Open MPI job's environment ("
            f"{', '.join(OMPI_VARS)}); not set: {', '.join(missing)}")
    # '1531576320.0;tcp://10.96.0.1,10.148.0.1:34911',
    # '1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d::2]:43370'
    uri = env[OMPI_VARS[0]]
    port = env.get(PORT_VAR) or str(
        int(uri.split(".", 1)[0]) // 2**12 % 2**12 + (65535 - 2**12 + 1))
    ip = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if ip is None:
        raise SystemExit(f"--multihost auto: no launcher address in "
                         f"{OMPI_VARS[0]}={uri!r}")
    host = next(g for g in ip.groups() if g is not None)
    return (f"{host}:{port}", int(env["OMPI_COMM_WORLD_SIZE"]),
            int(env["OMPI_COMM_WORLD_RANK"]))


def slurm_spec(env=None) -> tuple[str, int, int]:
    """(coordinator address, process count, process id) of a SLURM job
    step: the first node of ``SLURM_STEP_NODELIST`` at a port in
    [61440, 65535] from the job id (or ``JAX_COORDINATOR_PORT``),
    ``SLURM_NTASKS`` and ``SLURM_PROCID``.  Stops, naming the variables,
    outside such a job."""
    env = os.environ if env is None else env
    missing = _missing(env, SLURM_VARS)
    if missing:
        raise SystemExit(
            "--multihost auto reads a SLURM job step's environment ("
            f"{', '.join(SLURM_VARS)}); not set: {', '.join(missing)}.  "
            "Outside SLURM pass --multihost ADDR:PORT,NPROC,PID")
    port = env.get(PORT_VAR) or str(
        int(env["SLURM_JOB_ID"]) % 2**12 + (65535 - 2**12 + 1))
    # 'node001', 'node001,host2', 'node[001-015],host2', 'node[001,007]'
    nodes = env["SLURM_STEP_NODELIST"]
    cut = next((i for i, ch in enumerate(nodes) if ch in ",["), len(nodes))
    if cut == len(nodes) or nodes[cut] == ",":
        host = nodes[:cut]
    else:
        rest = nodes[cut + 1:]
        end = next((i for i, ch in enumerate(rest) if ch in ",-"), None)
        host = nodes[:cut] + rest[:end]
    return (f"{host}:{port}", int(env["SLURM_NTASKS"]),
            int(env["SLURM_PROCID"]))


def auto_spec(env=None) -> tuple[str, int, int]:
    """``--multihost auto``: an Open MPI job (``OMPI_MCA_orte_hnp_uri``
    set) wins over a SLURM job step, as in JAX; outside both it stops,
    naming the variables of both."""
    env = os.environ if env is None else env
    if OMPI_VARS[0] in env:
        return ompi_spec(env)
    missing = _missing(env, SLURM_VARS)
    if missing:
        raise SystemExit(
            "--multihost auto reads an Open MPI job's environment ("
            f"{', '.join(OMPI_VARS)}) or a SLURM job step's ("
            f"{', '.join(SLURM_VARS)}); not set: "
            f"{', '.join(missing + [OMPI_VARS[0]])}.  Outside both pass "
            "--multihost ADDR:PORT,NPROC,PID")
    return slurm_spec(env)


def multihost_spec(spec: str) -> tuple[str, int, int]:
    """``ADDR:PORT,NPROC,PID`` (split as the JAX CLI splits it) or
    ``auto`` -> (coordinator address, process count, process id)."""
    if spec == "auto":
        return auto_spec()
    try:
        addr, nproc, pid = spec.rsplit(",", 2)
        return addr, int(nproc), int(pid)
    except ValueError:
        raise SystemExit(f"--multihost {spec!r}: expected "
                         "ADDR:PORT,NPROC,PID or auto") from None


def _resolve_energy_flags(energy_check: bool, energy_abort: float | None):
    """Energy-guard CLI resolution (default-on):

    * default: check on, abort at 0.1 of the energy scale (conservative —
      the documented N2k f32 blow-up crosses it thousands of steps before
      NaN; healthy f64/mixed runs sit orders of magnitude below);
    * --energy-abort REL implies the check (any REL, including 0 =
      report-only);
    * --no-energy-check alone turns both off.
    """
    if energy_abort is not None:
        return (True if energy_abort > 0 else energy_check,
                energy_abort if (energy_check or energy_abort > 0) else 0.0)
    return energy_check, (0.1 if energy_check else 0.0)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hakai_tpu_torch",
        description="dynamic-explicit FEM solver on one NVIDIA GPU, the "
                    "PyTorch + CUDA port of hakai_tpu (.inp in, VTK out)")
    ap.add_argument("inp", help="Abaqus .inp input deck")
    ap.add_argument("--precision", choices=["f32", "f64", "mixed"],
                    default="f64",
                    help="f64 matches the reference; mixed = f64 nodal "
                         "kinematics + f32 element/contact math (fast and "
                         "stable for long contact runs)")
    ap.add_argument("--out-dir", default="temp", help="VTK output directory")
    ap.add_argument("--output-num", type=int, default=100,
                    help="number of VTK frames (reference: 100)")
    ap.add_argument("--no-output", action="store_true",
                    help="skip VTK writing (benchmarking)")
    ap.add_argument("--kc", type=float, default=1.0,
                    help="contact penalty scale (reference kc)")
    ap.add_argument("--myu", type=float, default=0.25,
                    help="contact friction coefficient")
    ap.add_argument("--node-pad", type=int, default=8)
    ap.add_argument("--elem-pad", type=int, default=8)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a resumable checkpoint every N frames")
    ap.add_argument("--resume", default=None,
                    help="checkpoint file to resume from")
    ap.add_argument("--metrics", default=None,
                    help="write per-chunk JSONL diagnostics to this path")
    ap.add_argument("--check-nan", action="store_true",
                    help="abort when displacements go non-finite")
    ap.add_argument("--energy-check", action="store_true", default=True,
                    help="accumulate the discrete energy balance (external/"
                         "constraint work vs kinetic + internal work); its "
                         "residual is exact in real arithmetic, so its "
                         "growth detects roundoff-energy injection.  ON by "
                         "default (two (3,N) dot-reductions per step); "
                         "reported in --metrics records")
    ap.add_argument("--no-energy-check", dest="energy_check",
                    action="store_false",
                    help="disable the energy-balance guard")
    ap.add_argument("--energy-abort", type=float, default=None,
                    metavar="REL",
                    help="abort when the energy residual exceeds REL of the "
                         "run's energy scale (default 0.1); 0 = report in "
                         "metrics only, never abort")
    ap.add_argument("--devices", type=int, default=None,
                    help="element-shard the run over this many ranks, one "
                         "process each (one card each under nccl; gloo "
                         "lets ranks share a card or run on the CPU)")
    ap.add_argument("--halo", type=int, default=None,
                    help="node-sharded halo-exchange decomposition over "
                         "this many ranks, one process each (wins over "
                         "--devices; shard-major checkpoints)")
    ap.add_argument("--multihost", default=None, metavar="SPEC",
                    help="run as one of several processes (on one host or "
                         "several): ADDR:PORT,NPROC,PID, process 0 hosting "
                         "the rendezvous at ADDR:PORT, or auto in an Open "
                         "MPI job or a SLURM job step (JAX_COORDINATOR_PORT "
                         "sets the port); --devices/--halo n then spread n "
                         "ranks over the processes")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the run's loop "
                         "(on --devices/--halo ranks, rank 0's) into "
                         "DIR/trace.json (Chrome trace format)")
    ap.add_argument("--element-kernel", default="auto",
                    choices=["auto", "xla", "pallas", "pallas_mxu"],
                    help="the JAX package's element-math backends; on the "
                         "card all four run the one hand-written element "
                         "kernel (the choice between them is a TPU matter), "
                         "and pallas/pallas_mxu keep their f64 refusal and "
                         "1,024-element padding")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the current "
                         "GPU); 'cpu' runs the kernels' plain versions")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default=None,
                    help="torch.distributed backend of --devices and "
                         "--halo runs of two or more ranks (default: nccl "
                         "on the GPU, gloo on the CPU)")
    ap.add_argument("--timings", action="store_true",
                    help="print the host seconds of the parse, the "
                         "lowering, the step chunks and the frame output, "
                         "and the host-IO helper's library")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    args.energy_check, args.energy_abort = _resolve_energy_flags(
        args.energy_check, args.energy_abort)
    if args.multihost:
        # before anything else, as the JAX CLI initializes first
        addr, nproc, pid = multihost_spec(args.multihost)
        flag, n = (("--halo", args.halo) if (args.halo or 1) > 1
                   else ("--devices", args.devices))
        if (n or 1) > 1 and n % nproc:
            raise SystemExit(f"{flag} {n} does not divide over the {nproc} "
                             "processes of --multihost")
        from .parallel.dist import initialize
        initialize(addr, nproc, pid)

    elem_pad = args.elem_pad
    if args.element_kernel in ("pallas", "pallas_mxu"):
        if args.precision == "f64":
            ap.error(f"--element-kernel {args.element_kernel} requires "
                     "--precision f32 or mixed (TPU custom calls cannot "
                     "take f64; the kernel would silently never engage)")
        elem_pad = max(elem_pad, 1024)   # kernel tile divisibility

    from .config import ContactConfig, SolverConfig
    cfg = SolverConfig(
        dtype={"f64": "float64", "f32": "float32",
               "mixed": "mixed"}[args.precision],
        out_dir=args.out_dir,
        output_num=args.output_num,
        node_pad=(args.node_pad if not args.halo
                  else max(args.node_pad, 8) * args.halo),
        elem_pad=(elem_pad if not args.devices
                  else max(elem_pad, 16) * args.devices),
        element_kernel=args.element_kernel,
        contact=ContactConfig(kc=args.kc, kc_self=args.kc, myu=args.myu),
        renumber=("always" if args.halo else "auto"),
        metrics_path=args.metrics,
        checkpoint_every=args.checkpoint_every,
        check_nan=args.check_nan,
        energy_check=args.energy_check,
        energy_abort_rel=args.energy_abort,
    )

    from .core.lowering import lower
    from .core.state import init_state
    from .io.inp import read_inp_file
    from .solver.explicit import run
    from .parallel.dist import process_index
    from .parallel.halo import is_halo_checkpoint
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    t0 = time.perf_counter()
    model_in = read_inp_file(args.inp)
    t_parse = time.perf_counter() - t0
    print(f"nNode:{model_in.n_node}")
    print(f"nElement:{model_in.n_element}")
    print(f"contact_flag:{model_in.contact_flag}")
    print(f"mass_scaling:{model_in.mass_scaling}")
    t0 = time.perf_counter()
    model = lower(model_in, cfg, device=args.device)
    t_lower = time.perf_counter() - t0
    print(f"time_num:{model.time_num}")
    print(f"elementMinSize:{model.element_min_size}")
    print(f"elementMaxSize:{model.element_max_size}")
    if model.dt > model.cfl_dt:
        print(f"WARNING: dt={model.dt:.3e} exceeds CFL estimate "
              f"{model.cfl_dt:.3e} — expect instability")
    if (args.precision == "f64" and model.pairs
            and not model.fracture_enabled):
        # the JAX package's hint, word for word
        print("hint: this contact deck runs full f64 (reference-matching "
              "default).  --precision mixed (f64 kinematics + f32 element/"
              "contact math) is validated on the crash decks and ~5.8x "
              "faster; the energy-balance guard (on by default) monitors "
              "precision health either way")

    state = init_state(model)
    resume_halo = None
    if args.resume:
        if is_halo_checkpoint(args.resume):
            if not args.halo or args.halo < 2:
                raise SystemExit(f"{args.resume} is a shard-major halo "
                                 "checkpoint; pass the matching --halo N")
            resume_halo = args.resume     # loaded inside run() post-partition
            print("resuming from halo checkpoint")
        else:
            state = load_checkpoint(args.resume, state)
            print(f"resumed at step {int(state.t)}")
    timings = {}
    state = run(model, state, write_output=not args.no_output,
                devices=args.devices, halo=args.halo,
                resume_halo=resume_halo, device=args.device,
                timings=timings, dist_backend=args.dist_backend,
                profile=args.profile)
    if args.checkpoint_every and process_index() == 0:
        save_checkpoint(f"{args.out_dir}/final.ckpt.npz", state)
    if args.timings:
        print(f"timings: parse {t_parse:.3f} s, lower {t_lower:.3f} s, "
              f"steps {timings['step_s']:.3f} s for {timings['steps']} "
              f"steps, frames {timings['frame_s']:.3f} s for "
              f"{timings['frames']} frames")
        from ._build import HOST_INFO, host_library
        host_library()                  # loaded by the parse already
        print(f"host-io: C++ helper {HOST_INFO['path']}")
    return state


if __name__ == "__main__":
    main()
