"""Process groups and the launcher of the port's multi-device runs.

One process per rank, started with the spawn method (a fresh interpreter
that imports the target's module: worker functions live in this package).
Rank ``r`` runs on ``cuda:(r % device_count)``, or on the CPU.  The ranks
of a launch share one host: rendezvous goes through a ``FileStore`` in a
temporary directory of the launch's own (so concurrent launches never race
for a port) and the collectives' sockets take the loopback interface.  The
launch's arguments reach the ranks, and rank 0's return value reaches the
caller, as ``torch.save`` files in that directory.

Backends: ``"nccl"`` (the default on CUDA) needs a card per rank; putting
two ranks on one card under it raises.  ``"gloo"`` (the default on the
CPU) also carries CUDA tensors, staged through host memory, and lets ranks
share a card when it is asked for by name.  Nothing retries with another
backend or moves to the CPU, and a rank that fails fails the launch.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")


class Rank(NamedTuple):
    """What a worker function is told about its rank."""
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any                      # the process group of the launch


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_placement(world: int, device, backend: str) -> None:
    """Raise unless ``world`` ranks can run on ``device`` under
    ``backend``."""
    kind = torch.device(device).type
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if world < 1:
        raise ValueError(f"a launch needs at least one rank, not {world}")
    if kind == "cpu":
        if backend != "gloo":
            raise ValueError(f"{backend} does not run CPU tensors; "
                             "use backend='gloo'")
    elif kind == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' for the "
                               "plain versions")
        if backend == "nccl" and world > cards:
            raise ValueError(
                f"NCCL needs a card per rank: {world} ranks, {cards} "
                f"card(s); pass backend='gloo' to let ranks share a card")
    else:
        raise ValueError(f"no multi-device runs on {kind}")


def init_group(rank: int, world: int, backend: str, store_path: str):
    """Join the process group of ``world`` ranks through the file store at
    ``store_path``; returns the group."""
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    return dist.group.WORLD


def _rank_main(rank, fn, world, kind, backend, tmp):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if kind == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        # small per-rank meshes: intra-op threads of several ranks on one
        # host's cores cost more than they save
        torch.set_num_threads(1)
    group = init_group(rank, world, backend, os.path.join(tmp, "store"))
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    out = fn(Rank(rank, world, device, backend, group), *args)
    if rank == 0:
        torch.save(out, os.path.join(tmp, "result.pt"))
    dist.destroy_process_group()


def launch(fn, world: int, device="cuda", backend: str | None = None,
           *args):
    """Run ``fn(Rank, *args)`` in ``world`` spawned processes, one per rank,
    on ``device`` ("cuda" or "cpu") under ``backend`` (default: NCCL on
    CUDA, gloo on the CPU); returns rank 0's return value.  ``fn`` must be
    a module-level function of an importable module; ``args`` and the
    return value travel by ``torch.save`` (keep tensors on the CPU)."""
    backend = backend or default_backend(device)
    kind = torch.device(device).type
    check_placement(world, kind, backend)
    with tempfile.TemporaryDirectory(prefix="hakai_dist_") as tmp:
        torch.save(args, os.path.join(tmp, "args.pt"))
        mp.start_processes(_rank_main, args=(fn, world, kind, backend, tmp),
                           nprocs=world, join=True, start_method="spawn")
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)


def rank_info(ctx: Rank, jobs: list | None = None) -> dict:
    """A worker that reports what rank 0 sees: its placement and every
    module its interpreter has loaded, after running ``jobs`` (if any) as
    :func:`~hakai_tpu_torch.parallel.sharding.chunk_rank` runs them."""
    import sys
    if jobs:
        from .sharding import chunk_rank
        chunk_rank(ctx, jobs)
    return {"rank": ctx.rank, "world": ctx.world, "device": str(ctx.device),
            "backend": ctx.backend, "modules": sorted(sys.modules)}
