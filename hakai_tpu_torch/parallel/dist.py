"""Process groups and the launcher of the port's multi-device runs.

One process per rank, started with the spawn method (a fresh interpreter
that imports the target's module: worker functions live in this package).
The launch's arguments reach the ranks, and local rank 0's return value
reaches the caller, as ``torch.save`` files in a temporary directory of
the launch's own.

One process (the default): the launch's ranks are all local.  Rendezvous
goes through a ``FileStore`` in that directory (so concurrent launches
never race for a port) and the collectives' sockets take the loopback
interface.

Several processes, on one host or several (:func:`initialize`, the
counterpart of ``jax.distributed.initialize``; the CLI's ``--multihost``):
every process runs the same program and so makes the same launches in the
same order.  A launch of n ranks over P processes spawns n / P local ranks
in each; process K's local rank j is global rank K * (n / P) + j, the JAX
package's process-major device order (``make_mesh``).  The ranks meet in
a ``TCPStore`` that process 0 hosts at the coordinator address, under a
prefix per launch.  Each process's local rank 0 returns the run's result
to its own caller, so every process's ``run()`` returns the final state.

Rank j of a process runs on ``cuda:(j % device_count)``, or on the CPU.
Backends: ``"nccl"`` (the default on CUDA) needs a card per rank; putting
two ranks on one card under it raises, within a process and across the
processes of a host (every rank posts its host and card to the store
before the group forms).  ``"gloo"`` (the default on the CPU) also
carries CUDA tensors, staged through host memory, and lets ranks share a
card when it is asked for by name.  NCCL's collectives are kernels on the
card, so a rank's chunk, collectives included, replays captured CUDA
graphs (``Rank.capturable``); gloo's go through the host, and its ranks
step eagerly.  Nothing retries with another backend
or moves to the CPU, a rank that fails fails its process, and a process
whose peer dies fails in its next collective.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import ipaddress
import os
import socket
import tempfile
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")
# how long a process waits for its peers at initialize() and a rank for the
# other ranks at a launch's rendezvous (jax.distributed.initialize's
# default initialization timeout)
RENDEZVOUS_S = 300
# this process's place among the processes of a run: set once, by
# initialize() (or, in a spawned rank, by its launch), with the store that
# initialize() opened (process 0's serves the run's rendezvous while it
# lives) and the count of launches made
_PROC = {"count": 1, "index": 0, "address": None, "store": None,
         "launches": 0}


class Rank(NamedTuple):
    """What a worker function is told about its rank."""
    rank: int                       # global rank
    world: int                      # ranks of the launch, over every process
    device: torch.device
    backend: str
    group: Any                      # the process group of the launch
    process: int = 0                # process index of the rank
    local_rank: int = 0             # rank within its process
    local_group: Any = None         # the ranks of its process (None: one
    #                                 process, the launch's group is it)

    @property
    def capturable(self) -> bool:
        """Whether the rank's collectives can be captured into a CUDA
        graph: NCCL's are kernels on the rank's card; gloo's run on the
        host, and a CPU rank has no graphs."""
        return self.backend == "nccl" and self.device.type == "cuda"


def _split_address(address: str) -> tuple[str, int]:
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not "
                         "HOST:PORT")
    return host.strip("[]"), int(port)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join a run of ``num_processes`` processes as process
    ``process_id`` (once per process, before any launch).  Process 0 hosts
    the ``TCPStore`` at ``coordinator_address`` (HOST:PORT) for the whole
    run; every process then waits until all have joined and agree on the
    process count (raising after RENDEZVOUS_S seconds)."""
    num_processes, process_id = int(num_processes), int(process_id)
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    if _PROC["address"] is not None:
        raise RuntimeError("initialize() was already called in this "
                           "process")
    host, port = _split_address(coordinator_address)
    store = dist.TCPStore(host, port, is_master=process_id == 0,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
    store.set(f"hakai/process/{process_id}", str(num_processes))
    keys = [f"hakai/process/{k}" for k in range(num_processes)]
    store.wait(keys)
    counts = {k: int(store.get(key)) for k, key in enumerate(keys)}
    if set(counts.values()) != {num_processes}:
        raise RuntimeError(f"the processes disagree on their count: "
                           f"{counts}")
    _PROC.update(count=num_processes, index=process_id,
                 address=coordinator_address, store=store)


def process_index() -> int:
    """This process's index among the run's processes (0 unless
    :func:`initialize` said otherwise)."""
    return _PROC["index"]


def process_count() -> int:
    """The number of processes in the run (1 unless :func:`initialize`
    said otherwise)."""
    return _PROC["count"]


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_placement(world: int, device, backend: str) -> None:
    """Raise unless ``world`` ranks of this process can run on ``device``
    under ``backend`` (the cards counted are this host's)."""
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


def local_ranks(world: int) -> int:
    """The ranks each process runs of a launch of ``world`` ranks."""
    n = process_count()
    if world % n:
        raise ValueError(f"{world} ranks do not divide over {n} processes")
    return world // n


def _check_cards(store, rank: int, world: int, device, backend: str):
    """Post this rank's (host, card) and, under NCCL, raise where two ranks
    of the launch hold one card."""
    card = device.index if device.type == "cuda" else -1
    store.set(f"place/{rank}", f"{socket.gethostname()} {card}")
    keys = [f"place/{r}" for r in range(world)]
    store.wait(keys)
    if backend != "nccl":
        return
    seen = {}
    for r, key in enumerate(keys):
        where = store.get(key).decode()
        if where in seen:
            raise ValueError(
                f"NCCL needs a card per rank: ranks {seen[where]} and {r} "
                f"share card {where!r}; pass backend='gloo' to let ranks "
                "share a card")
        seen[where] = r


def _loopback(host: str) -> bool:
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return host == "localhost"


def _rank_main(local_rank, fn, world, nproc, process, kind, backend, tmp,
               rendezvous):
    local = world // nproc
    rank = process * local + local_rank
    if rendezvous[0] == "file" or _loopback(rendezvous[1]):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if kind == "cuda":
        device = torch.device("cuda",
                              local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        # small per-rank meshes: intra-op threads of several ranks on one
        # host's cores cost more than they save
        torch.set_num_threads(1)
    _PROC.update(count=nproc, index=process)
    timeout = datetime.timedelta(seconds=RENDEZVOUS_S)
    if rendezvous[0] == "file":
        store = dist.FileStore(rendezvous[1], world)
    else:
        _, host, port, prefix = rendezvous
        store = dist.PrefixStore(prefix, dist.TCPStore(
            host, port, is_master=False, timeout=timeout))
    _check_cards(store, rank, world, device, backend)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    local_group = None
    if nproc > 1:
        # every rank makes every process's group, in the same order
        for k in range(nproc):
            g = dist.new_group(list(range(k * local, (k + 1) * local)))
            if k == process:
                local_group = g
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    out = fn(Rank(rank, world, device, backend, dist.group.WORLD, process,
                  local_rank, local_group), *args)
    if local_rank == 0:
        torch.save(out, os.path.join(tmp, "result.pt"))
    dist.destroy_process_group()


def launch(fn, world: int, device="cuda", backend: str | None = None,
           *args):
    """Run ``fn(Rank, *args)`` on ``world`` ranks, one spawned process per
    rank, on ``device`` ("cuda" or "cpu") under ``backend`` (default: NCCL
    on CUDA, gloo on the CPU); after :func:`initialize`, the ranks are
    spread over the run's processes (``world`` must divide by their count)
    and every process must make the same launch.  Returns local rank 0's
    return value.  ``fn`` must be a module-level function of an importable
    module; ``args`` and the return value travel by ``torch.save`` (keep
    tensors on the CPU)."""
    backend = backend or default_backend(device)
    kind = torch.device(device).type
    nproc, process = process_count(), process_index()
    local = local_ranks(world)
    check_placement(local, kind, backend)
    with tempfile.TemporaryDirectory(prefix="hakai_dist_") as tmp:
        torch.save(args, os.path.join(tmp, "args.pt"))
        if nproc == 1:
            rendezvous = ("file", os.path.join(tmp, "store"))
        else:
            host, port = _split_address(_PROC["address"])
            _PROC["launches"] += 1
            rendezvous = ("tcp", host, port,
                          f"hakai/launch/{_PROC['launches']}/")
        mp.start_processes(_rank_main,
                           args=(fn, world, nproc, process, kind, backend,
                                 tmp, rendezvous),
                           nprocs=local, join=True, start_method="spawn")
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)


def digest(obj) -> str:
    """A hash of every tensor and number in ``obj`` (dataclasses, tuples
    and lists walked through; strings left out), for telling whether two
    processes built the same model."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().contiguous()
            h.update(f"{x.dtype}{tuple(x.shape)}".encode())
            h.update(x.view(torch.uint8).numpy().tobytes()
                     if x.numel() else b"")
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            h.update(f"[{len(x)}".encode())
            for y in x:
                walk(y)
        elif isinstance(x, (bool, int, float)):
            h.update(repr(x).encode())
    walk(obj)
    return h.hexdigest()


def check_same(ctx: Rank, what: str, obj) -> None:
    """Raise on every rank unless every process built the same ``obj``
    (compared by :func:`digest`, over the launch's group; nothing to
    compare in a one-process run)."""
    if process_count() == 1:
        return
    mine = digest(obj)
    every = [None] * ctx.world
    dist.all_gather_object(every, (ctx.process, mine), group=ctx.group)
    apart = sorted({p for p, d in every if d != every[0][1]})
    if apart:
        raise RuntimeError(
            f"processes {apart} built another {what} than process "
            f"{every[0][0]}: every process must lower the same deck with "
            "the same options")


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
