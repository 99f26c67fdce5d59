"""Rank workers of the port's CPU tests of its multi-rank chunks, in a
module that imports neither JAX nor the JAX package, so that the spawned
gloo ranks (``hakai_tpu_torch.parallel.dist.launch``) start quickly.

- :func:`ring_rank`: the halo ring's exchanges on seeded rows against
  their oracle and against the all-gather exchange the ring replaced
  (:func:`allgather_exchange`, kept here as the reference), the bytes each
  batch of sends and receives moves, and halo chunks with either exchange;
- :func:`graph_rank`: rank chunks eagerly, then through the graph path
  with each capture stood in for by an eager replay (:class:`EagerReplay`),
  as a CPU has no CUDA graphs.
"""
import collections
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from hakai_tpu_torch.ops import assemble_cuda, element_cuda
from hakai_tpu_torch.parallel import halo as thalo
from hakai_tpu_torch.parallel.sharding import chunk_rank
from hakai_tpu_torch.solver import explicit, graph
from hakai_tpu_torch.solver.graph import Captured, leaves, write_back

SEED = 20261017


class EagerReplay:
    """Stands in for a captured graph on the CPU: a replay runs the
    length's steps from the static buffers and writes their result back,
    as the captured graph does on the card."""

    def __init__(self, graphs, model, length: int):
        self.graphs, self.model, self.length = graphs, model, length

    def replay(self):
        out = self.graphs._steps(self.model, self.length, "a CPU replay")
        write_back(leaves(self.graphs.static), leaves(out))


def loop_entries(model, generic: bool) -> tuple:
    """The C entries of ``model``'s element kernel on its loop (the
    unpacked entry on the generic step) and of its assembly."""
    el = (element_cuda._UPDATE_ENTRIES[model.edtype] if generic else
          element_cuda._ENTRIES[(model.dtype, model.edtype)])
    return el, assemble_cuda._ENTRIES[(model.edtype, model.dtype)]


def stand_in_capture(self, model, length):
    """``ChunkGraphs._capture`` on the CPU: an :class:`EagerReplay` whose
    replay counts ``length`` launches of the loop's element kernel and of
    the assembly (the plain versions on the CPU count none)."""
    launches = collections.Counter(
        dict.fromkeys(loop_entries(model, self.loop.endswith("generic")),
                      length))
    return Captured(EagerReplay(self, model, length), launches, 0.0, 0.0, 0)


# ---- the parent design's halo exchange: an all-gather of every rank's
# head and tail rows (the reference the ring is held to, bit for bit) ----

def _rows(self, x):
    H = self.hm.H
    parts = self.all_gather(torch.cat([x[..., :H], x[..., -H:]], -1))
    return parts.view(x.shape[0], self.world, 2, H)


def _exchange_window(self, x):
    d, S, H = self.rank, self.world, self.hm.H
    parts = _rows(self, x)
    zero = x.new_zeros((x.shape[0], H))
    from_left = parts[:, d - 1, 1] if d > 0 else zero
    from_right = parts[:, d + 1, 0] if d < S - 1 else zero
    return torch.cat([from_left, x, from_right], dim=-1)


def _return_ghosts(self, fw):
    d, S, H, No = self.rank, self.world, self.hm.H, self.hm.No
    parts = _rows(self, torch.cat([fw[..., :H], fw[..., H + No:]], -1))
    own = fw[..., H:H + No].clone()
    zero = fw.new_zeros((fw.shape[0], H))
    own[..., No - H:] += parts[:, d + 1, 0] if d < S - 1 else zero
    own[..., :H] += parts[:, d - 1, 1] if d > 0 else zero
    return own


@contextlib.contextmanager
def allgather_exchange():
    """``HaloComm``'s exchanges replaced by the all-gather design."""
    cls = thalo.HaloComm
    kept = cls.exchange_window, cls.return_ghosts
    cls.exchange_window, cls.return_ghosts = _exchange_window, _return_ghosts
    try:
        yield
    finally:
        cls.exchange_window, cls.return_ghosts = kept


@contextlib.contextmanager
def counted_batches(log: list):
    """Each batch of sends and receives appends (bytes sent, bytes
    received) to ``log``."""
    real = dist.batch_isend_irecv

    def counting(ops):
        sizes = [op.tensor.numel() * op.tensor.element_size() for op in ops]
        log.append((sum(n for op, n in zip(ops, sizes) if op.op is dist.isend),
                    sum(n for op, n in zip(ops, sizes)
                        if op.op is dist.irecv)))
        return real(ops)
    dist.batch_isend_irecv = counting
    try:
        yield
    finally:
        dist.batch_isend_irecv = real


def _rows_of(rank: int, C: int, L: int):
    """Rank ``rank``'s seeded (C, L) rows."""
    rng = np.random.default_rng([SEED, rank, C, L])
    return torch.as_tensor(rng.standard_normal((C, L)))


def _exchanges(ctx, hm) -> dict:
    """Rank ``ctx.rank``'s window of seeded (6, No) rows and owned rows of
    seeded (3, W) window forces through the ring, against the all-gather
    exchange and against the oracle built from every rank's seeded rows;
    the bytes of each batch."""
    comm = thalo.HaloComm(hm, ctx)
    d, S, H, No, W = ctx.rank, ctx.world, hm.H, hm.No, hm.W
    x, fw = _rows_of(d, 6, No), _rows_of(d, 3, W)
    log = []
    with counted_batches(log):
        got = comm.exchange_window(x), comm.return_ghosts(fw)
    with allgather_exchange():
        ref = comm.exchange_window(x), comm.return_ghosts(fw)
    zero6, zero3 = x.new_zeros((6, H)), x.new_zeros((3, H))
    window = torch.cat([_rows_of(d - 1, 6, No)[:, -H:] if d > 0 else zero6,
                        x, _rows_of(d + 1, 6, No)[:, :H] if d < S - 1
                        else zero6], -1)
    own = fw[:, H:H + No].clone()
    own[:, No - H:] += _rows_of(d + 1, 3, W)[:, :H] if d < S - 1 else zero3
    own[:, :H] += _rows_of(d - 1, 3, W)[:, H + No:] if d > 0 else zero3
    return {"rank": d, "H": H, "batches": log,
            "step_bytes": thalo.exchange_bytes(hm, d),
            "ring_is_oracle": [torch.equal(got[0], window),
                               torch.equal(got[1], own)],
            "ring_is_allgather": [torch.equal(a, b) for a, b in zip(got, ref)]}


def ring_rank(ctx, exchange_model, jobs):
    """The ring's exchanges on ``exchange_model``'s partition
    (:func:`_exchanges`, every rank's gathered to rank 0), then ``jobs``
    (``chunk_rank``'s halo jobs) with the ring and with the all-gather
    exchange.  Rank 0 returns (exchanges by rank, ring records, all-gather
    records)."""
    mine = _exchanges(ctx, thalo.partition(exchange_model, ctx.world))
    every = [None] * ctx.world
    dist.all_gather_object(every, mine)
    ring = chunk_rank(ctx, jobs)
    with allgather_exchange():
        ref = chunk_rank(ctx, jobs)
    return (every, ring, ref) if ctx.rank == 0 else None


def graph_rank(ctx, jobs):
    """``jobs`` (``chunk_rank``'s) stepped eagerly, as gloo ranks step,
    then through the graph path (``solver.graph.ChunkGraphs``, bound to
    the rank's comm) with each capture stood in for by an
    :class:`EagerReplay`.  Rank 0 returns (eager records, graph
    records)."""
    eager = chunk_rank(ctx, jobs)
    graph.ChunkGraphs._capture = stand_in_capture
    explicit.uses_graphs = lambda device, comm=None: True
    graphs = chunk_rank(ctx, jobs)
    return (eager, graphs) if ctx.rank == 0 else None
