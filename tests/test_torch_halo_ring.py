"""The halo exchange as JAX's neighbour ring (``HaloComm.exchange_window``
and ``return_ghosts`` of ``hakai_tpu_torch.parallel.halo``: a rank sends
H rows to each neighbour and receives H rows from each) on 2 and 4 gloo
CPU ranks, each group spawned once (``rank_workers.ring_rank``).  Held
bit for bit to the all-gather of every rank's head and tail rows that it
replaced (kept in ``rank_workers`` as the reference) on seeded rows and
through packed and generic halo chunks, to an oracle built from every
rank's rows, and at 4 ranks to the JAX package's ``make_halo_step`` on
4 of the 8 virtual devices at tests/test_halo.py's tolerances; a rank's
exchange moves at most 2·C·H values each way at any rank count."""
import dataclasses

import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig as JConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.parallel import halo as jhalo
from hakai_tpu.parallel.sharding import make_mesh
from hakai_tpu_torch import SolverConfig, lower
from hakai_tpu_torch.parallel import dist as tdist
from hakai_tpu_torch.pre import synthetic as tsyn
from rank_workers import ring_rank
from test_torch_halo import CFG, GENERIC_TOL, _bar, _close, _renumbered_bar
from test_torch_slice import carried

# the generic bar's steps (test_torch_halo's JAX comparison) and the
# packed bar's
STEPS = {"generic": 60, "packed": 20}
_RUNS = {}


def _ring_run(S: int) -> dict:
    """The JAX generic bar (``gather_mode="xla"``: no Pallas call) and its
    port twin, the renumbered 8x8x64 bar (the packed loop), and ``S``
    gloo ranks' exchanges and chunks; one launch per ``S``, kept for the
    module."""
    if S not in _RUNS:
        jm = jax_lower(_bar(), JConfig(**CFG, gather_mode="xla"))
        generic = carried(jm, jax_init_state(jm))[0]
        packed = lower(_renumbered_bar(tsyn),
                       SolverConfig(dtype="float64", node_pad=64,
                                    renumber="always"), device="cpu")
        jobs = [dict(halo=True, model=m, chunks=[STEPS[k]])
                for k, m in (("generic", generic), ("packed", packed))]
        every, ring, ref = tdist.launch(ring_rank, S, "cpu", "gloo",
                                        generic, jobs)
        _RUNS[S] = dict(jm=jm, every=every, ring=dict(zip(STEPS, ring)),
                        ref=dict(zip(STEPS, ref)))
    return _RUNS[S]


@pytest.fixture(scope="module", params=[2, 4])
def ring(request):
    return request.param, _ring_run(request.param)


def test_exchanges_are_the_allgather_exchange(ring):
    """On every rank: the window of seeded (6, No) rows and the owned rows
    of seeded (3, W) window forces equal, bit for bit, the oracle's (the
    neighbours' rows from their seeds; zeros past rank 0 and rank S-1)
    and the all-gather exchange's."""
    S, r = ring
    assert [e["rank"] for e in r["every"]] == list(range(S))
    for e in r["every"]:
        assert e["ring_is_oracle"] == [True, True], e["rank"]
        assert e["ring_is_allgather"] == [True, True], e["rank"]


def test_exchange_bytes(ring):
    """Each exchange is one batch in which a rank sends C*H values to each
    neighbour and receives as many from each: at most 2*C*H values each
    way at any rank count (the all-gather received S*2*C*H), and the
    step's sum is ``exchange_bytes``."""
    S, r = ring
    for e in r["every"]:
        H, d = e["H"], e["rank"]
        neighbours = (d > 0) + (d < S - 1)
        want = [(C * H * 8 * neighbours,) * 2 for C in (6, 3)]
        assert e["batches"] == want, d
        for C, (sent, received) in zip((6, 3), e["batches"]):
            assert max(sent, received) <= 2 * C * H * 8
            assert received < S * 2 * C * H * 8
        assert sum(s for s, _ in e["batches"]) == e["step_bytes"]


@pytest.mark.parametrize("loop", list(STEPS))
def test_halo_chunks_are_the_allgather_chunks(ring, loop):
    """The generic and packed halo chunks with the ring, bit for bit the
    same chunks with the all-gather exchange patched in."""
    S, r = ring
    got, ref = r["ring"][loop], r["ref"][loop]
    assert got["partition"]["packed"] == (loop == "packed")
    differ = [f.name for f in dataclasses.fields(got["state"])
              if not torch.equal(getattr(got["state"], f.name),
                                 getattr(ref["state"], f.name))]
    assert differ == []
    assert int(got["state"].t) == STEPS[loop]
    assert float(got["state"].stress.abs().max()) > 0


def test_four_ranks_match_jax_halo_step():
    """The generic bar on 4 ring ranks against JAX's ``make_halo_step`` on
    4 of the 8 virtual devices, 60 steps, at tests/test_halo.py's
    tolerances; equal life masks."""
    r = _ring_run(4)
    jm = r["jm"]
    hm = jhalo.partition(jm, 4)
    hs = jhalo.make_halo_step(hm, make_mesh(4), n_steps=STEPS["generic"])(
        jhalo.init_halo_state(hm))
    ref = jhalo.gather_state(hm, hs)
    got = r["ring"]["generic"]["state"]
    assert int(got.t) == int(ref.t) == STEPS["generic"]
    assert np.array_equal(got.element_flag.numpy(),
                          np.asarray(ref.element_flag))
    _close(got, ref, GENERIC_TOL)
