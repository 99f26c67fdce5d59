"""The chunk loop's CUDA-graph path (``hakai_tpu_torch/solver/graph.py``)
on the CPU, where there are no graphs: the split of a chunk into replays,
the cache of captured lengths, the copy-out contract and the launch
counts, with each capture stood in for by an eager replay of the same
steps over the same static buffers (``rank_workers.EagerReplay``); and
``run_chunk`` on the CPU, which stays eager, against the JAX package's
``run_chunk`` over several chunks.  The graphs themselves run in the ``cuda`` tests of
``tests/test_torch_cuda.py`` and in ``chip_smoke.py``'s ``[graph]``
phase, bit for bit against the eager loop."""
import collections
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig as JaxConfig
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.pre.synthetic import bar_model as jax_bar_model
from hakai_tpu.solver.explicit import run_chunk as jax_run_chunk
from hakai_tpu_torch import SolverConfig, _build, init_state, lower, run_chunk
from hakai_tpu_torch.pre import synthetic as tsyn
from hakai_tpu_torch.solver import explicit
from hakai_tpu_torch.solver.graph import (GRAPH_STEPS, Captured, ChunkGraphs,
                                          split, write_back)
from rank_workers import EagerReplay
from test_torch_contact_run import _rel, tie_free_impact
from test_torch_slice import STATE, _compare, carried, jax_fast_model
from test_torch_cuda import port_fast_model

K = GRAPH_STEPS


@pytest.fixture
def captures(monkeypatch):
    """Every capture as (model id, loop, length); each "graph" an
    :class:`EagerReplay` that launches ``length`` float32 element kernels
    a replay by the counts (the plain versions on the CPU count none)."""
    seen = []

    def capture(self, model, length):
        seen.append((id(model), self.loop, length))
        launches = collections.Counter({"hk_element_f32": length})
        return Captured(EagerReplay(self, model, length), launches, 0.0,
                        0.0, 0)
    monkeypatch.setattr(ChunkGraphs, "_capture", capture)
    return seen


def _equal(a, b):
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


def _snapshot(s):
    return dataclasses.replace(s, **{f.name: getattr(s, f.name).clone()
                                     for f in dataclasses.fields(s)})


def _bar(loop, dtype="float32", ductile=False):
    bar = tsyn.bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4,
                         ductile=ductile)
    cfg = SolverConfig(dtype=dtype, energy_check=True)
    m = (port_fast_model(bar, cfg) if loop == "packed"
         else lower(bar, cfg, device="cpu"))
    assert (m.coord_e is None) == (loop == "generic")
    return m


@pytest.mark.parametrize("n", [0, 1, K - 1, K, K + 1, 3 * K + 2])
def test_split(n):
    """n steps are n // K replays of the K-step graph and one of n % K."""
    q, r = split(n)
    assert q * K + r == n and 0 <= r < K
    assert (q, r) == {0: (0, 0), 1: (0, 1), K - 1: (0, K - 1), K: (1, 0),
                      K + 1: (1, 1), 3 * K + 2: (3, 2)}[n]


def test_split_refuses():
    with pytest.raises(ValueError):
        split(-1)
    with pytest.raises(ValueError):
        split(5, 0)


def test_cache_captures_each_length_once(captures):
    """One model and length capture once, whatever the chunks; a model
    made by ``dataclasses.replace`` has graphs of its own, and a pickled
    model carries none."""
    m = _bar("packed")
    s = init_state(m)
    graph_chunk = explicit.graph_chunk
    for n in (K + 3, K + 3, 3, 2 * K):
        s = graph_chunk(m, s, n)
    assert captures == [(id(m), "packed", K), (id(m), "packed", 3)]
    m2 = dataclasses.replace(m)
    graph_chunk(m2, init_state(m2), 3)
    assert captures[-1] == (id(m2), "packed", 3) and len(captures) == 3
    graph_chunk(m, s, 5, k=4)            # another K: lengths 4 and 1
    assert captures[3:] == [(id(m), "packed", 4), (id(m), "packed", 1)]
    assert sorted(m._chunk_graphs["packed"].graphs) == [1, 3, 4, K]
    assert not pickle.loads(pickle.dumps(m)).__dict__.get("_chunk_graphs")
    g = lower(tsyn.bar_model(4, 4, 16), SolverConfig(dtype="float32"),
              device="cpu")
    graph_chunk(g, init_state(g), 1)
    assert captures[-1] == (id(g), "generic", 1)


def test_replays_add_captured_launches(captures):
    """Each replay adds the launches its capture counted."""
    m = _bar("packed")
    before = _build.LAUNCHES.copy()
    explicit.graph_chunk(m, init_state(m), 3 * K + 2)
    assert _build.LAUNCHES - before == {"hk_element_f32": 3 * K + 2}


@pytest.mark.parametrize("k", [1, 4, K])
@pytest.mark.parametrize("loop", ["packed", "generic", "contact"])
def test_graph_path_keeps_returned_states(captures, loop, k):
    """The replay bookkeeping against the eager loop, bit for bit: chunks
    of 5 and 7 steps in replays of k (k = 1 writes a graph's input disp
    into its disp_pre, the aliasing ``write_back`` orders), on the packed
    loop, the generic step and a contact deck; and a state returned by one
    chunk is unchanged after the next chunk runs (the copy-out the card
    relies on: the next chunk overwrites the static buffers)."""
    if loop == "contact":
        m = lower(tie_free_impact(tsyn, n=3),
                  SolverConfig(dtype="float64", energy_check=True),
                  device="cpu")
        assert m.pairs
        s0 = explicit.eager_chunk(m, init_state(m), 60)   # contact from 33
    else:
        m = _bar(loop, "mixed", ductile=True)
        s0 = init_state(m)
    s1 = explicit.graph_chunk(m, s0, 5, k=k)
    kept = _snapshot(s1)
    s2 = explicit.graph_chunk(m, s1, 7, k=k)
    assert _equal(s1, kept) == []
    e1 = explicit.eager_chunk(m, s0, 5)
    assert _equal(s1, e1) == []
    assert _equal(s2, explicit.eager_chunk(m, e1, 7)) == []
    assert int(s2.t) == int(s0.t) + 12


def test_write_back_reads_before_it_writes():
    """An output that is another field's buffer is read before that buffer
    is written; an output that is its own buffer stays."""
    a, b, c = (torch.tensor([float(i)]) for i in range(3))
    static = [a, b, c]
    write_back(static, [torch.tensor([5.0]), a, c])     # b <- old a
    assert (a.item(), b.item(), c.item()) == (5.0, 0.0, 2.0)


def test_cpu_run_chunk_stays_eager(monkeypatch):
    """On the CPU ``run_chunk`` never reaches the graph path and builds no
    graphs: it is the eager loop, bit for bit."""
    def refuse(*a, **k):
        raise AssertionError("graph_chunk on the CPU")
    monkeypatch.setattr(explicit, "graph_chunk", refuse)
    for loop in ("packed", "generic"):
        m = _bar(loop)
        s = run_chunk(m, init_state(m), 10)
        assert _equal(s, explicit.eager_chunk(m, init_state(m), 10)) == []
        assert "_chunk_graphs" not in m.__dict__


@pytest.mark.parametrize("chunks", [2, 3])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cpu_chunks_match_jax(dtype, chunks):
    """The ductile 4x4x16 bar on both packed loops (the JAX package's
    ``step_fast``), from the JAX model and state carried across, in chunks
    of 40 steps: after every chunk equal flags, and each field within
    1e-10 of its scale in float64 (tests/test_torch_fracture.py's bound);
    in float32 within 10x the distance between the JAX float32 and
    float64 runs, floored at float32's unit roundoff (the envelope of
    tests/test_torch_mixed.py)."""
    bar = jax_bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4, ductile=True)
    jm = jax_fast_model(bar, JaxConfig(dtype=dtype, energy_check=True))
    j64 = jax_fast_model(bar, JaxConfig(dtype="float64", energy_check=True))
    js, js64 = jax_init_state(jm), jax_init_state(j64)
    tm, ts = carried(jm, js)
    for c in range(1, chunks + 1):
        js = jax_run_chunk(jm, js, 40)
        ts = run_chunk(tm, ts, 40)
        np.testing.assert_array_equal(ts.element_flag.numpy(),
                                      np.asarray(js.element_flag))
        if dtype == "float64":
            _compare(js, ts, {"*": 1e-10})
            continue
        js64 = jax_run_chunk(j64, js64, 40)
        for name in STATE:
            env = max(_rel(getattr(js, name), getattr(js64, name)),
                      2.0 ** -23)
            err = _rel(getattr(ts, name).numpy(), getattr(js, name))
            assert err <= 10 * env, (40 * c, name, err, env)
    assert int(ts.t) == 40 * chunks and float(ts.eq_ps.max()) > 0
    assert "_chunk_graphs" not in tm.__dict__
