"""A rank's chunk through the graph path (``solver/graph.ChunkGraphs``
bound to the rank's comm), as NCCL ranks run it on the card, held bit for
bit to the eager rank chunk on two gloo CPU ranks, spawned once.  A CPU
has no CUDA graphs, so each capture is stood in for by an eager replay of
the same steps over the same static buffers
(``rank_workers.EagerReplay``), as in ``tests/test_torch_graph.py``; the
replays' collectives are gloo's.  The captured graphs themselves run on
one NCCL rank in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s
``[nccl]`` phase."""
import dataclasses

import pytest
import torch

from hakai_tpu_torch import SolverConfig, lower
from hakai_tpu_torch.parallel import dist as tdist
from hakai_tpu_torch.pre import synthetic as tsyn
from rank_workers import graph_rank, loop_entries
from test_torch_cuda import erosion_free_impact, port_fast_model

# two chunks: 40 steps are a replay of the 32-step graph and one of an
# 8-step graph, 7 steps one of a 7-step graph
CHUNKS = [40, 7]


def _bar(**kw):
    return tsyn.bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4, **kw)


CASES = {
    "sharded packed": lambda: dict(model=port_fast_model(
        _bar(ductile=True), SolverConfig(dtype="mixed", energy_check=True,
                                         elem_pad=8)), chunks=CHUNKS),
    "sharded generic": lambda: dict(model=lower(
        _bar(), SolverConfig(dtype="float64", energy_check=True,
                             elem_pad=8), device="cpu"), chunks=CHUNKS),
    "sharded contact": lambda: dict(model=lower(
        erosion_free_impact(), SolverConfig(dtype="float64", elem_pad=8),
        device="cpu"), chunks=[70, 30]),
    "halo packed": lambda: dict(halo=True, model=lower(
        tsyn.bar_model(nx=8, ny=8, nz=64, d_time=1e-8, end_time=1.0),
        SolverConfig(dtype="float64", node_pad=64, renumber="always"),
        device="cpu"), chunks=CHUNKS),
    "halo generic": lambda: dict(halo=True, model=lower(
        _bar(), SolverConfig(dtype="float64", node_pad=64), device="cpu"),
        chunks=CHUNKS),
}


@pytest.fixture(scope="module")
def runs():
    jobs = {k: f() for k, f in CASES.items()}
    eager, graphs = tdist.launch(graph_rank, 2, "cpu", "gloo",
                                 list(jobs.values()))
    return {k: (j, e, g) for (k, j), e, g in zip(jobs.items(), eager,
                                                  graphs)}


@pytest.mark.parametrize("case", list(CASES))
def test_rank_graph_chunk_is_eager_chunk(runs, case):
    """Every field of the whole state after each chunk bit for bit the
    eager rank chunk's; the graph path's launches of the element kernel
    and the assembly equal to its steps (each replay adds what its
    capture counted), the eager path's none (plain versions); the loop
    the case names, its captured lengths 32, 8 and 7."""
    job, eager, graphs = runs[case]
    differ = [f.name for f in dataclasses.fields(eager["state"])
              if not torch.equal(getattr(eager["state"], f.name),
                                 getattr(graphs["state"], f.name))]
    assert differ == []
    assert eager["alive"] == graphs["alive"]
    assert eager["contact_max"] == graphs["contact_max"]
    loop = ("halo " if job.get("halo") else "") + \
        ("packed" if job["model"].coord_e is not None else "generic")
    assert list(graphs["captures"]) == [loop]
    steps = sum(job["chunks"])
    assert graphs["launches"] == dict.fromkeys(
        loop_entries(job["model"], loop.endswith("generic")), steps)
    assert not any(eager["launches"].values())
    if case == "sharded contact":
        assert graphs["contact_max"][-1] > 0
    assert sorted(graphs["captures"][loop]) == \
        sorted({32, 8, 7} if job["chunks"] == CHUNKS else {32, 6, 30})
    assert eager["captures"] == {}
    if job.get("halo"):
        assert graphs["partition"]["packed"] == (case == "halo packed")
