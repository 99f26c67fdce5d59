"""The port's metrics stream and negative-Jacobian count against the
benchmark's plain reference (``portbench/reference/metrics.py``), on the
CPU; the configuration ``bar131k_mixed_xla`` and the readers of its cell's
per-layer metrics, without the card."""
import copy
import json

import numpy as np
import pytest
import torch

from hakai_tpu_torch.core.lowering import uses_plans
from hakai_tpu_torch.ops.element import neg_jacobian_count
from hakai_tpu_torch.solver import explicit
from portbench import program, roofline_generic, run as bench
from portbench.reference import decks
from portbench.reference import metrics as ref_metrics

CELL = "bar131k_mixed_xla.metrics"
# the cell's deck cut to 4x4x16 and 200 steps, pulled at 100x the deck's
# rate so that the bar yields (plastic dissipation > 0) within them
TINY = dict(nx=4, ny=4, nz=16, d_time=5e-8, end_time=1e-5, ramp_end=1e-4)
SEED = 2147490533
# values the program forms in float64 in every precision: the same sums
# of the same float64 terms in another order, so within 1e-9
EXACT = 1e-9
# in mixed precision the elastic energy and the plastic dissipation are
# float32 sums over the 2,048 Gauss points (vol_e, G_e, lam_e, stress,
# eq_ps and yield in the element dtype): a few float32 roundings (8.6e-8
# measured), so 1e-6
F32_SUMS = {"elastic_energy", "plastic_dissipation"}
F32 = 1e-6


def tiny_spec(tmp_path, dtype="mixed"):
    spec = copy.deepcopy(bench.cell_spec(CELL))
    spec["config"]["deck"]["args"].update(TINY)
    spec["config"]["solver"].update(
        dtype=dtype, metrics_path=str(tmp_path / "metrics.jsonl"))
    spec["traffic"]["output_num"] = 10
    return spec


@pytest.fixture(scope="module", params=["float64", "mixed"])
def stream(request, tmp_path_factory):
    """One ``run()`` of the cut deck on the CPU with the stream on, every
    chunk's end state recorded with its work."""
    tmp = tmp_path_factory.mktemp(request.param)
    spec = tiny_spec(tmp, request.param)
    deck = bench.deck_of(spec, SEED)
    model = program.lower(deck, bench.solver_of(spec), str(tmp), "cpu")
    chunk, ends = explicit.run_chunk, {}

    def recording(m, state, n, comm=None):
        out = chunk(m, state, n, comm)
        ends[int(out.t)] = dict(program.deck_order(
            m, program.host_copy(out)), work=out.work.double().numpy())
        return out

    tm = {}
    explicit.run_chunk = recording
    try:
        program.simulate(model, False, tm)
    finally:
        explicit.run_chunk = chunk
    recs = [json.loads(x) for x in open(tmp / "metrics.jsonl")]
    return dict(dtype=request.param, deck=deck, model=model, ends=ends,
                recs=recs, timings=tm)


def test_stream_matches_reference(stream):
    """Every record against the reference on the program's own state at
    that chunk's end: within ``EXACT`` of the value (``F32`` for the
    float32 sums of mixed precision); the balance residual against the
    run's energy scale and its relative error absolutely, as
    ``test_metrics_match_jax`` holds them (both are roundoff
    themselves)."""
    deck, recs = stream["deck"], stream["recs"]
    assert len(recs) == 10 and sorted(stream["ends"]) == \
        [r["step"] for r in recs]
    ref = ref_metrics.Reference(deck, "cpu")
    for r in recs:
        want = ref_metrics.record(deck, stream["ends"][r["step"]], True,
                                  ref=ref)
        assert set(want) | {"step", "time", "wall_s"} == set(r)
        scale = max(abs(want["kinetic_energy"]), abs(want["work_external"]),
                    abs(want["elastic_energy"]
                        + want["plastic_dissipation"]))
        for k, v in want.items():
            tol = F32 if stream["dtype"] == "mixed" and k in F32_SUMS \
                else EXACT
            size = scale if k == "balance_residual" else \
                1.0 if k == "energy_rel_error" else abs(v)
            assert abs(r[k] - v) <= tol * max(size, 1e-300), (k, r[k], v)
    last = recs[-1]
    assert last["plastic_dissipation"] > 0 and last["alive_elements"] == 256
    assert stream["timings"]["chunks"] == 10
    assert stream["timings"]["metrics_s"] > 0


def _inverted(model, deck, invert: bool):
    """A seeded deck-order displacement (n, 3), with one corner node of
    the bar's top face pushed through its element when ``invert``, and
    the program's (3, N) position in its element dtype."""
    rng = np.random.default_rng(7)
    disp = rng.normal(scale=1e-3, size=(deck.n_node, 3))
    if invert:
        disp[deck.n_node - 1, 2] = -6.0     # elements 3.125 mm high
    pos = model.coord.double().clone()
    pos[:, :deck.n_node] += torch.from_numpy(disp.T)
    return disp, pos.to(model.edtype)


@pytest.mark.parametrize("invert", [True, False],
                         ids=["inverted", "clean"])
def test_plain_count_matches_reference(tmp_path, invert):
    """The program's plain count (the CPU path and the card kernel's
    oracle) against the reference's own hex8 shape-function derivatives:
    equal, above 0 with an inverted corner and 0 without; a dead element
    leaves the count."""
    spec = tiny_spec(tmp_path, "float64")
    deck = bench.deck_of(spec, SEED)
    model = program.lower(deck, bench.solver_of(spec), str(tmp_path), "cpu")
    disp, pos = _inverted(model, deck, invert)
    alive = np.ones(deck.n_elem, bool)
    flag = model.elem_exists.clone()
    got = int(neg_jacobian_count(model, pos[:, model.elem], flag))
    want = ref_metrics.neg_jacobian_count(deck, disp, alive)
    assert got == want and (want > 0) == invert
    if invert:                          # the inverted corner's element dies
        owner = int(np.nonzero((deck.elem == deck.n_node - 1).any(0))[0][0])
        flag[owner] = alive[owner] = False
        got = int(neg_jacobian_count(model, pos[:, model.elem], flag))
        assert got == ref_metrics.neg_jacobian_count(deck, disp, alive) \
            < want


def test_configuration_loads_and_takes_the_generic_step(tmp_path):
    """The cell's files load by name; its deck, at full size and cut,
    takes no window plans, and the cut lowers in deck order without
    ``coord_e`` (the generic step)."""
    spec = bench.cell_spec(CELL)
    solver = spec["config"]["solver"]
    assert solver["gather_mode"] == "xla" and solver["metrics_path"]
    assert spec["traffic"] == dict(spec["traffic"], write_output=False,
                                   end_time=None, output_num=100)
    assert spec["cell"]["check_chunks"] == 8
    names = {m["name"] for m in spec["per_layer"]}
    assert {"metrics_ms_per_chunk", "generic_element_roofline"} <= names
    cfg = bench.solver_of(spec)
    full = decks.build(spec["config"]["deck"], SEED, 0.0)
    from hakai_tpu_torch import SolverConfig
    assert full.n_elem == 131072 and not uses_plans(
        program.port_model(full), SolverConfig(**cfg))
    tiny = tiny_spec(tmp_path)
    model = program.lower(bench.deck_of(tiny, SEED), bench.solver_of(tiny),
                          str(tmp_path), "cpu")
    assert model.coord_e is None and model.node_new2old is None
    assert model.elem_new2old is None


@pytest.mark.parametrize("name", ["metrics_ms_per_chunk",
                                  "generic_element_roofline"])
def test_readers_none_without_their_counters(name):
    """Each reader gives None where the program keeps no counter or the
    trace holds no unpacked-entry kernel (the parent's runs), and a
    number from what it reads."""
    read = bench.reader(name)
    ctx = dict(timings=[{"chunks": 100, "steps": 10000, "step_s": 1.0}],
               trace=None, E=131072, N=140544, dtype="mixed")
    assert read(ctx) is None
    if name == "metrics_ms_per_chunk":
        ctx["timings"] = [dict(ctx["timings"][0], metrics_s=0.05)] * 2
        assert read(ctx) == pytest.approx(0.5)
        return
    packed = "void (anonymous namespace)::element_kernel<double, float, " \
        "false, true, 4, false>(int const*)"
    ctx["trace"] = dict(window=(0, 10**6), host=[],
                        device=[(packed, 0, 60000)])
    assert read(ctx) is None
    generic = "void (anonymous namespace)::element_kernel<float, float, " \
        "true, true, 4, true>(int const*)"
    ctx["trace"]["device"] += [(generic, 0, 60000), (generic, 10**5,
                                                     10**5 + 80000)]
    bound = roofline_generic.generic_element_bound_s(131072, 140544,
                                                     "mixed")
    assert read(ctx) == pytest.approx(bound / 70e-6 * 100.0)
    assert 40.0 < read(ctx) < 45.0
