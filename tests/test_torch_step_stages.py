"""The step's stages that XLA fuses on the TPU and kernels I, E and A run on
the card, held on the CPU against the JAX package: the central-difference
update (the plain version of kernel I) against JAX's ``_integrate``, the
erosion walk (kernel E's plain version) and the device ductile tables
against JAX's erosion and ``du_tables``, and the chunk-carried contact
activity (kernel A's plain version with its carry) against JAX's
``_init_activity``/``_next_activity`` and a per-step recompute; then a
contact chunk with deletions through the graph path's stand-in captures,
bitwise its eager chunk and a chunk that recomputes the masks every step.
The kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``[step-kernels]``)."""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig as JaxConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.ops import erosion as jer
from hakai_tpu.pre import synthetic as jsyn
from hakai_tpu.solver import explicit as jexp
from hakai_tpu_torch import SolverConfig, init_state, lower
from hakai_tpu_torch.core.lowering import _ductile_tables, model_from_numpy
from hakai_tpu_torch.ops.activity import chunk_carry
from hakai_tpu_torch.ops.broad_cuda import (broad, broad_phase,
                                           list_active, pair_activity)
from hakai_tpu_torch.ops.contact import contact_kinematics
from hakai_tpu_torch.ops.contact_cuda import pair_constants
from hakai_tpu_torch.ops.erosion_cuda import erosion_walk
from hakai_tpu_torch.pre import synthetic as tsyn
from hakai_tpu_torch.solver import explicit
from hakai_tpu_torch.solver.graph import ChunkGraphs
from rank_workers import stand_in_capture
from test_torch_contact_run import tie_free_impact
from test_torch_cuda import port_fast_model
from test_torch_erosion import DU_TABLES, _inputs
from test_torch_slice import carried, jax_model_numpy

# a 5-knot ramp with a dip, so that the steps below fall in each segment
# and past the last knot (where the first segment is extrapolated)
AMP_TIME = np.array([0.0, 2e-6, 5e-6, 8e-6, 1e-5])
AMP_VALUE = np.array([0.0, 0.4, 0.3, 0.9, 1.0])
STEPS = (0, 50, 120, 170, 400)          # dt = 5e-8
# normwise relative tolerances of the port's plain update against JAX's:
# the same IEEE operations in the same order, but XLA on the CPU may
# contract a multiply and an add into one FMA: a few ulps of the nodal
# type.  dwork: JAX's and torch's sums of 3N terms in other orders.
TOL = {"float32": 1e-6, "float64": 1e-14}
DWORK_TOL = {"float32": 1e-5, "float64": 1e-12}


def _bar(dtype, energy):
    bar = jsyn.bar_model(2, 2, 4, d_time=5e-8, end_time=1e-4)
    bar.amplitudes[0].time = AMP_TIME.copy()
    bar.amplitudes[0].value = AMP_VALUE.copy()
    return jax_lower(bar, JaxConfig(dtype=dtype, energy_check=energy,
                                    damping_C=2.0e3))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("contact", [False, True])
@pytest.mark.parametrize("energy", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64", "mixed"])
def test_integrate_matches_jax(monkeypatch, dtype, energy, contact):
    """The port's ``_integrate`` on the CPU (kernel I's plain version)
    against JAX's, from one random state at steps in each amplitude
    segment and past the table, with damping, with and without the energy
    balance and a contact force (both packages' ``contact_forces`` stood in
    for by one fixed random force); the generic step's element-dtype
    inputs against JAX's casts of its own update."""
    jm = _bar(dtype, energy)
    rng = np.random.default_rng(7)
    N, kdt = jm.N, np.dtype(jm.dtype)
    rand = {k: rng.normal(scale=1e-3, size=(3, N)) for k in
            ("disp", "disp_pre")}
    rand["Q"] = rng.normal(scale=1e2, size=(3, N))
    force = rng.normal(scale=1e2, size=(3, N)).astype(kdt)
    js0 = jax_init_state(jm).replace(
        **{k: jnp.asarray(v.astype(kdt)) for k, v in rand.items()})
    tm, ts0 = carried(jm, js0)
    if contact:
        monkeypatch.setattr(jexp, "contact_forces",
                            lambda *a, **k: jnp.asarray(force))
        monkeypatch.setattr(explicit, "contact_forces",
                            lambda *a, **k: torch.from_numpy(force))
        jm = dataclasses.replace(jm, pairs=("stand-in",))
        tm = dataclasses.replace(tm, pairs=("stand-in",))
    edt = np.dtype(jm.edtype)
    for t in STEPS:
        js = js0.replace(t=jnp.int32(t))
        ts = ts0.replace(t=torch.tensor(t, dtype=torch.int32))
        jt, jd, jv, jc, jw = jexp._integrate(jm, js)
        (tt, td, tv, tw, pos, du), tc = explicit._integrate(
            tm, ts, element_inputs=True)
        assert int(tt) == int(jt) == t + 1
        assert _rel(td, jd) <= TOL[str(kdt)], t
        assert _rel(tv, jv) <= TOL[str(kdt)], t
        assert (tc is None) == (not contact)
        if energy:
            assert _rel(tw, jw) <= DWORK_TOL[str(kdt)], t
        else:
            assert tw is None and jw is None
        assert pos.dtype == du.dtype == tm.edtype
        ref_pos = (np.asarray(jm.coord) + np.asarray(jd)).astype(edt)
        ref_du = (np.asarray(jd) - np.asarray(js.disp)).astype(edt)
        assert _rel(pos, ref_pos) <= TOL[str(edt)], t
        assert _rel(du, ref_du) <= TOL[str(edt)] * 10, t
    bc = np.asarray(jm.bcd_mask) & (np.asarray(jm.bcd_amp) == 0)
    assert bc.any()


def test_ductile_tables_match_du_tables():
    """The device knot table and row counts carry ``du_tables`` exactly
    (float64, zero padded; a material without a table has 0 rows), and a
    lowered model keeps them through ``to()``."""
    knots, rows = _ductile_tables(DU_TABLES)
    assert knots.shape == (3, 4, 2) and knots.dtype == np.float64
    assert rows.tolist() == [len(t) for t in DU_TABLES]
    for m, tab in enumerate(DU_TABLES):
        np.testing.assert_array_equal(knots[m, :len(tab)],
                                      np.asarray(tab).reshape(-1, 2))
        assert not knots[m, len(tab):].any()
    m = lower(tsyn.bar_model(2, 2, 4, ductile=True),
              SolverConfig(dtype="mixed"), device="cpu")
    assert m.du_knots.dtype == torch.float64 and m.du_n.dtype == torch.int32
    got = m.to("cpu")
    for mat, tab in enumerate(m.du_tables):
        n = int(got.du_n[mat])
        assert n == len(tab) > 1
        assert got.du_knots[mat, :n].tolist() == [list(r) for r in tab]


@pytest.mark.parametrize("step", ["packed", "generic"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_erosion_walk_matches_jax(dtype, step):
    """The walk as each step calls it against JAX's, bitwise, on three
    materials (two tables of several segments, one vertical, and one
    material without a table): the packed step's masked triaxiality and
    flag; the generic step's zeroed stress and strain; and the carry's
    flag, set exactly when an element died (then cleared by a walk that
    deletes nothing)."""
    eq, tri, flag, mat = _inputs(dtype, E=1024, seed=5)
    rng = np.random.default_rng(6)
    stress = rng.normal(size=(6, 8, 1024)).astype(dtype)
    strain = rng.normal(size=(6, 1024)).astype(dtype)
    jm = SimpleNamespace(du_tables=DU_TABLES, mat_id=jnp.asarray(mat))
    tm = SimpleNamespace(du_tables=DU_TABLES, mat_id=torch.from_numpy(mat))
    carry = SimpleNamespace(flags=torch.zeros(3, dtype=torch.int32))
    t = (torch.from_numpy(x) for x in (eq, tri, flag, stress, strain))
    eq_t, tri_t, flag_t, stress_t, strain_t = t
    if step == "packed":
        tri_m = jnp.where(jnp.asarray(flag)[None, :], jnp.asarray(tri), 0.0)
        ref_flag, ref_del = jer.erosion_delete_mask(jm, jnp.asarray(eq),
                                                    tri_m, jnp.asarray(flag))
        w = erosion_walk(tm, eq_t, tri_t, flag_t, mask_triax=True,
                         carry=carry)
        np.testing.assert_array_equal(w.triax.numpy(), np.asarray(tri_m))
        assert w.stress is None
    else:
        ref = jer.erode(jm, jnp.asarray(stress), jnp.asarray(strain),
                        jnp.asarray(eq), jnp.asarray(tri), jnp.asarray(flag))
        ref_flag, ref_del = ref.element_flag, ref.deleted_now
        w = erosion_walk(tm, eq_t, tri_t, flag_t, stress=stress_t,
                         strain=strain_t, carry=carry)
        np.testing.assert_array_equal(w.stress.numpy(),
                                      np.asarray(ref.stress))
        np.testing.assert_array_equal(w.strain.numpy(),
                                      np.asarray(ref.strain))
    np.testing.assert_array_equal(w.element_flag.numpy(),
                                  np.asarray(ref_flag))
    np.testing.assert_array_equal(w.deleted.numpy(), np.asarray(ref_del))
    assert w.deleted.any() and int(carry.flags[2]) == 1
    erosion_walk(tm, eq_t, tri_t, torch.zeros_like(flag_t), carry=carry)
    assert int(carry.flags[2]) == 0


def _impact_pair_models():
    """The JAX lowering of the tie-free impact (fracture on, every pair's
    masks depending on the life mask) and the port's model carried from
    it."""
    jm = jax_lower(tie_free_impact(jsyn), JaxConfig(dtype="float64"))
    assert jm.fracture_enabled and jm.pairs
    assert not any(p.static_activity for p in jm.pairs)
    return jm, model_from_numpy(*jax_model_numpy(jm), "cpu")


def test_carried_activity_matches_jax():
    """A chunk's carried masks across deletions: JAX's ``_init_activity``
    then ``_next_activity`` with ``changed`` from the life masks, against
    the port's carry (kernel A's plain version recomputing into the
    carried buffers when the carry's flag is set, the flag set at chunk
    entry and then by erosion), every step bitwise JAX's and a per-step
    recompute, the list of active triangles the mask's ids, the broad
    phase bitwise the per-step broad phase; and on a step whose flag is
    clear the masks and the list are kept even where a recompute would
    differ (the carry does carry)."""
    jm, tm = _impact_pair_models()
    rng = np.random.default_rng(11)
    alive = np.asarray(jm.elem_exists)
    cube = np.arange(jm.E)[alive][-27:]            # instance 1's elements
    flags = [alive.copy()]
    for kill in (rng.choice(cube, 3, False), [], rng.choice(cube, 5, False),
                 []):
        f = flags[-1].copy()
        f[np.asarray(kill, np.int64)] = False
        flags.append(f)
    s = init_state(tm)
    kin = contact_kinematics(tm, (tm.coord + s.disp).to(tm.edtype),
                             s.velo.to(tm.edtype))
    consts = [pair_constants(tm, p) for p in tm.pairs]
    act = None
    carry = chunk_carry(tm)
    assert carry is not None and int(carry.flags[2]) == 2

    def step_broad(ft):
        for i, (p, c) in enumerate(zip(tm.pairs, carry.pairs)):
            list_active(p, ft, c, carry.flags[2], carry.stats,
                        i == len(tm.pairs) - 1)
        return [broad(p, kin, tm.ckin_slices[i], ft, consts[i],
                      carry.pairs[i], carry.flags[2])
                for i, p in enumerate(tm.pairs)]
    for k, f in enumerate(flags):
        changed = k == 0 or bool((flags[k - 1] != f).any())
        act = (jexp._init_activity(jm, jnp.asarray(f)) if k == 0 else
               jexp._next_activity(jm, act, jnp.asarray(f),
                                   jnp.asarray(changed)))
        ft = torch.from_numpy(f)
        assert bool(carry.flags[2]) == changed
        for i, (p, bp) in enumerate(zip(tm.pairs, step_broad(ft))):
            fresh = pair_activity(p, ft)
            ref = broad_phase(p, kin, tm.ckin_slices[i], fresh,
                              consts[i])
            for a, b, c in zip(carry.pairs[i].masks, fresh, act[i]):
                assert torch.equal(a, b)
                np.testing.assert_array_equal(a.numpy(), np.asarray(c))
            ids = carry.pairs[i].ids[:int(carry.pairs[i].starts[-1])]
            assert torch.equal(ids, torch.nonzero(fresh[0]).reshape(-1)
                               .int())
            for a, b in zip(bp, ref):
                assert torch.equal(a, b)
        # the erosion walk of this step: did the next life mask lose
        # an element
        nxt = flags[min(k + 1, len(flags) - 1)]
        carry.flags[2] = int(bool((f & ~nxt).any()))
    kept = [tuple(x.clone() for x in (*c.masks, c.ids, c.starts))
            for c in carry.pairs]
    dead = flags[-1].copy()
    dead[cube] = False
    assert int(carry.flags[2]) == 0
    step_broad(torch.from_numpy(dead))
    differs = False
    for i, p in enumerate(tm.pairs):
        c = carry.pairs[i]
        assert all(torch.equal(a, b) for a, b in zip(
            (*c.masks, c.ids, c.starts), kept[i]))
        differs |= any(not torch.equal(a, b) for a, b in zip(
            pair_activity(p, torch.from_numpy(dead)), kept[i]))
    assert differs
    assert chunk_carry(tm, comm=object()) is None
    assert chunk_carry(tm) is carry and int(carry.flags[2]) == 2


@pytest.mark.parametrize("loop", ["packed", "generic"])
def test_contact_chunk_carries_activity(monkeypatch, loop):
    """The tie-free impact from step 30 for 25 steps (contact from step
    33, deletions at steps 41-50), float64, through ``graph_chunk`` with
    each capture stood in for by an eager replay, through ``eager_chunk``,
    and stepped outside any chunk, with no carry, where every step
    recomputes the activity masks: every state field bitwise equal."""
    monkeypatch.setattr(ChunkGraphs, "_capture", stand_in_capture)
    deck = tie_free_impact(tsyn)
    cfg = SolverConfig(dtype="float64", energy_check=True)
    m = (port_fast_model(deck, cfg) if loop == "packed"
         else lower(deck, cfg, device="cpu"))
    assert (m.coord_e is None) == (loop == "generic")
    s0 = explicit.eager_chunk(m, init_state(m), 30)
    got = explicit.graph_chunk(m, s0, 25, k=8)
    eager = explicit.eager_chunk(m, s0, 25)
    s, P = s0, explicit.pack_gauss_state(s0)
    for _ in range(25):
        if loop == "generic":
            s = explicit.step(m, s)
        else:
            s, P = explicit.step_fast_packed(m, s, P)
    if loop == "packed":
        s = explicit.finish_packed(m, s, P)
    for f in dataclasses.fields(s):
        a, b, c = (getattr(x, f.name) for x in (got, eager, s))
        assert torch.equal(a, b) and torch.equal(a, c), f.name
    assert int(got.element_flag.sum()) < int(s0.element_flag.sum())
    assert float(got.contact_force.abs().max()) > 0
    assert int(m._activity["carry"].flags[2]) == 0
