"""Contact trajectories of the port on the CPU against the JAX package's
run_chunk and run() and against the NumPy oracle: the self-contact plates
in float64, and a two-body impact with erosion in float64 and in mixed
precision."""
import json

import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.pre import synthetic as jsyn
from hakai_tpu.solver.explicit import run as jax_run
from hakai_tpu.solver.explicit import run_chunk as jax_run_chunk
from hakai_tpu_torch import init_state, lower, run, run_chunk
from hakai_tpu_torch.pre import synthetic as tsyn
from hakai_tpu_torch.utils.checkpoint import load_checkpoint
from ref_oracle import Oracle
from test_torch_run import _sections
from test_torch_slice import carried, jax_fast_model, port_fast_model


def tie_free_impact(syn, n=3, d_time=2e-8, end_time=6e-6):
    """impact_model with the cube moved off the slab's grid lines (aligned
    grids put nodes on triangle edges, where the accept tests are ties of
    the association order) and the ductile table of the JAX package's
    multi-host impact test (fracture strain 0.02 at triaxiality 0, 0.01 at
    0.3), so elements erode within a few hundred steps."""
    m = syn.impact_model(n=n, v0=8.0e4, d_time=d_time, end_time=end_time)
    tsyn.offset_instance(m, 1, 0.013, 0.017)
    m.materials[0].ductile = np.array([[0.02, 0.0, 30.0], [0.01, 0.3, 30.0]])
    return m


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_self_contact_matches_jax():
    """The self-contact plates (one instance, the self pair's own-element
    exclusion, ddiv scale 0.6) for 300 steps in chunks of 50, float64:
    disp, stress and eq_ps within 1e-9 normwise, the bound
    tests/test_oracle_diff.py holds the JAX package to against the oracle.
    Contact fires: the lower plate moves, and nothing else loads it."""
    jm = jax_fast_model(jsyn.self_contact_model(), SolverConfig(
        dtype="float64", energy_check=True))
    assert len(jm.pairs) == 1 and jm.pairs[0].is_self
    js = jax_init_state(jm)
    tm, ts = carried(jm, js)
    fired = False
    for _ in range(6):
        js = jax_run_chunk(jm, js, 50)
        ts = run_chunk(tm, ts, 50)
        for name in ("disp", "stress", "eq_ps"):
            assert _rel(getattr(ts, name).numpy(), getattr(js, name)) < 1e-9
        fired |= bool(ts.contact_force.abs().max() > 0)
    lower_free = np.asarray(jm.coord[2]) == 0.2
    assert fired and np.abs(ts.disp.numpy()[:, lower_free]).max() > 1e-6


@pytest.mark.parametrize("dtype", ["float64", "mixed"])
def test_impact_with_erosion_matches_jax(dtype):
    """The tie-free impact (n=3, 63 elements) for 300 steps: 30, then one
    step at a time to step 60 (the gap closes at step 31), then chunks of
    30.  Contact fires at the same step on both sides and elements erode.
    Flags equal JAX's after every chunk.  float64: disp within 1e-9
    normwise.  Mixed: disp within 1e-3 and stress within 1e-2 of scale,
    the envelope tests/test_mixed_precision.py holds the JAX mixed run to
    against float64 (measured here: disp 5.7e-5, stress 1.0e-5 at step
    300)."""
    jm = jax_fast_model(tie_free_impact(jsyn), SolverConfig(
        dtype=dtype, energy_check=True))
    assert jm.fracture_enabled and not any(p.static_activity
                                           for p in jm.pairs)
    js = jax_init_state(jm)
    tm, ts = carried(jm, js)
    first = {}
    for n in [30] + [1] * 30 + [30] * 8:
        js = jax_run_chunk(jm, js, n)
        ts = run_chunk(tm, ts, n)
        step = int(ts.t)
        np.testing.assert_array_equal(ts.element_flag.numpy(),
                                      np.asarray(js.element_flag),
                                      err_msg=f"step {step}")
        for side, f in (("jax", np.asarray(js.contact_force)),
                        ("port", ts.contact_force.numpy())):
            if np.abs(f).max() > 0:
                first.setdefault(side, step)
        err = _rel(ts.disp.numpy(), js.disp)
        if dtype == "float64":
            assert err < 1e-9, (step, err)
        else:
            assert err < 1e-3, (step, err)
            s_ref = np.asarray(js.stress, np.float64)
            s_err = np.abs(ts.stress.numpy() - s_ref).max()
            assert s_err < 1e-2 * max(np.abs(s_ref).max(), 1.0), (step, s_err)
    assert first["jax"] == first["port"] and 30 < first["port"] <= 60, first
    assert 0 < int(ts.element_flag.sum()) < tm.n_element
    assert ts.contact_force.dtype == tm.dtype


def _oracle_view(tm, ts):
    """The port's state in the oracle's layouts and deck order."""
    nN, nE = tm.n_node, tm.n_element
    disp = ts.disp.numpy()[:, :nN]
    stress = ts.stress.numpy()[:, :, :nE].transpose(0, 2, 1)
    eq = ts.eq_ps.numpy()[:, :nE].T
    return disp, stress, eq


def test_self_contact_matches_oracle():
    """The port's own lowering of the self-contact plates (32 elements:
    the generic step) against the NumPy oracle's transliteration of the
    reference (explicit B matrices, dynamic triangle lists), 300 steps,
    within 1e-9 as the JAX package."""
    m = tsyn.self_contact_model()
    o = Oracle(jsyn.self_contact_model())
    tm = lower(m, SolverConfig(dtype="float64"), device="cpu")
    assert tm.node_new2old is None
    ts = init_state(tm)
    for _ in range(6):
        for _ in range(50):
            o.step()
        ts = run_chunk(tm, ts, 50)
        disp, stress, eq = _oracle_view(tm, ts)
        assert _rel(disp, o.disp.reshape(-1, 3).T) < 1e-9
        assert _rel(stress, o.integ_stress) < 1e-9
        assert _rel(eq, o.eq_ps) < 1e-9
    assert np.abs(disp[:, m.coordmat[2] == 0.2]).max() > 1e-6


def _cfg(out_dir):
    return SolverConfig(dtype="float64", output_num=6, energy_check=True,
                        metrics_path=f"{out_dir}/metrics.jsonl",
                        checkpoint_every=3, out_dir=str(out_dir))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """run() of the tie-free impact (300 steps, 6 frames) in both
    packages, float64, both on their packed chunk loops."""
    jdir, tdir = (tmp_path_factory.mktemp(k) for k in ("jax", "port"))
    jm = jax_fast_model(tie_free_impact(jsyn), _cfg(jdir))
    js = jax_run(jm, verbose=False)
    tm = port_fast_model(tie_free_impact(tsyn), _cfg(tdir))
    ts = run(tm, verbose=False, device="cpu")
    return dict(jdir=jdir, tdir=tdir, js=js, tm=tm, ts=ts)


def test_run_frames_match_jax(runs):
    """Same frame files and collection.pvd bytes; per frame the same
    section headers (CELLS counts the alive elements), connectivity and
    cell types, and every float field within 1e-6 of its scale."""
    jdir, tdir = runs["jdir"], runs["tdir"]
    names = sorted(p.name for p in jdir.glob("file*.vtk"))
    assert names == sorted(p.name for p in tdir.glob("file*.vtk"))
    assert len(names) == 7
    assert ((jdir / "collection.pvd").read_bytes()
            == (tdir / "collection.pvd").read_bytes())
    cells = []
    for name in names:
        ref = _sections((jdir / name).read_text())
        got = _sections((tdir / name).read_text())
        assert [h for h, _ in got] == [h for h, _ in ref], name
        for (head, a), (_, b) in zip(ref, got):
            assert len(a) == len(b), (name, head)
            if head.startswith(("CELLS", "CELL_TYPES")):
                assert a == b, (name, head)
            elif a:
                fa = np.array([x.split() for x in a], np.float64)
                fb = np.array([x.split() for x in b], np.float64)
                scale = max(np.abs(fa).max(), 1e-300)
                assert np.abs(fa - fb).max() <= 1e-6 * scale, (name, head)
        cells.append(int(ref[2][0].split()[1]))
    assert cells[0] == 63 and cells[-1] < 63


def test_run_metrics_match_jax(runs):
    """Same records; every value within 1e-9 relative (the balance
    residual against the energy scale); contact_force_max is non-zero
    once contact fires."""
    rows = [[json.loads(x) for x in (runs[d] / "metrics.jsonl").open()]
            for d in ("jdir", "tdir")]
    assert len(rows[0]) == len(rows[1]) == 6
    for a, b in zip(*rows):
        assert set(a) == set(b)
        scale = max(abs(a["kinetic_energy"]), abs(a["work_external"]),
                    abs(a["elastic_energy"] + a["plastic_dissipation"]))
        for k in a:
            if k == "wall_s":
                continue
            ref = scale if k == "balance_residual" else \
                1.0 if k == "energy_rel_error" else abs(a[k])
            assert abs(a[k] - b[k]) <= 1e-9 * max(ref, 1e-300), (k, a, b)
    assert any(r["contact_force_max"] > 0 for r in rows[1])


def test_checkpoints_resume_across_packages(runs):
    """The JAX run's frame-3 checkpoint resumes in the port and ends with
    the JAX run's flags and state (1e-9); the port's own resumes bitwise."""
    tm, ts = runs["tm"], runs["ts"]
    for d in ("jdir", "tdir"):
        s3 = load_checkpoint(str(runs[d] / "ckpt_003.npz"), init_state(tm))
        assert 0 < int(s3.t) < tm.time_num
        out = run(tm, s3, verbose=False, write_output=False, device="cpu")
        np.testing.assert_array_equal(out.element_flag.numpy(),
                                      np.asarray(runs["js"].element_flag))
        for name in ("disp", "velo", "contact_force", "stress"):
            assert _rel(getattr(out, name).numpy(),
                        getattr(runs["js"], name)) < 1e-9, (d, name)
        if d == "tdir":
            for name in ("disp", "contact_force", "stress", "work"):
                assert torch.equal(getattr(out, name), getattr(ts, name))
