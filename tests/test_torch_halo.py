"""The port's node-sharded halo decomposition (``hakai_tpu_torch.parallel.
halo``) on the CPU: two gloo ranks, spawned once for every stepping check
(one launch of many ``chunk_rank`` jobs).  Held against the JAX package's
``partition`` field by field, against its ``make_halo_step`` on a
2-device mesh at tests/test_halo.py's tolerances (the generic step, the
fracture deck and contact with erosion), against the port's own
single-device packed loop, and through ``run(halo=2)`` with frames,
shard-major checkpoints that pass between the packages, and metrics."""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig as JConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.io.model import BC, IC
from hakai_tpu.parallel import halo as jhalo
from hakai_tpu.parallel.sharding import make_mesh
from hakai_tpu.pre import synthetic as jsyn
from hakai_tpu.utils.metrics import halo_step_metrics as jax_halo_metrics
from hakai_tpu.utils.metrics import step_metrics as jax_step_metrics
from hakai_tpu_torch import SolverConfig, init_state, lower, run, run_chunk
from hakai_tpu_torch.parallel import dist as tdist
from hakai_tpu_torch.parallel import halo as thalo
from hakai_tpu_torch.parallel.sharding import chunk_rank
from hakai_tpu_torch.pre import synthetic as tsyn
from hakai_tpu_torch.utils.metrics import halo_step_metrics
from test_element import unit_cube_model
from test_torch_slice import carried

SHARDS = 2
# tests/test_halo.py's tolerances: (rtol, atol) per field
GENERIC_TOL = {"disp": (1e-10, 1e-14), "velo": (1e-10, 1e-12),
               "stress": (1e-9, 1e-12), "eq_ps": (1e-9, 1e-15)}
FRACTURE_TOL = {"disp": (1e-9, 1e-12), "stress": (1e-8, 1e-10)}
FAST_TOL = {"disp": (1e-9, 1e-13), "stress": (1e-8, 1e-10)}
CONTACT_TOL = {"disp": (1e-9, 1e-12), "stress": (1e-7, 1e-9)}
# the partition's fields, compared with the JAX package's one by one
PART_FIELDS = ("elem_w", "elem_gid", "elem_alive0", "mat_id", "G_e",
               "lam_e", "has_plastic_e", "yield0_e", "vol_e", "diag_M",
               "coord", "node_exists", "bc_mask", "bc_value", "bc_amp",
               "velo0", "coord_e", "cn_local", "cn_mask", "cn_inv", "eg_inv")


def _bar():
    """tests/test_halo.py's _bar(): a 32x2x2 plastic bar with an initial
    velocity (generic step in both packages)."""
    m = unit_cube_model(nx=32, ny=2, nz=2, lx=32.0,
                        plastic=[[0.5, 0.0], [1.0, 1.0]])
    dofs = np.arange(1, m.n_node * 3 + 1, 3) + 2
    m.ics.append(IC(type="VELOCITY", dof=[dofs], value=[3.0]))
    m.d_time = 1e-3
    m.end_time = 1.0
    return m


def _fracture():
    """tests/test_halo.py's fracture deck: the bar clamped at one end and
    pulled, with a ductile table that deletes elements."""
    m = unit_cube_model(nx=32, ny=2, nz=2, lx=32.0,
                        plastic=[[0.1, 0.0], [0.2, 1.0]])
    m.materials[0].ductile = np.array([[0.05, 0.0, 30.0], [0.05, 0.9, 30.0]])
    m.materials[0].fracture_flag = 1
    dofs = np.arange(1, m.n_node * 3 + 1, 3) + 2
    m.ics.append(IC(type="VELOCITY", dof=[dofs], value=[8.0]))
    left = np.nonzero(np.asarray(m.coordmat[0]) == 0.0)[0] + 1
    enc = BC()
    enc.dof.append(np.concatenate([left * 3 - 2, left * 3 - 1, left * 3]))
    enc.value = [0.0]
    m.bcs.append(enc)
    m.d_time = 2e-3
    m.end_time = 2.0
    return m


def _impact(pkg):
    """The off-grid impact with erosion (tests/test_torch_sharding.py's),
    built by either package's synthetic module."""
    return tsyn.offset_instance(pkg.impact_model(n=4, v0=2e5, d_time=1e-8,
                                                 end_time=1e-6), 1, 0.013,
                                0.017)


def _renumbered_bar(pkg):
    """The 8x8x64 bar renumbered as the CLI's --halo renumbers: 4,096
    elements, window plans, so both packages take the fast path."""
    return pkg.bar_model(nx=8, ny=8, nz=64, d_time=1e-8, end_time=1.0)


CFG = dict(node_pad=64, elem_pad=8, energy_check=True)
# (JAX model, steps) of the decks held against JAX's make_halo_step
JAX_CASES = {
    "generic": (lambda: jax_lower(_bar(), JConfig(**CFG)), 60),
    "fracture": (lambda: jax_lower(_fracture(), JConfig(**CFG)), 120),
    "contact": (lambda: jax_lower(_impact(jsyn), JConfig(
        node_pad=8, elem_pad=8, renumber="always")), 100),
}


@pytest.fixture(scope="module")
def runs():
    """The JAX models and halo results, and the port's two ranks on every
    job in one launch: the JAX cases from the carried models, the fast
    path on the renumbered bar, and the resume round trip (60 + 30 steps
    through gather_state/partition_state) beside 90 straight steps."""
    jms = {k: f() for k, (f, _) in JAX_CASES.items()}
    ports = {k: carried(jm, jax_init_state(jm))[0] for k, jm in jms.items()}
    fast = lower(_renumbered_bar(tsyn),
                 SolverConfig(dtype="float64", node_pad=64,
                              renumber="always"), device="cpu")
    jobs = {k: dict(halo=True, model=ports[k], chunks=[n])
            for k, (_, n) in JAX_CASES.items()}
    jobs["fast"] = dict(halo=True, model=fast, chunks=[60], trace=2)
    jobs["roundtrip"] = dict(halo=True, model=ports["generic"],
                             chunks=[60, 30], roundtrip=True)
    jobs["straight"] = dict(halo=True, model=ports["generic"], chunks=[90])
    res = dict(zip(jobs, tdist.launch(chunk_rank, SHARDS, "cpu", "gloo",
                                      list(jobs.values()))))
    mesh = make_mesh(SHARDS)
    jax_out = {}
    for k, (_, n) in JAX_CASES.items():
        hm = jhalo.partition(jms[k], SHARDS)
        hs = jhalo.make_halo_step(hm, mesh, n_steps=n)(
            jhalo.init_halo_state(hm))
        jax_out[k] = (hm, hs, jhalo.gather_state(hm, hs))
    return dict(jms=jms, ports=ports, fast=fast, res=res, jax=jax_out)


def _close(got, ref, tol):
    for name, (rtol, atol) in tol.items():
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", ["generic", "fracture", "contact"])
def test_matches_jax_halo_step(runs, case):
    """The port's two ranks against JAX's make_halo_step on a 2-device
    mesh, at tests/test_halo.py's tolerances; equal deletion flags (the
    fracture and contact decks delete elements)."""
    got = runs["res"][case]["state"]
    hm, _, ref = runs["jax"][case]
    n = JAX_CASES[case][1]
    assert int(got.t) == int(ref.t) == n
    assert np.array_equal(got.element_flag.numpy(),
                          np.asarray(ref.element_flag))
    _close(got, ref, {"generic": GENERIC_TOL, "fracture": FRACTURE_TOL,
                      "contact": CONTACT_TOL}[case])
    jm = runs["jms"][case]
    if case != "generic":
        assert int(got.element_flag.sum()) < jm.n_element   # erosion fired
    if case == "contact":
        assert runs["res"][case]["contact_max"][-1] > 0
        assert hm.cn_inv is not None


def test_fast_path_matches_single_device(runs):
    """The packed loop on the windows of the renumbered 8x8x64 bar against
    the port's single-device packed run_chunk (which earlier tests hold
    against JAX), at test_halo_fast_path_matches_single_device's
    tolerances."""
    r, m = runs["res"]["fast"], runs["fast"]
    part = r["partition"]
    assert part["packed"] and part["El"] % 2048 == 0 and part["W"] % 2048 == 0
    ref = run_chunk(m, init_state(m), 60)
    _close(r["state"], ref, FAST_TOL)
    assert float(ref.stress.abs().max()) > 0
    assert r["busy_us"] == 0 and len(r["host_top"]) == 6


def test_resume_roundtrip(runs):
    """gather_state then partition_state between chunks continues exactly:
    60 + 30 steps equal 90 straight steps, bit for bit.  The work pair is
    the exception, as in the JAX package: the resume parks the whole pair
    on shard 0, so the later partial sums add in another order; it agrees
    within 1e-12 of the kinetic energy (this bar translates nearly rigidly,
    its internal work is roundoff)."""
    a, b = runs["res"]["roundtrip"]["state"], runs["res"]["straight"]["state"]
    ke = 0.5 * (runs["ports"]["generic"].diag_M * (b.velo ** 2).sum(0)).sum()
    assert int(a.t) == int(b.t) == 90
    for f in dataclasses.fields(a):
        if f.name != "work":
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                f.name
    assert (a.work - b.work).abs().max() <= 1e-12 * ke


@pytest.mark.parametrize("deck", ["bar", "renumbered", "impact"])
def test_partition_matches_jax(deck):
    """partition() equals the JAX package's field by field (geometry, the
    compact contact sets and, on the renumbered bar, the fast path's El and
    H rounding), from each package's own lowering of the same deck."""
    if deck == "bar":
        jm = jax_lower(_bar(), JConfig(**CFG))
        tm = carried(jm, jax_init_state(jm))[0]
    elif deck == "renumbered":
        cfg = dict(node_pad=64, renumber="always")
        jm = jax_lower(_renumbered_bar(jsyn), JConfig(**cfg))
        tm = lower(_renumbered_bar(tsyn), SolverConfig(**cfg), device="cpu")
    else:
        cfg = dict(node_pad=8, elem_pad=8, renumber="always")
        jm = jax_lower(_impact(jsyn), JConfig(**cfg))
        tm = lower(_impact(tsyn), SolverConfig(**cfg), device="cpu")
    jh, th = jhalo.partition(jm, SHARDS), thalo.partition(tm, SHARDS)
    assert (th.No, th.H, th.El) == (jh.No, jh.H, jh.El)
    assert (th.coord_e is not None) == (jh.h_plan_pos is not None) \
        == (deck == "renumbered")
    assert (th.cn_inv is not None) == (deck == "impact")
    for name in PART_FIELDS:
        a, b = getattr(th, name), getattr(jh, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    # the window table holds every real element's 8 corners once
    assert int(th.inc_mask.sum()) == 8 * int(th.elem_alive0.sum())


def test_checkpoints_cross_load(runs, tmp_path):
    """A shard-major checkpoint written by either package loads in the
    other: JAX's 60-step halo state read by the port equals JAX's arrays
    bit for bit; the port's, read by JAX and gathered there, equals the
    port's gathered state; a partition of another geometry is refused."""
    jhm, js, _ = runs["jax"]["generic"]
    tm = runs["ports"]["generic"]
    thm = thalo.partition(tm, SHARDS)
    pj = str(tmp_path / "jax.npz")
    jhalo.save_halo_checkpoint(pj, jhm, js)
    assert thalo.is_halo_checkpoint(pj)
    loaded = thalo.load_halo_checkpoint(pj, thm)
    for f in dataclasses.fields(loaded):
        np.testing.assert_array_equal(getattr(loaded, f.name).numpy(),
                                      np.asarray(getattr(js, f.name)),
                                      err_msg=f.name)
    port = runs["res"]["generic"]["state"]
    pp = str(tmp_path / "port.npz")
    thalo.save_halo_checkpoint(pp, thm, thalo.partition_state(thm, port))
    assert jhalo.is_halo_checkpoint(pp)
    back = jhalo.gather_state(jhm, jhalo.load_halo_checkpoint(pp, jhm))
    for name in ("t", "disp", "velo", "Q", "stress", "eq_ps", "element_flag",
                 "work"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(port, name).numpy(),
                                      err_msg=name)
    with pytest.raises(ValueError, match="partition"):
        thalo.load_halo_checkpoint(pj, thalo.partition(tm, 4))


def test_halo_step_metrics_match_jax(runs, tmp_path):
    """halo_step_metrics of JAX's 60-step halo state, carried across as
    shard-major arrays, equals JAX's halo_step_metrics; its energy balance
    equals JAX's step_metrics of the gathered state.  (JAX's
    halo_step_metrics cannot form the balance on shard-major arrays: its
    elastic energy broadcasts (S, El) constants against (S, 8, El) stress
    and raises, so it is called with the energy check off.)"""
    jhm, js, jg = runs["jax"]["generic"]
    thm = thalo.partition(runs["ports"]["generic"], SHARDS)
    path = str(tmp_path / "h.npz")
    jhalo.save_halo_checkpoint(path, jhm, js)
    got = halo_step_metrics(thm, thalo.load_halo_checkpoint(path, thm))
    cfg = dataclasses.replace(jhm.base.config, energy_check=False)
    ref = dict(jax_halo_metrics(dataclasses.replace(
        jhm, base=dataclasses.replace(jhm.base, config=cfg)), js))
    energy = jax_step_metrics(runs["jms"]["generic"], jg)
    ref.update({k: v for k, v in energy.items() if k not in ref})
    assert sorted(got) == sorted(ref) and "energy_rel_error" in got
    # the balance residual cancels the energies: held to 1e-12 of their
    # scale (the shards' partial sums add in another order)
    scale = max(abs(float(ref[k])) for k in (
        "kinetic_energy", "work_external", "work_internal",
        "elastic_energy", "plastic_dissipation"))
    atol = {"balance_residual": 1e-12 * scale, "energy_rel_error": 1e-12}
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-12,
                                   atol=atol.get(k, 1e-300), err_msg=k)


def test_partition_refuses_indivisible_nodes():
    tm = lower(tsyn.bar_model(2, 2, 4), SolverConfig(), device="cpu")
    with pytest.raises(ValueError, match="not divisible by 7"):
        thalo.partition(tm, 7)


_FLOAT = re.compile(r"-?\d+\.\d+e[+-]\d+")


def _frames_close(dir_a, dir_b, rel):
    """test_run_halo_vtk's rule: the same frame files; lines equal or their
    floats within ``rel`` relative and ``rel`` of the frame's scale."""
    names = sorted(p for p in os.listdir(dir_a) if p.endswith(".vtk"))
    assert names == sorted(p for p in os.listdir(dir_b)
                           if p.endswith(".vtk")) and len(names) >= 2
    for name in names:
        ta = open(os.path.join(dir_a, name)).read()
        tb = open(os.path.join(dir_b, name)).read()
        scale = max(abs(float(x)) for x in _FLOAT.findall(ta))
        la, lb = ta.splitlines(), tb.splitlines()
        assert len(la) == len(lb), name
        for a, b in zip(la, lb):
            if a == b:
                continue
            fa, fb = _FLOAT.findall(a), _FLOAT.findall(b)
            assert fa and len(fa) == len(fb), (name, a, b)
            np.testing.assert_allclose(
                np.array(fa, float), np.array(fb, float), rtol=rel,
                atol=rel * scale, err_msg=f"{name}: {a} vs {b}")


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """run() of the 8x8x64 bar (200 steps, 2 frames) on one device and on
    two halo ranks with a shard-major checkpoint at each frame and the
    metrics stream, and the halo run resumed from its first checkpoint."""
    d = tmp_path_factory.mktemp("halo_run")

    def model(name, **kw):
        m = lower(tsyn.bar_model(nx=8, ny=8, nz=64, d_time=1e-8,
                                 end_time=2e-5),
                  SolverConfig(out_dir=str(d / name), node_pad=64,
                               output_num=2, **kw), device="cpu")
        # the first 200 of test_run_halo_vtk's 2,000 steps (the amplitude
        # ramp of the whole run kept)
        return dataclasses.replace(m, time_num=200, end_time=200 * m.dt)
    one = run(model("one"), verbose=False, device="cpu")
    kw = dict(checkpoint_every=1, energy_check=True, energy_abort_rel=0.1,
              metrics_path=str(d / "metrics.jsonl"))
    halo = run(model("halo", **kw), verbose=False, halo=2, device="cpu")
    resumed = run(model("resumed", energy_check=True, energy_abort_rel=0.1),
                  verbose=False, halo=2, device="cpu",
                  resume_halo=str(d / "halo" / "ckpt_001.npz"))
    return d, one, halo, resumed


def test_run_halo_frames(run_dirs):
    """run(halo=2) frames match the single-device run's at
    test_run_halo_vtk's tolerance, its final state within
    test_halo_fast_path_matches_single_device's, and the metrics stream
    has a record per chunk with the halo metrics' keys."""
    d, one, halo, _ = run_dirs
    _frames_close(d / "one", d / "halo", 1e-6)
    assert int(halo.t) == int(one.t) == 200
    _close(halo, one, FAST_TOL)
    recs = (d / "metrics.jsonl").read_text().splitlines()
    assert len(recs) == 2 and '"energy_rel_error"' in recs[-1]
    assert thalo.is_halo_checkpoint(str(d / "halo" / "ckpt_002.npz"))


def test_run_halo_resume_from_checkpoint(run_dirs):
    """run(halo=2, resume_halo=ckpt) continues from the shard-major file
    written at step 100 to the straight halo run's final state, bit for bit,
    and writes frame 0 from the resumed state and the frames after it."""
    d, _, halo, resumed = run_dirs
    for f in dataclasses.fields(halo):
        assert torch.equal(getattr(halo, f.name), getattr(resumed, f.name)), \
            f.name
    assert sorted(os.listdir(d / "resumed")) == ["collection.pvd",
                                                 "file000.vtk", "file002.vtk"]
