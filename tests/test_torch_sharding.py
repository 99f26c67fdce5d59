"""Element-sharded runs of the port (``hakai_tpu_torch.parallel``) on the
CPU: two ranks under gloo, spawned once per group of checks.  Against the
JAX package's ``make_sharded_step`` on a 2-device mesh at
tests/test_sharding.py's tolerances (the generic step of a plastic mesh,
the packed loop of a 16^3 bar), against the port's own single-device run
bit for bit, on a contact deck with erosion, and through
``run(devices=2)`` with frames and checkpoints."""
import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig as JConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.parallel.sharding import (make_mesh, make_sharded_step,
                                         shard_arrays)
from hakai_tpu.pre.synthetic import bar_model as jax_bar_model
from hakai_tpu_torch import SolverConfig, init_state, lower, run, run_chunk
from hakai_tpu_torch.core.state import SimState
from hakai_tpu_torch.ops.contact import deal_block_pairs
from hakai_tpu_torch.parallel import dist as tdist
from hakai_tpu_torch.parallel.sharding import chunk_rank, shard_model
from hakai_tpu_torch.pre import synthetic as tsyn
from hakai_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_slice import carried

FIELDS = [f.name for f in dataclasses.fields(SimState)]
# tests/test_sharding.py's tolerances: (rtol, atol) per field
PLASTIC_TOL = {"disp": (1e-12, 1e-15), "stress": (1e-10, 1e-12),
               "eq_ps": (1e-10, 1e-15)}
PACKED_TOL = {"disp": (1e-13, 1e-20), "Q": (1e-13, 1e-16),
              "stress": (1e-13, 1e-16)}


def _plastic_mesh():
    """A pulled plastic bar of 256 elements (below 2,048: the generic step
    in both packages), a fifth of its Gauss points yielding by step 50."""
    return jax_lower(jax_bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4),
                     JConfig(elem_pad=8)), 50


def _packed_bar():
    """tests/test_sharding.py's 16^3 bar (window plans, coord_e: the packed
    loop in both packages)."""
    jm = jax_lower(jax_bar_model(nx=16, ny=16, nz=16, d_time=1e-8,
                                 end_time=1.0), JConfig(elem_pad=8))
    assert jm.coord_e is not None
    return jm, 30


@pytest.fixture(scope="module")
def jax_runs():
    """(JAX model, steps, JAX sharded result, port model, port sharded
    result) of the two meshes; the port's two ranks run both in one
    spawn."""
    cases = {"plastic": _plastic_mesh(), "packed": _packed_bar()}
    ports = {k: carried(jm, jax_init_state(jm)) for k, (jm, _) in
             cases.items()}
    res = tdist.launch(chunk_rank, 2, "cpu", "gloo", [
        dict(model=ports[k][0], state=ports[k][1], chunks=[n], trace=2)
        for k, (_, n) in cases.items()])
    mesh = make_mesh(2)
    out = {}
    for (k, (jm, n)), r in zip(cases.items(), res):
        ms, ss = shard_arrays(jm, jax_init_state(jm), mesh)
        js = make_sharded_step(ms, mesh, n_steps=n)(ss)
        out[k] = (jm, n, js, ports[k], r)
    return out


@pytest.mark.parametrize("case", ["plastic", "packed"])
def test_matches_jax_sharded_step(jax_runs, case):
    """The port's two ranks against JAX's 2-device mesh, with
    tests/test_sharding.py's (rtol, atol) taken normwise (rtol of the
    field's largest magnitude): the port's element math rounds in another
    order than XLA's, so a node whose force cancels to ~1e-16 keeps no
    relative digits in common (3 of 18,432 Q entries of the 16^3 bar)."""
    jm, n, js, (tm, _), r = jax_runs[case]
    assert (tm.coord_e is None) == (case == "plastic")
    ts = r["state"]
    assert int(ts.t) == n
    tol = PLASTIC_TOL if case == "plastic" else PACKED_TOL
    for name, (rtol, atol) in tol.items():
        ref = np.asarray(getattr(js, name))
        err = np.abs(getattr(ts, name).numpy() - ref).max()
        assert err <= rtol * np.abs(ref).max() + atol, (name, err)
    if case == "plastic":
        assert float(ts.eq_ps.max()) > 0          # the plastic branch ran


@pytest.mark.parametrize("case", ["plastic", "packed"])
def test_bitwise_equal_to_single_device(jax_runs, case):
    """Every field of the two-rank run equals the port's single-device
    run: elements are independent, the assembly sums the gathered qe in
    the single-device order, and the node update is replicated."""
    _, n, _, (tm, ts0), r = jax_runs[case]
    ref = run_chunk(tm, ts0, n)
    for name in FIELDS:
        assert torch.equal(getattr(r["state"], name), getattr(ref, name)), \
            name


@pytest.mark.parametrize("case", ["plastic", "packed"])
def test_traced_steps_report(jax_runs, case):
    """A job's ``trace`` steps run after its chunks under torch.profiler on
    rank 0: no device kernels on the CPU, and the six host ops of the most
    self time, most first; the state reported is the chunks' own."""
    _, n, _, _, r = jax_runs[case]
    assert r["busy_us"] == 0 and r["kernels"] == 0
    top = r["host_top"]
    assert len(top) == 6 and all(name.startswith("aten::") or "::" in name
                                 for name, _ in top), top
    per_step = [us for _, us in top]
    assert per_step == sorted(per_step, reverse=True) and per_step[-1] > 0
    assert int(r["state"].t) == n


def test_shard_model_slices_elements():
    tm = lower(tsyn.bar_model(2, 2, 4), SolverConfig(), device="cpu")
    lm = shard_model(tm, 1, 2)
    assert lm.E == tm.E // 2 and lm.N == tm.N
    assert torch.equal(lm.elem, tm.elem[:, tm.E // 2:])
    assert torch.equal(lm.inc_idx, tm.inc_idx)
    with pytest.raises(ValueError, match="divisible"):
        shard_model(tm, 0, 3)


def _impact(dtype):
    m = tsyn.offset_instance(tsyn.impact_model(n=4, v0=2e5, d_time=1e-8,
                                               end_time=1e-6), 1, 0.013,
                             0.017)
    return lower(m, SolverConfig(dtype=dtype, elem_pad=8), device="cpu")


@pytest.fixture(scope="module")
def contact_runs():
    models = {k: _impact(k) for k in ("float64", "mixed")}
    res = tdist.launch(chunk_rank, 2, "cpu", None, [
        dict(model=m, chunks=[50, 50]) for m in models.values()])
    return {k: (m, r) for (k, m), r in zip(models.items(), res)}


@pytest.mark.parametrize("dtype", ["float64", "mixed"])
def test_contact_with_erosion(contact_runs, dtype):
    """The offset impact, 100 steps with erosion: the deletion flags equal
    the single-device run's and the contact force agrees within 1e-10 of
    its scale; in fact the whole state is bitwise the single-device one,
    since each node's and each triangle's narrow-phase sum runs whole on
    one rank (deal_block_pairs)."""
    m, r = contact_runs[dtype]
    assert len(m.pairs) == 2 and m.fracture_enabled and m.coord_e is None
    ref = run_chunk(m, init_state(m), 100)
    got = r["state"]
    assert r["alive"][-1] == int(ref.element_flag.sum()) < m.n_element
    assert torch.equal(got.element_flag, ref.element_flag)
    cf = ref.contact_force.abs().max()
    assert cf > 0
    assert (got.contact_force - ref.contact_force).abs().max() <= 1e-10 * cf
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_deal_block_pairs_whole_blocks():
    """Each rank's node-side mask holds whole columns and its triangle-side
    mask whole rows of the surviving block pairs; over the ranks each side
    is a partition of them, and the active blocks are dealt evenly."""
    ok = torch.from_numpy(np.random.default_rng(5).random((13, 7)) < 0.3)
    ok[:, 2] = False
    for world in (1, 2, 3):
        sides = [deal_block_pairs(ok, r, world) for r in range(world)]
        for s in range(2):
            masks = torch.stack([x[s] for x in sides]).int()
            assert torch.equal(masks.sum(0), ok.int())
            per_rank = masks.any(dim=1 + s).sum(dim=1)   # blocks per rank
            assert int(per_rank.max() - per_rank.min()) <= 1
        for r, (ni, nt) in enumerate(sides):
            assert torch.equal(ni, ok & ni.any(dim=0)[None, :])
            assert torch.equal(nt, ok & nt.any(dim=1)[:, None])


def _cfg(out_dir, **kw):
    return SolverConfig(dtype="float64", out_dir=str(out_dir), output_num=4,
                        checkpoint_every=2, **kw)


def _ductile_bar():
    return tsyn.bar_model(4, 4, 16, d_time=5e-8, end_time=4e-5,
                          ductile=True)


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """run() of the ductile 4x4x16 bar (800 steps, first deletions near
    step 130) on one device and on two ranks, 5 frames and 2 checkpoints
    each; the final states."""
    d = tmp_path_factory.mktemp("runs")
    out = {}
    for n in (1, 2):
        m = lower(_ductile_bar(), _cfg(d / f"dev{n}"), device="cpu")
        out[n] = (d / f"dev{n}", run(m, verbose=False, devices=n,
                                     device="cpu"))
    return d, out


def test_run_frames_byte_identical(run_dirs):
    _, out = run_dirs
    names = sorted(os.listdir(out[1][0]))
    assert names == sorted(os.listdir(out[2][0]))
    assert "ckpt_002.npz" in names and "file004.vtk" in names
    for name in names:
        if not name.endswith(".npz"):
            assert filecmp.cmp(out[1][0] / name, out[2][0] / name,
                               shallow=False), name
    assert int(out[2][1].element_flag.sum()) < 256
    for name in FIELDS:
        assert torch.equal(getattr(out[1][1], name),
                           getattr(out[2][1], name)), name


def test_checkpoints_resume_across(run_dirs):
    """Each run's mid-run checkpoint resumes in the other kind of run to
    the same final state, bit for bit."""
    d, out = run_dirs
    for src, n in ((2, 1), (1, 2)):
        m = lower(_ductile_bar(), _cfg(d / f"resume{n}"), device="cpu")
        s = load_checkpoint(str(out[src][0] / "ckpt_002.npz"), init_state(m))
        assert int(s.t) == 400
        final = run(m, s, verbose=False, devices=n, device="cpu")
        for name in FIELDS:
            assert torch.equal(getattr(final, name),
                               getattr(out[1][1], name)), (src, name)


def test_backend_placement_refused(monkeypatch):
    """NCCL runs one rank per card and no CPU tensors: two ranks on one
    card, or NCCL on the CPU, raise before any rank starts."""
    m = lower(_ductile_bar(), SolverConfig(), device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        run(m, devices=2, device="cpu", dist_backend="nccl",
            write_output=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="card per rank"):
        tdist.check_placement(2, "cuda", "nccl")
    tdist.check_placement(2, "cuda", "gloo")


def test_failed_rank_fails_the_run(tmp_path):
    """A deck at 2.4x its CFL limit goes non-finite within 200 steps on
    every rank; with the NaN check on, the ranks raise and so does
    run()."""
    m = lower(tsyn.bar_model(2, 2, 4, d_time=2e-6, end_time=4e-4),
              SolverConfig(check_nan=True, output_num=1,
                           out_dir=str(tmp_path)), device="cpu")
    with pytest.raises(Exception, match="NaN/Inf in displacement"):
        run(m, verbose=False, devices=2, device="cpu", write_output=False)
