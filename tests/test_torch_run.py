"""The port's host loop run() against the JAX package's run() on the CPU:
the ductile 4x4x16 bar in float64 with fracture, 10 VTK frames, the energy
balance, the metrics stream and checkpoints every 5 frames."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig
from hakai_tpu.io import vtk as jvtk
from hakai_tpu.pre.synthetic import bar_model
from hakai_tpu.solver.explicit import run as jax_run
from hakai_tpu.solver.output import NodeData as JNodeData
from hakai_tpu_torch import init_state, lower, run
from hakai_tpu_torch.io import vtk as tvtk
from hakai_tpu_torch.solver.output import NodeData
from hakai_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_slice import STATE, _compare, jax_fast_model, port_fast_model

BAR = dict(nx=4, ny=4, nz=16, d_time=5e-8, end_time=1e-4, ductile=True)


def _cfg(out_dir, **kw):
    return SolverConfig(dtype="float64", output_num=10, energy_check=True,
                        metrics_path=f"{out_dir}/metrics.jsonl",
                        checkpoint_every=5, out_dir=str(out_dir), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX run and one port run of the same deck, both on their packed
    chunk loops (see jax_fast_model), each in a directory of its own."""
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("port")
    bar = bar_model(**BAR)
    jm = jax_fast_model(bar, _cfg(jdir))
    js = jax_run(jm, verbose=False)
    tm = port_fast_model(bar, _cfg(tdir))
    ts = run(tm, verbose=False, device="cpu")
    return dict(jdir=jdir, tdir=tdir, jm=jm, js=js, tm=tm, ts=ts)


def _sections(text):
    """A legacy VTK file as [(header line, [data lines])]."""
    out, lines = [], text.splitlines()
    out.append(("\n".join(lines[:4]), []))
    for line in lines[4:]:
        if line[:1].isalpha():
            out.append((line, []))
        else:
            out[-1][1].append(line)
    return out


def test_frames_match_jax(runs):
    """Same frame files and a byte-identical collection.pvd.  In every
    frame: byte-identical header and section lines (POINTS, CELLS and
    CELL_TYPES counts, field names), connectivity and cell types (deleted
    elements left out identically), and every float field within 1e-6 of
    its largest magnitude, one unit in the last printed digit.  Measured:
    the largest difference is 1e-11 of a field's scale, and 91% of all
    lines are byte-identical; the others hold values that are roundoff
    next to their field (the symmetric bar's lateral displacement, shear
    components), whose printed digits are noise in both runs."""
    jdir, tdir = runs["jdir"], runs["tdir"]
    names = sorted(p.name for p in jdir.glob("file*.vtk"))
    assert names == sorted(p.name for p in tdir.glob("file*.vtk"))
    assert len(names) == 11
    assert ((jdir / "collection.pvd").read_bytes()
            == (tdir / "collection.pvd").read_bytes())
    same = total = 0
    cells = []
    for name in names:
        ref = _sections((jdir / name).read_text())
        got = _sections((tdir / name).read_text())
        assert [h for h, _ in got] == [h for h, _ in ref], name
        for (head, a), (_, b) in zip(ref, got):
            assert len(a) == len(b), (name, head)
            same += sum(x == y for x, y in zip(a, b))
            total += len(a)
            if head.startswith(("CELLS", "CELL_TYPES")):
                assert a == b, (name, head)
                continue
            if a:
                fa = np.array([x.split() for x in a], np.float64)
                fb = np.array([x.split() for x in b], np.float64)
                scale = max(np.abs(fa).max(), 1e-300)
                assert np.abs(fa - fb).max() <= 1e-6 * scale, (name, head)
        cells.append(int(ref[2][0].split()[1]))
    assert cells[0] == 256 and cells[-1] < 256         # deletions show
    assert same / total > 0.85, same / total


def test_metrics_match_jax(runs):
    """Same records and keys; every value within 1e-9 relative, the
    balance residual and its relative error against the run's energy scale
    (they are roundoff themselves).  Wall-clock seconds are not compared."""
    rows = [[json.loads(x) for x in (runs[d] / "metrics.jsonl").open()]
            for d in ("jdir", "tdir")]
    assert len(rows[0]) == len(rows[1]) == 10
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
    assert rows[1][-1]["alive_elements"] < 256


def test_checkpoint_resume_bitwise(runs):
    """The port's checkpoint of frame 5, resumed, ends in the state of the
    uninterrupted run, bitwise."""
    tm, full = runs["tm"], runs["ts"]
    s5 = load_checkpoint(str(runs["tdir"] / "ckpt_005.npz"), init_state(tm))
    assert 0 < int(s5.t) < tm.time_num
    out = run(tm, s5, verbose=False, write_output=False, device="cpu")
    for f in dataclasses.fields(out):
        assert torch.equal(getattr(out, f.name), getattr(full, f.name)), \
            f.name


def test_jax_checkpoint_resumes_in_port(runs):
    """The JAX run's checkpoint of frame 5 has the port's field names,
    shapes and dtypes, and resumed in the port it ends within the float64
    bound (1e-10 of each field's scale) of the JAX run, with equal flags."""
    tm = runs["tm"]
    jz = np.load(runs["jdir"] / "ckpt_005.npz")
    tz = np.load(runs["tdir"] / "ckpt_005.npz")
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        assert jz[k].shape == tz[k].shape and jz[k].dtype == tz[k].dtype, k
    s5 = load_checkpoint(str(runs["jdir"] / "ckpt_005.npz"), init_state(tm))
    out = run(tm, s5, verbose=False, write_output=False, device="cpu")
    np.testing.assert_array_equal(out.element_flag.numpy(),
                                  np.asarray(runs["js"].element_flag))
    _compare(runs["js"], out, {"*": 1e-10})
    assert set(STATE) <= set(jz.files)


def test_write_vtk_bytes_equal(tmp_path):
    """For the same arrays the two writers write the same bytes: padded
    arrays, a deleted element, values below the 1e-16 flush, negative
    zeros, float32 and float64 fields."""
    rng = np.random.default_rng(31)
    n_node, n_elem, N, E = 50, 12, 56, 16
    coord = rng.normal(size=(3, N))
    elem = rng.integers(0, n_node, (8, E)).astype(np.int32)
    flag = np.ones(E, bool)
    flag[[2, 5]] = False
    disp = rng.normal(scale=1e-3, size=(3, N))
    disp[0, :5] = [1e-17, -1e-17, -0.0, 0.0, 1e-16]
    velo = rng.normal(size=(3, N))
    fields = [rng.normal(scale=100.0, size=(6, N)).astype(np.float32),
              rng.normal(scale=1e-3, size=(6, N)).astype(np.float32),
              rng.uniform(size=N), rng.uniform(size=N).astype(np.float32),
              rng.normal(size=N)]
    args = (coord, elem, flag, disp, velo)
    a = jvtk.write_vtk(3, str(tmp_path / "j"), *args, JNodeData(*fields),
                       n_node, n_elem)
    b = tvtk.write_vtk(3, str(tmp_path / "t"), *args, NodeData(*fields),
                       n_node, n_elem)
    assert open(a, "rb").read() == open(b, "rb").read()
    frames = [(0, 0.0), (1, 1.25e-5), (2, 2.5e-5)]
    assert (open(jvtk.write_pvd(str(tmp_path / "j"), frames), "rb").read()
            == open(tvtk.write_pvd(str(tmp_path / "t"), frames), "rb").read())


def test_energy_guard_aborts_like_jax(tmp_path):
    """With an abort threshold below roundoff both runs stop after the
    first chunk with the same message."""
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=1e-5, ductile=True)
    msgs = []
    for pkg in ("jax", "port"):
        cfg = SolverConfig(dtype="float32", output_num=4, energy_check=True,
                           energy_abort_rel=1e-30,
                           out_dir=str(tmp_path / pkg))
        with pytest.raises(FloatingPointError) as err:
            if pkg == "jax":
                jax_run(jax_fast_model(bar, cfg), verbose=False)
            else:
                run(port_fast_model(bar, cfg), verbose=False, device="cpu")
        msgs.append(str(err.value))
    assert msgs[0].split(":")[0] == msgs[1].split(":")[0]
    assert msgs[1].endswith("re-run with --precision f64 or mixed")
