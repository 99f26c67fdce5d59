"""The port's offline tools (``hakai_tpu_torch.pre.gilgamsh``,
``pre.shell_to_solid``, ``pre.viewer``, ``utils.plot``): the port-side
counterparts of ``tests/test_pre.py`` and of
``tests/test_aux.py::test_plot_metrics_renders_png``, and each tool against
the JAX package's on seeded jittered meshes and on one metrics stream:
equal arrays, byte-equal fragments, wireframes and figures."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hakai_tpu.pre import gilgamsh as jgil
from hakai_tpu.pre import shell_to_solid as jsts
from hakai_tpu.pre import viewer as jview
from hakai_tpu.pre.synthetic import bar_model as jax_bar_model
from hakai_tpu.utils import plot as jplot
from hakai_tpu_torch import SolverConfig, lower, run
from hakai_tpu_torch.io.inp import parse_inp_lines
from hakai_tpu_torch.pre import gilgamsh as tgil
from hakai_tpu_torch.pre import shell_to_solid as tsts
from hakai_tpu_torch.pre import viewer as tview
from hakai_tpu_torch.pre.gilgamsh import refine_hex, refine_quad, \
    write_mesh_fragment
from hakai_tpu_torch.pre.shell_to_solid import shell_to_solid
from hakai_tpu_torch.pre.synthetic import bar_model
from hakai_tpu_torch.pre.viewer import mesh_edges, write_wireframe_vtk
from hakai_tpu_torch.utils import plot as tplot
from test_element import unit_cube_model

ROOT = Path(__file__).resolve().parent.parent


def _set_mesh(m, cm, em):
    """``m`` with its one part's mesh replaced by (cm, em)."""
    part = m.parts[0]
    part.coordmat, part.elementmat = cm, em
    part.n_node, part.n_element = cm.shape[1], em.shape[1]
    m.coordmat, m.elementmat = cm, em
    m.n_node, m.n_element = cm.shape[1], em.shape[1]
    m.element_material = np.ones(em.shape[1], np.int64)
    m.element_instance = np.ones(em.shape[1], np.int64)
    m.instances[0].n_node = m.n_node
    m.instances[0].n_element = m.n_element
    return m


def test_refine_single_hex():
    m = unit_cube_model()
    cm, em = refine_hex(m.coordmat, m.elementmat)
    assert em.shape == (8, 8)
    assert cm.shape == (3, 27)          # full 27-node template
    # volume preserved: 8 sub-hexes of 0.5^3, lumped mass = density * V
    lm = lower(_set_mesh(m, cm, em), device="cpu")
    total = float(lm.diag_M[lm.node_exists].sum())
    np.testing.assert_allclose(total, 1.0 * 1.0, rtol=1e-12)


def test_refine_2x_shares_nodes():
    m = unit_cube_model(nx=2, ny=1, nz=1, lx=2.0)
    cm, em = refine_hex(m.coordmat, m.elementmat)
    assert em.shape == (8, 16)
    # 27*2 template nodes minus 9 welded on the shared face
    assert cm.shape[1] == 45


def _unit_quad():
    coord = np.array([[0, 1, 1, 0], [0, 0, 1, 1], [0, 0, 0, 0]], float)
    return coord, np.array([[1], [2], [3], [4]])


def test_refine_quad():
    cm, em = refine_quad(*_unit_quad())
    assert em.shape == (4, 4)
    assert cm.shape == (3, 9)


def test_shell_to_solid_flat():
    # flat unit quad, thickness 0.2 -> one hex of volume 0.2
    cm, em = shell_to_solid(*_unit_quad(), 0.2)
    assert em.shape == (8, 1)
    assert cm.shape == (3, 8)
    np.testing.assert_allclose(sorted(set(np.round(cm[2], 12))), [-0.1, 0.1])


def test_mesh_fragment_roundtrip(tmp_path):
    m = unit_cube_model()
    cm, em = refine_hex(m.coordmat, m.elementmat)
    f = write_mesh_fragment(str(tmp_path / "mesh_temp.txt"), cm, em)
    lines = open(f).read().splitlines()
    assert lines[0] == "*Node"
    assert "*Element, type=C3D8R" in lines
    # parseable by the port's .inp front-end when wrapped in a part
    deck = (["*Part, name=refined"] + lines
            + ["*Solid Section, elset=all, material=m", "*End Part"])
    model = parse_inp_lines(deck)
    assert model.parts[0].n_node == 27
    assert model.parts[0].n_element == 8


def test_wireframe(tmp_path):
    m = unit_cube_model()
    edges = mesh_edges(m.elementmat)
    assert edges.shape == (12, 2)
    f = write_wireframe_vtk(str(tmp_path / "wf.vtk"), m.coordmat,
                            m.elementmat)
    assert "LINES 12 36" in open(f).read()


def _jittered_hex():
    """``bar_model(2, 3, 4)`` with every node moved by a seeded tenth of an
    element (the same mesh in both packages)."""
    m = bar_model(2, 3, 4)
    assert np.array_equal(m.coordmat, jax_bar_model(2, 3, 4).coordmat)
    rng = np.random.default_rng(41)
    return m.coordmat + rng.normal(scale=0.25, size=m.coordmat.shape), \
        m.elementmat


def _jittered_quads(nx=4, ny=3):
    """A seeded jittered nx x ny grid of S4 quads, gently curved in z."""
    rng = np.random.default_rng(43)
    xs, ys = np.meshgrid(np.arange(nx + 1.0), np.arange(ny + 1.0),
                         indexing="ij")
    coord = np.stack([xs.ravel(), ys.ravel(),
                      0.1 * (xs.ravel() - nx / 2) ** 2])
    coord = coord + rng.normal(scale=0.1, size=coord.shape)
    nid = lambda i, j: i * (ny + 1) + j + 1                 # noqa: E731
    elem = np.array([[nid(i, j), nid(i + 1, j), nid(i + 1, j + 1),
                      nid(i, j + 1)] for i in range(nx) for j in range(ny)]).T
    return coord, elem


def _equal_arrays(ref, got):
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("tool", ["refine_hex", "refine_quad",
                                  "shell_to_solid", "mesh_edges"])
def test_tools_equal_jax(tool):
    """Each tool gives the JAX package's arrays on a seeded jittered mesh
    (a refined hex bar, a refined and an extruded quad grid, the edges of
    the bar and of its refinement)."""
    if tool == "refine_hex":
        args = _jittered_hex()
        ref, got = jgil.refine_hex(*args), tgil.refine_hex(*args)
        assert got[1].shape == (8, 8 * 24)
    elif tool == "refine_quad":
        args = _jittered_quads()
        ref, got = jgil.refine_quad(*args), tgil.refine_quad(*args)
        assert got[0].shape == (3, 9 * 7)
    elif tool == "shell_to_solid":
        args = _jittered_quads()
        ref = jsts.shell_to_solid(*args, 0.3)
        got = tsts.shell_to_solid(*args, 0.3)
        assert got[0].shape == (3, 2 * 20)
    else:
        cm, em = _jittered_hex()
        ref, got = [], []
        for e in (em, tgil.refine_hex(cm, em)[1]):
            ref.append(jview.mesh_edges(e))
            got.append(tview.mesh_edges(e))
    _equal_arrays(ref, got)


def test_fragments_and_wireframes_byte_equal(tmp_path):
    """The mesh fragment, the shell-solid fragment and the wireframe files
    of the jittered meshes are byte-equal to the JAX package's."""
    cm, em = tgil.refine_hex(*_jittered_hex())
    qc, qe = _jittered_quads()
    sc, se = tsts.shell_to_solid(qc, qe, 0.3)
    for tag, mod in (("j", (jgil, jsts, jview)), ("t", (tgil, tsts, tview))):
        gil, sts, view = mod
        gil.write_mesh_fragment(str(tmp_path / f"{tag}_mesh.txt"), cm, em)
        gil.write_mesh_fragment(str(tmp_path / f"{tag}_quad.txt"), qc, qe,
                                "S4R")
        sts.write_shellsolid_fragment(str(tmp_path / f"{tag}_ss.txt"), sc,
                                      se)
        view.write_wireframe_vtk(str(tmp_path / f"{tag}_wf.vtk"), cm, em)
    for name in ("mesh.txt", "quad.txt", "ss.txt", "wf.vtk"):
        ref = (tmp_path / f"j_{name}").read_bytes()
        assert (tmp_path / f"t_{name}").read_bytes() == ref, name
        assert len(ref) > 500


def test_draw_element_png(tmp_path, monkeypatch):
    """The PNG wireframe renders as JAX's does; without matplotlib it
    raises RuntimeError, as in JAX."""
    pytest.importorskip("matplotlib")
    cm, em = _jittered_hex()
    a = jview.draw_element(cm, em, str(tmp_path / "j.png"))
    b = tview.draw_element(cm, em, str(tmp_path / "t.png"))
    assert Path(b).stat().st_size > 2000
    assert Path(b).read_bytes() == Path(a).read_bytes()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib not available"):
        tview.draw_element(cm, em, str(tmp_path / "x.png"))


@pytest.fixture(scope="module")
def metrics_jsonl(tmp_path_factory):
    """A metrics stream written by the port's run(): the ductile bar on
    the CPU, mixed, with the energy balance (its log-scale panel)."""
    out = tmp_path_factory.mktemp("plot")
    cfg = SolverConfig(dtype="mixed", out_dir=str(out), output_num=5,
                       energy_check=True,
                       metrics_path=str(out / "metrics.jsonl"))
    m = lower(bar_model(2, 2, 4, d_time=5e-8, end_time=1e-6, ductile=True),
              cfg, device="cpu")
    run(m, verbose=False, write_output=False, device="cpu")
    return out / "metrics.jsonl"


def test_plot_metrics_renders_png(metrics_jsonl, tmp_path):
    """utils/plot.py: the drawGraph analogue renders the port's JSONL
    stream, the same figure as the JAX package's plot_metrics, bytes and
    all."""
    pytest.importorskip("matplotlib")
    recs = tplot.load_jsonl(str(metrics_jsonl))
    assert recs == jplot.load_jsonl(str(metrics_jsonl)) and len(recs) == 5
    assert "energy_rel_error" in recs[0]
    out = tplot.plot_metrics(recs, str(tmp_path / "metrics.png"))
    assert (tmp_path / "metrics.png").stat().st_size > 2000
    ref = jplot.plot_metrics(recs, str(tmp_path / "ref.png"))
    assert Path(out).read_bytes() == Path(ref).read_bytes()
    # field subset + explicit failure on unknown fields
    tplot.plot_metrics(recs, str(tmp_path / "m2.png"),
                       fields=["kinetic_energy", "d_max"], x="step")
    jplot.plot_metrics(recs, str(tmp_path / "r2.png"),
                       fields=["kinetic_energy", "d_max"], x="step")
    assert ((tmp_path / "m2.png").read_bytes()
            == (tmp_path / "r2.png").read_bytes())
    with pytest.raises(ValueError):
        tplot.plot_metrics(recs, str(tmp_path / "m3.png"), fields=["nope"])
    with pytest.raises(ValueError, match="no metric records"):
        tplot.plot_metrics([], str(tmp_path / "m4.png"))


def test_plot_module_cli(metrics_jsonl, tmp_path):
    """``python -m hakai_tpu_torch.utils.plot``: renders the stream beside
    it by default and prints the path; ``--help`` names the module."""
    pytest.importorskip("matplotlib")
    out = tmp_path / "cli.png"
    r = subprocess.run(
        [sys.executable, "-m", "hakai_tpu_torch.utils.plot",
         str(metrics_jsonl), "-o", str(out), "--fields",
         "kinetic_energy,energy_rel_error", "--x", "step"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == str(out) and out.stat().st_size > 2000
    h = subprocess.run([sys.executable, "-m", "hakai_tpu_torch.utils.plot",
                        "--help"], capture_output=True, text=True,
                       timeout=120, cwd=ROOT)
    assert h.returncode == 0
    assert h.stdout.startswith("usage: python -m hakai_tpu_torch.utils.plot")
    assert "hakai_tpu_torch metrics" in h.stdout
    assert not os.path.exists(str(metrics_jsonl)[:-6] + ".png")
