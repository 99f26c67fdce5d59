"""The port's own copies of the JAX package's NumPy-only modules
(config, io.model, io.inp, io.native, pre.synthetic, ops.shape,
core.renumber) against the originals: equal models, tables, permutations,
parsed decks, numbers and defaults."""
import dataclasses
import os
import sys

import numpy as np
import pytest

from hakai_tpu import config as jconfig
from hakai_tpu.core import renumber as jrenumber
from hakai_tpu.io import inp as jinp
from hakai_tpu.io import native as jnative
from hakai_tpu.ops import shape as jshape
from hakai_tpu.pre import synthetic as jsyn
from hakai_tpu_torch import config as tconfig
from hakai_tpu_torch.core import renumber as trenumber
from hakai_tpu_torch.io import inp as tinp
from hakai_tpu_torch.io import model as tmodel
from hakai_tpu_torch.io import native as tnative
from hakai_tpu_torch.ops import shape as tshape
from hakai_tpu_torch.pre import synthetic as tsyn

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from inp_deck import cp_deck_lines, deck_text  # noqa: E402


def assert_same(a, b, path="model"):
    """Recursive equality of model objects: dataclasses field by field (the
    class names must agree), sequences item by item, arrays bitwise with
    their dtype, everything else by ==."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, type(a)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        assert a == b, path


def _scrambled_bar(s):
    """A ductile bar whose nodes are numbered in a seeded random order, so
    the renumbering has work to do (a structured deck keeps its order)."""
    m = s.bar_model(6, 6, 24, ductile=True)
    perm = np.random.default_rng(7).permutation(m.n_node)   # old -> new
    coord = np.empty_like(m.coordmat)
    coord[:, perm] = m.coordmat
    elem = perm[m.elementmat - 1] + 1
    part = m.parts[0]
    part.coordmat, part.elementmat = coord, elem
    m.coordmat, m.elementmat = coord.copy(), elem.copy()
    for bc in m.bcs:
        bc.dof = [perm[(d - 1) // 3] * 3 + (d - 1) % 3 + 1 for d in bc.dof]
    return m


BUILDERS = {
    "bar": lambda s: s.bar_model(4, 4, 16),
    "bar_scrambled": _scrambled_bar,
    "bar_ductile": lambda s: s.bar_model(8, 8, 32, d_time=5e-8,
                                         end_time=1e-4, ductile=True),
    "impact": lambda s: s.impact_model(n=3),
    "self_contact": lambda s: s.self_contact_model(n=3),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_synthetic_models_equal(name):
    ref, got = BUILDERS[name](jsyn), BUILDERS[name](tsyn)
    assert isinstance(got, tmodel.Model)
    assert_same(ref, got)


def test_pusai_bitwise():
    a, b = jshape.pusai_hexa(8), tshape.pusai_hexa(8)
    assert a.dtype == b.dtype and a.shape == b.shape == (8, 3, 8)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["bar_scrambled", "impact"])
def test_renumber_equal(name):
    m_ref, n_ref, e_ref = jrenumber.renumber_model(BUILDERS[name](jsyn))
    m_got, n_got, e_got = trenumber.renumber_model(BUILDERS[name](tsyn))
    np.testing.assert_array_equal(n_got, n_ref)
    np.testing.assert_array_equal(e_got, e_ref)
    assert_same(m_ref, m_got)
    if name == "bar_scrambled":                          # renumbered
        assert not np.array_equal(n_ref, np.arange(len(n_ref)))


def test_solver_config_fields_equal():
    ref, got = jconfig.SolverConfig(), tconfig.SolverConfig()
    assert ([f.name for f in dataclasses.fields(ref)]
            == [f.name for f in dataclasses.fields(got)])
    assert dataclasses.asdict(ref) == dataclasses.asdict(got)
    assert (dataclasses.asdict(jconfig.ContactConfig())
            == dataclasses.asdict(tconfig.ContactConfig()))


def _fragment_deck(tmp_path):
    """The ``write_mesh_fragment`` text of tests/test_pre.py (a refined
    unit cube, ``%.6e`` coordinates) wrapped in a part."""
    from hakai_tpu.pre.gilgamsh import refine_hex, write_mesh_fragment
    from test_element import unit_cube_model
    m = unit_cube_model()
    cm, em = refine_hex(m.coordmat, m.elementmat)
    f = write_mesh_fragment(str(tmp_path / "mesh_temp.txt"), cm, em)
    return (["*Part, name=refined"] + open(f).read().splitlines()
            + ["*Solid Section, elset=all, material=m", "*End Part"])


@pytest.mark.parametrize("name", sorted(BUILDERS) + ["contact_pair",
                                                     "fragment"])
def test_parse_inp_lines_equal(name, tmp_path):
    """Both readers build equal models from the same deck lines: every
    synthetic model written by scripts/inp_deck.py, the ``*Contact Pair``
    deck and the mesh fragment of tests/test_pre.py."""
    if name == "contact_pair":
        lines = cp_deck_lines()
    elif name == "fragment":
        lines = _fragment_deck(tmp_path)
    else:
        lines = deck_text(BUILDERS[name](tsyn)).splitlines()
    ref, got = jinp.parse_inp_lines(lines), tinp.parse_inp_lines(lines)
    assert isinstance(got, tmodel.Model)
    assert_same(ref, got)
    if name == "fragment":
        assert got.parts[0].n_node == 27 and got.parts[0].n_element == 8


def test_read_inp_file_equal(tmp_path):
    path = tmp_path / "bar.inp"
    path.write_text(deck_text(tsyn.bar_model(4, 4, 16, ductile=True)))
    assert_same(jinp.read_inp_file(str(path)), tinp.read_inp_file(str(path)))


def test_parse_numbers_equal():
    """Equal float64 arrays for the same text: integers, signs, leading
    and trailing dots, exponents, repr-printed floats, ``%.6e`` values and
    the separators of node and element lines."""
    rng = np.random.default_rng(17)
    vals = rng.normal(scale=1e3, size=64)
    text = "\n".join([
        "1, 2.5, -3., .5, +4e-3, 1E+10, -7.25e-08",
        ", ".join(repr(float(v)) for v in vals),
        ",   ".join(f"{v:.6e}" for v in vals[:8]),
        " 12, 1, 2, 3, 4, 5, 6, 7, 8"])
    ref = jnative.parse_numbers(text)
    got = tnative.parse_numbers(text, expect=len(ref))
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    assert len(got) == 7 + 64 + 8 + 9
