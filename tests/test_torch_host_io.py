"""The port's host-IO helper (``hakai_tpu_torch/csrc/host_io.cpp``, bound by
``hakai_tpu_torch/io/native.py``) against the JAX package's C++ helper
(``native/hakai_native.cpp``, bound by ``hakai_tpu/io/native.py``): the same
doubles from the same text, the same bytes from the same values, byte-equal
frames, the same ``.inp`` outcome; each plain Python twin equal to its
helper; and a helper that cannot be built raises rather than falling back.
The reference is always the JAX helper, never the JAX package's fallback."""
import os

import numpy as np
import pytest

from hakai_tpu.io import inp as jinp
from hakai_tpu.io import native as jnative
from hakai_tpu.io import vtk as jvtk
from hakai_tpu.solver.output import NodeData as JNodeData
from hakai_tpu_torch import _build
from hakai_tpu_torch.io import inp as tinp
from hakai_tpu_torch.io import native as tnative
from hakai_tpu_torch.io import vtk as tvtk
from hakai_tpu_torch.solver.output import NodeData

# the inputs on which the port's earlier regex parser and Python formatter
# parted from the JAX helper, and strtod's corner cases
CORPUS = ["1.0d3, 2", "1.5D-2", "-inf, 2", "+nan 1", "0x10, 3", "0x1p3",
          "1e, 2", "-.e5", "1e-400", "1e5000", "INF", "+Infinity",
          "-nan(0x1)", "0x", "0X1.8P1", "-0x.8p1", "0x1p99999999999",
          "-0x1p-99999999", "+infinit", "-nan(", "-nan(ab_9)x", "00x10",
          "1.e5", ".5e3-3+4", "0xg", "-0x", "+-1", "--inf", "1e+", "0x1p",
          "0x1.", "0x.p1", "0x1.fffffffffffff8p0", "0x0.0000000000001p-1022",
          "4.9406564584124654e-324", "2.4703282292062327e-324",
          "1.7976931348623157e308", "1.7976931348623159e308", "-0", "",
          " 12, 1, 2, 3, 4, 5, 6, 7, 8\n 13, 1.0, -2.5e-3, .5",
          "nan inf -NaN +INF 1"]
TOKENS = ["0", "1", "9", "12", ".", "-", "+", "e", "E", "d", "D", "p", "P",
          "x", "X", "0x", "0X", "a", "f", "inf", "INF", "infinity", "nan",
          "NaN", "(", ")", "_", ",", " ", "\n", "*", "1e5", "-2.5", ".75",
          "3.0d2", "1E-7", "0x1.8p1"]


@pytest.fixture(scope="module", autouse=True)
def jax_helper():
    """The reference is the JAX package's helper: it must load here."""
    assert jnative.available()


def _fuzz(n=400, seed=11):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(TOKENS, size=rng.integers(1, 40)))
            for _ in range(n)]


def _same(got, ref, what):
    """Equal float64 arrays, NaNs at the same places, equal sign bits (a
    negative zero or NaN stays negative)."""
    assert got.dtype == ref.dtype == np.float64, what
    np.testing.assert_array_equal(got, ref, err_msg=repr(what))
    np.testing.assert_array_equal(np.signbit(got), np.signbit(ref),
                                  err_msg=repr(what))


@pytest.mark.parametrize("corpus", ["cases", "fuzz"])
def test_parse_numbers_equals_jax_helper(corpus):
    """(a) The port's parser reads JAX's helper's doubles, on the corner
    cases and on seeded strings of number fragments and separators."""
    texts = CORPUS if corpus == "cases" else _fuzz()
    for text in texts:
        _same(tnative.parse_numbers(text), jnative.parse_numbers(text), text)
    whole = "\n".join(texts)
    _same(tnative.parse_numbers(whole), jnative.parse_numbers(whole), whole)


def test_parse_numbers_grows_its_buffer():
    """(a) ``expect`` smaller than the count: the buffer grows 4x until
    the numbers fit, as the JAX wrapper's does (from one slot where
    ``expect`` is 0, where the JAX wrapper would grow nothing)."""
    text = ", ".join(str(i) for i in range(1000)) + " 0x10 -inf"
    ref = jnative.parse_numbers(text)
    for expect in (0, 1, 7, 999, 1002, 5000):
        _same(tnative.parse_numbers(text, expect=expect), ref, expect)
    assert len(ref) == 1002


@pytest.mark.parametrize("corpus", ["cases", "fuzz"])
def test_parse_numbers_plain_equals_helper(corpus):
    """(b) The Python twin follows the helper's scan and grammar."""
    for text in (CORPUS if corpus == "cases" else _fuzz(seed=12)):
        _same(tnative.parse_numbers_plain(text), tnative.parse_numbers(text),
              text)


def _values(rng, shape):
    """Finite values of magnitude 1e-320 to 1e300 of both signs, with ±0,
    ±inf and NaNs of both signs among them."""
    mag = 10.0 ** rng.uniform(-320, 300, size=shape)
    a = np.where(rng.random(shape) < 0.5, -mag, mag)
    flat = a.reshape(-1)
    flat[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan]
    assert np.signbit(flat[5]) and np.isnan(flat[5])
    return a


@pytest.mark.parametrize("shape", [(0,), (1,), (257,), (64, 3), (5, 9),
                                   (40, 1)])
def test_format_rows_equal_jax_helper(shape):
    """(c) The formatters write JAX's helper's bytes, 1-D and 2-D, and
    each twin writes its helper's."""
    rng = np.random.default_rng(23)
    a = _values(rng, shape) if np.prod(shape) >= 6 else np.full(shape, -0.0)
    ref = jnative.format_e_rows(a)
    assert tnative.format_e_rows(a) == ref
    assert tnative.format_e_rows_plain(a) == ref
    if np.prod(shape) >= 6:
        assert "-nan" in ref and "-inf" in ref
    i = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64)
    ref = jnative.format_i_rows(i)
    assert tnative.format_i_rows(i) == ref
    assert tnative.format_i_rows_plain(i) == ref


def test_write_vtk_negative_nan_bytes_equal(tmp_path):
    """(d) A frame holding a negative NaN and a deleted element: the two
    writers write the same bytes, ``-nan`` included."""
    rng = np.random.default_rng(29)
    n_node, n_elem, N, E = 40, 10, 48, 16
    coord = rng.normal(size=(3, N))
    elem = rng.integers(0, n_node, (8, E)).astype(np.int32)
    flag = np.ones(E, bool)
    flag[4] = False
    disp = rng.normal(scale=1e-3, size=(3, N))
    disp[1, 3] = -np.nan
    velo = rng.normal(size=(3, N))
    velo[0, 7] = np.inf
    fields = [rng.normal(scale=100.0, size=(6, N)).astype(np.float32),
              rng.normal(scale=1e-3, size=(6, N)), rng.uniform(size=N),
              rng.uniform(size=N), rng.normal(size=N)]
    fields[4][2] = -np.nan
    args = (coord, elem, flag, disp, velo)
    a = jvtk.write_vtk(1, str(tmp_path / "j"), *args, JNodeData(*fields),
                       n_node, n_elem)
    b = tvtk.write_vtk(1, str(tmp_path / "t"), *args, NodeData(*fields),
                       n_node, n_elem)
    ref = open(a, "rb").read()
    assert open(b, "rb").read() == ref
    assert b"\n-nan\n" in ref and f"CELLS {n_elem - 1} ".encode() in ref


def _deck(coord_text):
    return ["*Part, name=p", "*Node",
            "1, 0.0, 0.0, 0.0", "2, " + coord_text + ", 0.0, 0.0",
            "3, 1.0, 1.0, 0.0", "4, 0.0, 1.0, 0.0",
            "5, 0.0, 0.0, 1.0", "6, 1.0, 0.0, 1.0",
            "7, 1.0, 1.0, 1.0", "8, 0.0, 1.0, 1.0",
            "*Element, type=C3D8R", "1, 1, 2, 3, 4, 5, 6, 7, 8",
            "*Solid Section, elset=all, material=m", "*End Part"]


@pytest.mark.parametrize("coord", ["1.0d3", "1.0e3", "0x1p0", "+inf"])
def test_read_inp_file_same_outcome(coord, tmp_path):
    """(e) A deck with a Fortran ``D`` exponent (both helpers split it, so
    the node block no longer reshapes) and with literals only strtod
    reads: the same model, or the same exception type, in both."""
    path = tmp_path / "deck.inp"
    path.write_text("\n".join(_deck(coord)) + "\n")
    outcome = []
    for mod in (jinp, tinp):
        try:
            outcome.append(mod.read_inp_file(str(path)).parts[0].coordmat)
        except Exception as e:                       # noqa: BLE001
            outcome.append(type(e))
    if coord == "1.0d3":
        assert outcome == [ValueError, ValueError]
    else:
        np.testing.assert_array_equal(outcome[1], outcome[0])
        assert outcome[1][0, 1] == {"1.0e3": 1e3, "0x1p0": 1.0,
                                    "+inf": np.inf}[coord]


def test_failed_build_raises(monkeypatch, tmp_path):
    """(f) With a compiler that fails and an empty build directory, the
    helper raises and names the compiler; the parser and the frame writer
    raise with it, and no frame is written."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(_build, "_host_lib", None)
    with pytest.raises(RuntimeError, match=r"host compiler \S*false failed"):
        _build.host_library()
    with pytest.raises(RuntimeError, match="false"):
        tnative.parse_numbers("1, 2")
    n = 4
    with pytest.raises(RuntimeError, match="false"):
        tvtk.write_vtk(0, str(tmp_path / "out"), np.zeros((3, n)),
                       np.zeros((8, 1), np.int32), np.ones(1, bool),
                       np.zeros((3, n)), np.zeros((3, n)),
                       NodeData(np.zeros((6, n)), np.zeros((6, n)),
                                np.zeros(n), np.zeros(n), np.zeros(n)),
                       n, 1)
    assert not (tmp_path / "out" / "file000.vtk").exists()
    assert os.listdir(tmp_path / "host") == []
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        _build.host_library()


def test_helper_builds_from_its_source_alone():
    """The helper is ``csrc/host_io.cpp`` built into ``build/host/`` with
    the JAX Makefile's flags, under a name keyed by source, flags and
    compiler; the CUDA library's sources and key leave it out."""
    _build.host_library()
    path = _build.HOST_INFO["path"]
    assert os.path.dirname(path) == str(_build.HOST_BUILD_DIR)
    name = os.path.basename(path)
    assert name.startswith("libhakai_host_") and name.endswith(".so")
    assert _build.HOST_FLAGS == ("-O3", "-fPIC", "-shared", "-Wall")
    assert _build.HOST_SOURCE.name == "host_io.cpp"
    assert _build.HOST_SOURCE not in _build.sources()
    assert all(p.suffix in (".cu", ".cuh") for p in _build.sources())
