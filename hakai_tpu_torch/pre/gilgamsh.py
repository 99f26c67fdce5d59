"""Gilgamsh — uniform mesh refiner (offline preprocessing tool), the
port's own copy of ``hakai_tpu/pre/gilgamsh.py`` (NumPy only; for the same
mesh it gives the same arrays and fragment bytes,
``tests/test_torch_pre.py``).

Re-implementation of ``HAKAI-v0.0.1/Matlab/Gilgamsh.m``: each hex8 (C3D8)
element is subdivided into 8 sub-hexes through a 27-node template
(Gilgamsh.m:66-105); each S4 shell quad into 4 sub-quads via a 9-node
template (:121-138).  Duplicated nodes at shared faces/edges are welded with
tolerance 1e-10 (:148-169).  The result can be written as an Abaqus
``*Node``/``*Element`` fragment (``mesh_temp.txt``, :204-228).

Vectorized NumPy (the Matlab original's O(n^2) scan is a hash-grid weld).
"""
from __future__ import annotations

import numpy as np

# sub-hex connectivity into the 27-node template (Gilgamsh.m:68-76), 0-based
_HEX_SUBS = np.array([
    [1, 9, 13, 12, 14, 18, 22, 21],
    [9, 2, 10, 13, 18, 15, 19, 22],
    [13, 10, 3, 11, 22, 19, 16, 20],
    [12, 13, 11, 4, 21, 22, 20, 17],
    [14, 18, 22, 21, 5, 23, 27, 26],
    [18, 15, 19, 22, 23, 6, 24, 27],
    [22, 19, 16, 20, 27, 24, 7, 25],
    [21, 22, 20, 17, 26, 27, 25, 8],
]) - 1

_QUAD_SUBS = np.array([
    [1, 5, 9, 8],
    [5, 2, 6, 9],
    [9, 6, 3, 7],
    [8, 9, 7, 4],
]) - 1


def _weld(coord: np.ndarray, tol: float = 1e-10):
    """Merge duplicate rows of ``coord`` (n,3); returns (unique (m,3),
    remap (n,) into unique, first-occurrence order)."""
    key = np.round(coord / max(tol, 1e-300)).astype(np.int64)
    _, first, inverse = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    # preserve first-occurrence ordering like the reference scan
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    remap = rank[inverse]
    uniq = coord[np.sort(first)]
    return uniq, remap


def _mid(a, b):
    return (a + b) * 0.5


def refine_hex(coordmat: np.ndarray, elementmat: np.ndarray):
    """C3D8 -> 8 sub-hexes. ``coordmat`` (3,n), ``elementmat`` (8,E) 1-based.
    Returns (new coordmat (3,m), new elementmat (8,8E) 1-based)."""
    cm = np.asarray(coordmat).T          # (n,3)
    em = np.asarray(elementmat).T - 1    # (E,8)
    E = em.shape[0]
    c = cm[em]                           # (E,8,3) corner nodes

    # template nodes 9..27 (Gilgamsh.m:79-99), 0-based locals
    c9 = _mid(c[:, 0], c[:, 1]); c10 = _mid(c[:, 1], c[:, 2])
    c11 = _mid(c[:, 2], c[:, 3]); c12 = _mid(c[:, 0], c[:, 3])
    c13 = _mid(c10, c12)
    c14 = _mid(c[:, 0], c[:, 4]); c15 = _mid(c[:, 1], c[:, 5])
    c16 = _mid(c[:, 2], c[:, 6]); c17 = _mid(c[:, 3], c[:, 7])
    c18 = _mid(c14, c15); c19 = _mid(c15, c16)
    c20 = _mid(c16, c17); c21 = _mid(c14, c17)
    c22 = _mid(c19, c21)
    c23 = _mid(c[:, 4], c[:, 5]); c24 = _mid(c[:, 5], c[:, 6])
    c25 = _mid(c[:, 6], c[:, 7]); c26 = _mid(c[:, 4], c[:, 7])
    c27 = _mid(c24, c26)
    tmpl = np.stack([c[:, 0], c[:, 1], c[:, 2], c[:, 3],
                     c[:, 4], c[:, 5], c[:, 6], c[:, 7],
                     c9, c10, c11, c12, c13, c14, c15, c16, c17, c18,
                     c19, c20, c21, c22, c23, c24, c25, c26, c27],
                    axis=1)              # (E, 27, 3)
    coord_all = tmpl.reshape(E * 27, 3)
    elem_all = (_HEX_SUBS[None] + (np.arange(E)[:, None, None] * 27)
                ).reshape(E * 8, 8)

    uniq, remap = _weld(coord_all)
    elem_new = remap[elem_all] + 1
    return np.ascontiguousarray(uniq.T), np.ascontiguousarray(elem_new.T)


def refine_quad(coordmat: np.ndarray, elementmat: np.ndarray):
    """S4 -> 4 sub-quads (Gilgamsh.m:110-145). Shapes as refine_hex but
    4-node elements."""
    cm = np.asarray(coordmat).T
    em = np.asarray(elementmat).T - 1    # (E,4)
    E = em.shape[0]
    c = cm[em]                           # (E,4,3)
    c5 = _mid(c[:, 0], c[:, 1]); c6 = _mid(c[:, 1], c[:, 2])
    c7 = _mid(c[:, 2], c[:, 3]); c8 = _mid(c[:, 0], c[:, 3])
    c9 = _mid(c6, c8)
    tmpl = np.stack([c[:, 0], c[:, 1], c[:, 2], c[:, 3],
                     c5, c6, c7, c8, c9], axis=1)
    coord_all = tmpl.reshape(E * 9, 3)
    elem_all = (_QUAD_SUBS[None] + (np.arange(E)[:, None, None] * 9)
                ).reshape(E * 4, 4)
    uniq, remap = _weld(coord_all)
    return np.ascontiguousarray(uniq.T), np.ascontiguousarray(
        remap[elem_all].T + 1)


def write_mesh_fragment(fname: str, coordmat: np.ndarray,
                        elementmat: np.ndarray,
                        element_type: str = "C3D8R") -> str:
    """Write the ``*Node``/``*Element`` fragment (Gilgamsh.m:204-228)."""
    cm = np.asarray(coordmat).T
    em = np.asarray(elementmat).T
    with open(fname, "w") as out:
        out.write("*Node\n")
        for i, row in enumerate(cm, 1):
            out.write(f"{i},   {row[0]:.6e},   {row[1]:.6e},   {row[2]:.6e}\n")
        out.write(f"*Element, type={element_type}\n")
        for i, row in enumerate(em, 1):
            out.write(f"{i}, " + ", ".join(str(int(v)) for v in row) + "\n")
    return fname
