"""ShellToSolid — extrude S4 shell meshes into C3D8 solids (offline tool),
the port's own copy of ``hakai_tpu/pre/shell_to_solid.py`` (NumPy only,
held against it by ``tests/test_torch_pre.py``).

Re-implementation of ``HAKAI-v0.0.1/Matlab/ShellToSolid.m``: per-element
quad normals (v1 x v4) are accumulated at nodes (:42-62), each shell node is
offset +-thickness/2 along its averaged (normalized) node normal producing a
hex per quad (:84-107), and duplicate nodes are welded (:118-151).  The
Matlab figure/quiver plotting is replaced by the optional wireframe export
in :mod:`hakai_tpu_torch.pre.viewer`.
"""
from __future__ import annotations

import numpy as np

from .gilgamsh import _weld, write_mesh_fragment


def shell_to_solid(coordmat: np.ndarray, elementmat: np.ndarray,
                   thickness: float):
    """``coordmat`` (3,n), ``elementmat`` (4,E) 1-based S4 quads.
    Returns (coordmat (3,m), elementmat (8,E) 1-based hexes)."""
    cm = np.asarray(coordmat).T          # (n,3)
    em = np.asarray(elementmat).T - 1    # (E,4)
    n_node = cm.shape[0]
    E = em.shape[0]

    v1 = cm[em[:, 1]] - cm[em[:, 0]]
    v4 = cm[em[:, 3]] - cm[em[:, 0]]
    n = np.cross(v1, v4)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)

    node_normal = np.zeros((n_node, 3))
    for k in range(4):
        np.add.at(node_normal, em[:, k], n)
    node_normal /= np.maximum(
        np.linalg.norm(node_normal, axis=1, keepdims=True), 1e-300)

    off = 0.5 * thickness * node_normal
    lower = cm[em] - off[em]            # (E,4,3)
    upper = cm[em] + off[em]
    cd_temp = np.concatenate([lower, upper], axis=1).reshape(E * 8, 3)
    el_temp = (np.arange(8)[None, :] + np.arange(E)[:, None] * 8)

    uniq, remap = _weld(cd_temp)
    elem_new = remap[el_temp] + 1
    return np.ascontiguousarray(uniq.T), np.ascontiguousarray(elem_new.T)


def write_shellsolid_fragment(fname: str, coordmat, elementmat) -> str:
    """Write ``shellsolid_temp.txt``-style fragment (ShellToSolid.m:160-176)."""
    return write_mesh_fragment(fname, coordmat, elementmat, "C3D8R")
