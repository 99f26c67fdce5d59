"""Wireframe mesh viewer / exporter, the port's own copy of
``hakai_tpu/pre/viewer.py`` (NumPy, and matplotlib for the PNG; held
against it by ``tests/test_torch_pre.py``).

Replaces the reference's Matlab ``drawElement.m`` (and the commented Julia
stub, HAKAI_j.jl:3488-3513).  Headless-friendly: exports the unique mesh
edges as a legacy-VTK ``POLYDATA`` lines file viewable in ParaView, and can
optionally render a PNG via matplotlib when available.
"""
from __future__ import annotations

import numpy as np

# hex8 edges as local node-slot pairs
_EDGES = np.array([
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
])


def mesh_edges(elementmat: np.ndarray) -> np.ndarray:
    """Unique undirected edges (m,2) 0-based from (8,E) 1-based hexes."""
    em = np.asarray(elementmat).T - 1
    e = em[:, _EDGES]                     # (E, 12, 2)
    e = e.reshape(-1, 2)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def write_wireframe_vtk(fname: str, coordmat: np.ndarray,
                        elementmat: np.ndarray) -> str:
    cm = np.asarray(coordmat).T
    edges = mesh_edges(elementmat)
    with open(fname, "w") as f:
        f.write("# vtk DataFile Version 2.0\nwireframe\nASCII\n"
                "DATASET POLYDATA\n")
        f.write(f"POINTS {len(cm)} float\n")
        for r in cm:
            f.write(f"{r[0]:1.6e} {r[1]:1.6e} {r[2]:1.6e}\n")
        f.write(f"LINES {len(edges)} {len(edges) * 3}\n")
        for a, b in edges:
            f.write(f"2 {a} {b}\n")
    return fname


def draw_element(coordmat, elementmat, fname: str | None = None):
    """Render a PNG wireframe with matplotlib (if installed)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from mpl_toolkits.mplot3d.art3d import Line3DCollection
    except ImportError as e:       # pragma: no cover
        raise RuntimeError("matplotlib not available; use "
                           "write_wireframe_vtk instead") from e
    cm = np.asarray(coordmat).T
    edges = mesh_edges(elementmat)
    segs = cm[edges]
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.add_collection3d(Line3DCollection(segs, colors="k", linewidths=0.5))
    lo, hi = cm.min(0), cm.max(0)
    ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    out = fname or "wireframe.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out
