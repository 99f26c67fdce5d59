"""Legacy-VTK ASCII writer (UNSTRUCTURED_GRID), the port's own copy of
``hakai_tpu/io/vtk.py``: for the same arrays it writes the same bytes as
the JAX package with its C++ helper.

Same header, same field names and order (DISPLACEMENT vector; Vx/Vy/Vz,
E11..E13, EQ_PSTRAIN, S11..S13, MISES_STRESS, TRIAX_STRESS scalars),
``%1.6e`` formatting of the values widened to float64, magnitudes below
1e-16 flushed to zero, deleted elements left out of CELLS.  Output goes to
``<out_dir>/fileNNN.vtk``.  Every number is formatted by the port's
host-IO helper (``csrc/host_io.cpp`` through :mod:`.native`: ``snprintf``,
so a negative NaN prints ``-nan`` as it does in the JAX package).
"""
from __future__ import annotations

import os

import numpy as np

from .native import format_e_rows, format_i_rows


def _flush_small(a: np.ndarray) -> np.ndarray:
    return np.where(np.abs(a) < 1e-16, 0.0, a)


def _fmt_block(a: np.ndarray) -> str:
    return format_e_rows(np.asarray(a))


def write_vtk(index: int, out_dir: str, coord: np.ndarray, elem: np.ndarray,
              element_flag: np.ndarray, disp: np.ndarray, velo: np.ndarray,
              node_data, n_node: int, n_element: int) -> str:
    """Write one frame.  Arrays may be padded; only the first ``n_node`` /
    ``n_element`` entries are emitted.  ``coord``/``disp``/``velo`` are
    (3, N); ``elem`` is (8, E) 0-based; node_data fields (..., N)."""
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"file{index:03d}.vtk")

    coord = np.asarray(coord)[:, :n_node]
    disp3 = _flush_small(np.asarray(disp)[:, :n_node].T)
    velo3 = _flush_small(np.asarray(velo)[:, :n_node].T)
    stress = _flush_small(np.asarray(node_data.stress)[:, :n_node])
    strain = _flush_small(np.asarray(node_data.strain)[:, :n_node])
    eq_ps = _flush_small(np.asarray(node_data.eq_ps)[:n_node])
    mises = _flush_small(np.asarray(node_data.mises)[:n_node])
    triax = _flush_small(np.asarray(node_data.triax)[:n_node])
    flag = np.asarray(element_flag)[:n_element]
    elem = np.asarray(elem)[:, :n_element]

    alive = np.nonzero(flag)[0]
    n_alive = len(alive)

    parts = []
    parts.append("# vtk DataFile Version 2.0\nTest\nASCII\n"
                 "DATASET UNSTRUCTURED_GRID\n")
    parts.append(f"POINTS {n_node} float\n")
    parts.append(_fmt_block(coord.T))
    parts.append(f"CELLS {n_alive} {n_alive * 9}\n")
    cells = elem[:, alive].T                      # (n_alive, 8)
    parts.append(format_i_rows(np.concatenate(
        [np.full((n_alive, 1), 8, np.int64), cells], axis=1)))
    parts.append(f"CELL_TYPES {n_alive}\n")
    parts.append("12\n" * n_alive)
    parts.append(f"POINT_DATA {n_node}\n")
    parts.append("VECTORS DISPLACEMENT float\n")
    parts.append(_fmt_block(disp3))

    def scalar(name, arr):
        parts.append(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
        parts.append(_fmt_block(arr))

    scalar("Vx", velo3[:, 0])
    scalar("Vy", velo3[:, 1])
    scalar("Vz", velo3[:, 2])
    scalar("E11", strain[0])
    scalar("E22", strain[1])
    scalar("E33", strain[2])
    scalar("E12", strain[3])
    scalar("E23", strain[4])
    scalar("E13", strain[5])
    scalar("EQ_PSTRAIN", eq_ps)
    scalar("S11", stress[0])
    scalar("S22", stress[1])
    scalar("S33", stress[2])
    scalar("S12", stress[3])
    scalar("S23", stress[4])
    scalar("S13", stress[5])
    scalar("MISES_STRESS", mises)
    scalar("TRIAX_STRESS", triax)

    with open(fname, "w") as f:
        f.write("".join(parts))
    return fname


def write_pvd(out_dir: str, frame_times) -> str:
    """Write a ParaView collection (.pvd) indexing the legacy-VTK frames
    with their physical times, so the run loads as a time series.
    ``frame_times`` is the ordered list of (frame_index, time)."""
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, "collection.pvd")
    rows = "\n".join(
        f'    <DataSet timestep="{t:.9e}" group="" part="0" '
        f'file="file{i:03d}.vtk"/>' for i, t in frame_times)
    with open(fname, "w") as f:
        f.write('<?xml version="1.0"?>\n'
                '<VTKFile type="Collection" version="0.1" '
                'byte_order="LittleEndian">\n  <Collection>\n'
                + rows + "\n  </Collection>\n</VTKFile>\n")
    return fname
