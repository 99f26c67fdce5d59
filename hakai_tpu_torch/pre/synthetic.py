"""Synthetic structured-mesh model builders (benchmarks, tests, dry runs)."""
from __future__ import annotations

import numpy as np

from ..io.model import BC, IC, Amplitude, Instance, Material, Model, Part


def _grid(nx, ny, nz, lx, ly, lz, origin=(0.0, 0.0, 0.0)):
    xs = np.linspace(origin[0], origin[0] + lx, nx + 1)
    ys = np.linspace(origin[1], origin[1] + ly, ny + 1)
    zs = np.linspace(origin[2], origin[2] + lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coord = np.stack([X.ravel(), Y.ravel(), Z.ravel()])

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k + 1

    elems = np.empty((nx * ny * nz, 8), np.int64)
    c = 0
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                elems[c] = [nid(i, j, k), nid(i + 1, j, k),
                            nid(i + 1, j + 1, k), nid(i, j + 1, k),
                            nid(i, j, k + 1), nid(i + 1, j, k + 1),
                            nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1)]
                c += 1
    return coord, elems.T


def steel(name="steel", plastic=True, ductile=False):
    mt = Material(name=name, density=7.8e-9, young=210000.0, poisson=0.3)
    if plastic:
        mt.plastic = np.array([[755.0, 0.0], [809.0, 0.01], [829.0, 0.02],
                               [842.0, 0.1], [895.0, 0.15], [922.0, 0.4],
                               [953.0, 1.0], [1100.0, 4.0]])
        p = mt.plastic
        mt.Hd = (p[1:, 0] - p[:-1, 0]) / (p[1:, 1] - p[:-1, 1])
    if ductile:
        mt.ductile = np.array([[1.0, 0.0, 30.0], [0.3, 0.3, 30.0]])
        mt.fracture_flag = 1
    return mt


def bar_model(nx=4, ny=4, nz=16, lx=10.0, ly=10.0, lz=50.0,
              d_time=5e-7, end_time=0.01, pull=10.0, plastic=True,
              ductile=False) -> Model:
    """Tensile bar: bottom face encastre, top face pulled along z with a
    linear ramp — a scalable version of Tensile5e.inp."""
    coord, elem = _grid(nx, ny, nz, lx, ly, lz)
    n_node = coord.shape[1]
    n_elem = elem.shape[1]
    mt = steel(plastic=plastic, ductile=ductile)
    part = Part(name="bar", n_node=n_node, coordmat=coord, n_element=n_elem,
                elementmat=elem, material_name=mt.name, material_id=1)
    inst = Instance(name="bar-1", part_name="bar", part_id=1, material_id=1,
                    n_node=n_node, n_element=n_elem)
    m = Model(parts=[part], instances=[inst], materials=[mt],
              n_node=n_node, coordmat=coord, n_element=n_elem,
              elementmat=elem,
              element_material=np.ones(n_elem, np.int64),
              element_instance=np.ones(n_elem, np.int64),
              d_time=d_time, end_time=end_time)
    amp = Amplitude(name="ramp", time=np.array([0.0, end_time]),
                    value=np.array([0.0, 1.0]))
    m.amplitudes.append(amp)
    bottom = np.nonzero(coord[2] == coord[2].min())[0] + 1
    top = np.nonzero(coord[2] == coord[2].max())[0] + 1
    enc = BC()
    enc.dof.append(np.concatenate([bottom * 3 - 2, bottom * 3 - 1, bottom * 3]))
    enc.value = [0.0]
    m.bcs.append(enc)
    pullbc = BC(amp_name="ramp", amplitude=amp)
    pullbc.dof.append(top * 3)
    pullbc.value.append(pull)
    m.bcs.append(pullbc)
    return m


def impact_model(n=4, v0=100.0, d_time=1e-7, end_time=1e-4) -> Model:
    """Two-instance impact: a flying cube hitting a fixed slab, all-exterior
    contact + ductile erosion — a scalable bullet-impact analogue."""
    c1, e1 = _grid(2 * n, 2 * n, 1, 2.0, 2.0, 0.2)
    c2, e2 = _grid(n, n, n, 0.6, 0.6, 0.6, origin=(0.7, 0.7, 0.25))
    mt = steel(ductile=True)
    p1 = Part(name="slab", n_node=c1.shape[1], coordmat=c1,
              n_element=e1.shape[1], elementmat=e1,
              material_name="steel", material_id=1)
    p2 = Part(name="cube", n_node=c2.shape[1], coordmat=c2,
              n_element=e2.shape[1], elementmat=e2,
              material_name="steel", material_id=1)
    i1 = Instance(name="slab-1", part_name="slab", part_id=1, material_id=1,
                  n_node=p1.n_node, n_element=p1.n_element)
    i2 = Instance(name="cube-1", part_name="cube", part_id=2, material_id=1,
                  node_offset=p1.n_node, element_offset=p1.n_element,
                  n_node=p2.n_node, n_element=p2.n_element)
    m = Model(parts=[p1, p2], instances=[i1, i2], materials=[mt],
              n_node=p1.n_node + p2.n_node,
              coordmat=np.concatenate([c1, c2], axis=1),
              n_element=p1.n_element + p2.n_element,
              elementmat=np.concatenate([e1, e2 + p1.n_node], axis=1),
              element_material=np.ones(p1.n_element + p2.n_element, np.int64),
              element_instance=np.concatenate(
                  [np.ones(p1.n_element, np.int64),
                   np.full(p2.n_element, 2, np.int64)]),
              d_time=d_time, end_time=end_time, contact_flag=1)
    bottom = np.nonzero(c1[2] == c1[2].min())[0] + 1
    enc = BC()
    enc.dof.append(np.concatenate([bottom * 3 - 2, bottom * 3 - 1, bottom * 3]))
    enc.value = [0.0]
    m.bcs.append(enc)
    cube_nodes = np.arange(p1.n_node + 1, p1.n_node + p2.n_node + 1)
    m.ics.append(IC(type="VELOCITY", dof=[cube_nodes * 3], value=[-v0]))
    return m


def offset_instance(m: Model, inst: int, dx: float, dy: float) -> Model:
    """Move instance ``inst`` (0-based) of ``m`` in plane by (dx, dy), in
    place: its part's coordinates and the model's.  An off-grid offset
    takes the aligned grids of :func:`impact_model` out of the node-on-edge
    ties of the accept tests (see :func:`self_contact_model`)."""
    i = m.instances[inst]
    part = m.parts[i.part_id - 1]
    nodes = slice(i.node_offset, i.node_offset + i.n_node)
    part.coordmat = part.coordmat + np.array([[dx], [dy], [0.0]])
    m.coordmat = m.coordmat.copy()
    m.coordmat[:2, nodes] += np.array([[dx], [dy]])
    return m


def self_contact_model(n=4, gap=0.05, v0=5.0e4, d_time=3e-8,
                       end_time=6e-6) -> Model:
    """Single-instance self-contact: two parallel plates belonging to ONE
    instance, the upper driven into the lower.  With ``contact_flag=2``
    (the parser's ``HAKAIoption=self-contact``, readInpFile_j.jl:1046-1060)
    the lowering forms the single-instance self pair (HAKAI_j.jl:304-312):
    own-element node exclusion (HAKAI_j.jl:2496-2507), ddiv scale 0.6 and
    kc_self all exercised."""
    # the in-plane offset keeps node-on-triangle projections strictly
    # inside triangles: perfectly aligned grids put every projection on a
    # triangle edge, where the accept tests (x1>=0, x1+x2<=1) become
    # roundoff-order-dependent ties between any two implementations
    c1, e1 = _grid(n, n, 1, 2.0, 2.0, 0.2)
    c2, e2 = _grid(n, n, 1, 2.0, 2.0, 0.2, origin=(0.13, 0.17, 0.2 + gap))
    coord = np.concatenate([c1, c2], axis=1)
    elem = np.concatenate([e1, e2 + c1.shape[1]], axis=1)
    n_node, n_elem = coord.shape[1], elem.shape[1]
    mt = steel(plastic=True)
    part = Part(name="plates", n_node=n_node, coordmat=coord,
                n_element=n_elem, elementmat=elem,
                material_name=mt.name, material_id=1)
    inst = Instance(name="plates-1", part_name="plates", part_id=1,
                    material_id=1, n_node=n_node, n_element=n_elem)
    m = Model(parts=[part], instances=[inst], materials=[mt],
              n_node=n_node, coordmat=coord, n_element=n_elem,
              elementmat=elem,
              element_material=np.ones(n_elem, np.int64),
              element_instance=np.ones(n_elem, np.int64),
              d_time=d_time, end_time=end_time, contact_flag=2)
    bottom = np.nonzero(coord[2] == coord[2].min())[0] + 1
    enc = BC()
    enc.dof.append(np.concatenate([bottom * 3 - 2, bottom * 3 - 1,
                                   bottom * 3]))
    enc.value = [0.0]
    m.bcs.append(enc)
    upper = np.nonzero(coord[2] >= 0.2 + gap - 1e-12)[0] + 1
    m.ics.append(IC(type="VELOCITY", dof=[upper * 3], value=[-v0]))
    return m
