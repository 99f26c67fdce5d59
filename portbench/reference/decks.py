"""The benchmark's synthetic decks, as plain NumPy data.

A frozen copy of the deck generators ``bar_model`` and ``impact_model``
(``hakai_tpu_torch/pre/synthetic.py`` as of the port's PR 16, the same as
``hakai_tpu/pre/synthetic.py``), written without the package's model types:
a deck is a :class:`Deck` of arrays that both the program (through its
public ``Model`` types, ``portbench/program.py``) and the plain reference
(``portbench/reference/solver.py``) read.  The grid is built vectorised;
its node numbering and element node order are the generator's.

A configuration names its generator (``deck.generator``): ``bar`` and
``impact`` are this file's, any other name ``g`` is the file
``portbench/decks/<g>.py``, whose ``deck(**args)`` gives the :class:`Deck`
and whose ``TINY`` holds the arguments of a deck small enough for the
harness's CPU tests (:func:`generator`).

:func:`jitter` moves every node by a seeded uniform amount, a fixed share
of the smallest element edge, so that each seed gives another mesh of the
same sizes and the same work.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace

import numpy as np

from .. import named

# the checkout whose portbench/ holds this file
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# steel (synthetic.steel): density t/mm^3, Young MPa, Poisson
DENSITY, YOUNG, POISSON = 7.8e-9, 210000.0, 0.3
# (yield stress MPa, equivalent plastic strain) rows
PLASTIC = np.array([[755.0, 0.0], [809.0, 0.01], [829.0, 0.02],
                    [842.0, 0.1], [895.0, 0.15], [922.0, 0.4],
                    [953.0, 1.0], [1100.0, 4.0]])
# (fracture strain, triaxiality, strain rate) rows
DUCTILE = np.array([[1.0, 0.0, 30.0], [0.3, 0.3, 30.0]])


@dataclass
class Instance:
    name: str
    node_offset: int        # 0-based first node of the instance
    n_node: int
    elem_offset: int        # 0-based first element
    n_elem: int


@dataclass
class Deck:
    """One synthetic deck in the generator's numbering (0-based ids)."""
    coord: np.ndarray               # (3, n) float64
    elem: np.ndarray                # (8, E) int64, 0-based node ids
    instances: list                 # [Instance], in deck order
    ductile: bool                   # the steel carries the ductile table
    d_time: float
    end_time: float
    fixed_nodes: np.ndarray         # nodes with all three dofs held at 0
    pulled_nodes: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))  # z dof ramped
    pull: float = 0.0               # pulled dof's final displacement, mm
    ramp_end: float = 0.0           # the ramp amplitude's end time
    ic_nodes: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))  # initial z velocity
    ic_vz: float = 0.0
    # HAKAI's contact mode (readInpFile_j.jl:1046-1060): 0 none; 1
    # ``*Contact``, all exterior faces between instances; 2 ``*Contact
    # Inclusions, HAKAIoption=self-contact``, each instance also against
    # itself.  A single instance with contact is against itself in both.
    contact_flag: int = 0

    @property
    def contact(self) -> bool:
        return self.contact_flag > 0

    @property
    def n_node(self) -> int:
        return self.coord.shape[1]

    @property
    def n_elem(self) -> int:
        return self.elem.shape[1]


def grid(nx, ny, nz, lx, ly, lz, origin=(0.0, 0.0, 0.0)):
    """(coord (3, n), elem (8, nx*ny*nz) 0-based) of a structured box, in
    ``synthetic._grid``'s numbering: node (i, j, k) is
    (i*(ny+1) + j)*(nz+1) + k, elements i-major, then j, then k."""
    xs = np.linspace(origin[0], origin[0] + lx, nx + 1)
    ys = np.linspace(origin[1], origin[1] + ly, ny + 1)
    zs = np.linspace(origin[2], origin[2] + lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coord = np.stack([X.ravel(), Y.ravel(), Z.ravel()])
    i, j, k = (a.ravel() for a in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))

    def nid(a, b, c):
        return (a * (ny + 1) + b) * (nz + 1) + c

    elem = np.stack([nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k),
                     nid(i, j + 1, k), nid(i, j, k + 1),
                     nid(i + 1, j, k + 1), nid(i + 1, j + 1, k + 1),
                     nid(i, j + 1, k + 1)])
    return coord, elem.astype(np.int64)


def bar_deck(nx=4, ny=4, nz=16, lx=10.0, ly=10.0, lz=50.0, d_time=5e-7,
             end_time=0.01, pull=10.0, ductile=False, ramp_end=None) -> Deck:
    """Tensile bar (``bar_model``): bottom face encastre, top face pulled
    along z by ``pull`` on a linear ramp over ``ramp_end`` (default
    ``end_time``, as ``bar_model`` has it; a span cut short of the deck's
    keeps the deck's ramp, and so its pull rate)."""
    coord, elem = grid(nx, ny, nz, lx, ly, lz)
    z = coord[2]
    return Deck(coord=coord, elem=elem,
                instances=[Instance("bar-1", 0, coord.shape[1], 0,
                                    elem.shape[1])],
                ductile=ductile, d_time=d_time, end_time=end_time,
                fixed_nodes=np.nonzero(z == z.min())[0],
                pulled_nodes=np.nonzero(z == z.max())[0], pull=pull,
                ramp_end=end_time if ramp_end is None else ramp_end)


def impact_deck(n=4, v0=100.0, d_time=1e-7, end_time=1e-4) -> Deck:
    """Flying cube on a fixed slab (``impact_model``): the slab's bottom
    face encastre, the cube at -``v0`` along z, all-exterior contact and
    ductile erosion."""
    c1, e1 = grid(2 * n, 2 * n, 1, 2.0, 2.0, 0.2)
    c2, e2 = grid(n, n, n, 0.6, 0.6, 0.6, origin=(0.7, 0.7, 0.25))
    n1, m1 = c1.shape[1], e1.shape[1]
    return Deck(coord=np.concatenate([c1, c2], axis=1),
                elem=np.concatenate([e1, e2 + n1], axis=1),
                instances=[Instance("slab-1", 0, n1, 0, m1),
                           Instance("cube-1", n1, c2.shape[1], m1,
                                    e2.shape[1])],
                ductile=True, d_time=d_time, end_time=end_time,
                fixed_nodes=np.nonzero(c1[2] == c1[2].min())[0],
                ic_nodes=np.arange(n1, n1 + c2.shape[1]), ic_vz=-v0,
                contact_flag=1)


def min_edge(deck: Deck) -> float:
    """The shortest of every element's three edges from node 0."""
    p = deck.coord[:, deck.elem]
    return float(min(np.linalg.norm(p[:, 0] - p[:, s], axis=0).min()
                     for s in (1, 3, 4)))


def jitter(deck: Deck, seed: int, share: float) -> Deck:
    """The deck with every node moved by a uniform draw in
    [-share, share] x the smallest element edge on each axis, from
    ``seed``.  The boundary sets were chosen on the unmoved grid."""
    rng = np.random.default_rng(seed % 2**64)
    a = share * min_edge(deck)
    return replace(deck, coord=deck.coord + rng.uniform(-a, a,
                                                        deck.coord.shape))


GENERATORS = {"bar": bar_deck, "impact": impact_deck}
# tiny decks of each generator for the CPU tests: a bar of 4x4x16 at the
# deck's pull rate, and a cube of 4^3 that strikes its slab at 300 m/s and
# erodes some 40 elements (at 200 m/s a cube this coarse erodes a few)
TINY = {"bar": dict(nx=4, ny=4, nz=16, d_time=5e-8, end_time=1e-5),
        "impact": dict(n=4, v0=3.0e5, d_time=1e-8, end_time=1.5e-6)}


def generator(name: str, root: str = ROOT) -> tuple:
    """(``deck(**args) -> Deck``, its tiny arguments) of the generator
    named ``name``: this file's, else ``portbench/decks/<name>.py``'s
    ``deck`` and ``TINY`` under ``root``."""
    if name in GENERATORS:
        return GENERATORS[name], TINY[name]
    mod = named.module(root, "decks", name)
    return mod.deck, mod.TINY


def build(params: dict, seed: int, share: float, root: str = ROOT) -> Deck:
    """The configuration file's deck (``generator`` and its arguments),
    jittered from ``seed``."""
    make, _ = generator(params["generator"], root)
    return jitter(make(**params["args"]), seed, share)
