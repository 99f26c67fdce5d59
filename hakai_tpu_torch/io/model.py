"""In-memory model objects produced by the Abaqus ``.inp`` front-end.

These mirror the reference solver's model schema (the 11 mutable structs in
``HAKAI-v0.0.2/Julia/readInpFile_j.jl:23-150``) but are plain Python
dataclasses holding NumPy arrays.  They are a *front-end* representation
only: the solver never touches them.  ``hakai_tpu.core.lowering`` compiles a
:class:`Model` into padded, static-shape device arrays.

Conventions kept from the reference:
  * ``coordmat`` is column-major ``(3, n_node)`` (readInpFile_j.jl:227).
  * ``elementmat`` is column-major ``(8, n_element)`` (readInpFile_j.jl:259).
  * node / element ids inside parts are 1-based; the global model keeps
    1-based ids as well (lowering converts to 0-based).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class Nset:
    """*Nset — named node set (readInpFile_j.jl:23-30)."""
    name: str = ""
    instance_name: str = ""
    instance_id: int = 0      # 1-based, 0 = unset
    part_name: str = ""
    part_id: int = 0
    nodes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))


@dataclass
class Elset:
    """*Elset — named element set (readInpFile_j.jl:32-39)."""
    name: str = ""
    instance_name: str = ""
    instance_id: int = 0
    part_name: str = ""
    part_id: int = 0
    elements: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))


@dataclass
class Surface:
    """*Surface — element-set based surface (readInpFile_j.jl:41-46)."""
    name: str = ""
    elset_names: List[str] = field(default_factory=list)
    instance_id: int = 0
    elements: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))


@dataclass
class Part:
    """*Part block (readInpFile_j.jl:48-57)."""
    name: str = ""
    n_node: int = 0
    coordmat: np.ndarray = field(default_factory=lambda: np.zeros((3, 0)))
    n_element: int = 0
    elementmat: np.ndarray = field(default_factory=lambda: np.zeros((8, 0), np.int64))
    nsets: List[Nset] = field(default_factory=list)
    material_name: str = ""
    material_id: int = 0


@dataclass
class Instance:
    """*Instance block (readInpFile_j.jl:59-76)."""
    name: str = ""
    part_name: str = ""
    part_id: int = 0          # 1-based
    material_id: int = 0      # 1-based
    translate: List[str] = field(default_factory=list)   # raw lines, spaces stripped
    node_offset: int = 0
    n_node: int = 0
    element_offset: int = 0
    n_element: int = 0


@dataclass
class Amplitude:
    """*Amplitude curve (readInpFile_j.jl:78-82).

    Unlike the reference — which keeps only the *last* data line of a
    multi-line amplitude (readInpFile_j.jl:656-665 re-initializes the
    accumulator per line) — all data lines are concatenated.  Identical on
    every shipped deck (all use single-line amplitudes).
    """
    name: str = ""
    time: np.ndarray = field(default_factory=lambda: np.zeros(0))
    value: np.ndarray = field(default_factory=lambda: np.zeros(0))


@dataclass
class Material:
    """*Material block (readInpFile_j.jl:84-96)."""
    name: str = ""
    density: float = 0.0
    young: float = 0.0
    poisson: float = 0.0
    plastic: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))  # (yield stress, eq plastic strain)
    Hd: np.ndarray = field(default_factory=lambda: np.zeros(0))            # hardening slopes between table rows
    fracture_flag: int = 0
    failure_stress: float = 0.0    # *Tensile Failure (0 = unset)
    has_failure_stress: bool = False
    ductile: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))  # (fracture strain, triaxiality, rate)

    @property
    def G(self) -> float:
        """Shear modulus (HAKAI_j.jl:146)."""
        return self.young / 2.0 / (1.0 + self.poisson)

    @property
    def lam(self) -> float:
        """Lamé first parameter; together with G reproduces the 6x6 Dmat of
        HAKAI_j.jl:149-160 (isotropic linear elasticity, engineering shear)."""
        return (self.young * self.poisson
                / ((1.0 + self.poisson) * (1.0 - 2.0 * self.poisson)))


@dataclass
class BC:
    """*Boundary block (readInpFile_j.jl:98-104).

    ``dof`` holds one 1-based global-dof index array per data line
    (dof = 3*(node-1)+axis, axes 1..3); ``value`` the prescribed displacement.
    """
    nset_name: str = ""
    dof: List[np.ndarray] = field(default_factory=list)
    value: List[float] = field(default_factory=list)
    amp_name: str = ""
    amplitude: Amplitude | None = None


@dataclass
class IC:
    """*Initial Conditions block (readInpFile_j.jl:106-111)."""
    nset_name: str = ""
    type: str = ""
    dof: List[np.ndarray] = field(default_factory=list)
    value: List[float] = field(default_factory=list)


@dataclass
class ContactPair:
    """*Contact Pair (readInpFile_j.jl:113-127). Element ids are part-local."""
    name: str = ""
    surface_name_1: str = ""
    surface_name_2: str = ""
    instance_id_1: int = 0
    instance_id_2: int = 0
    elements_1: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    elements_2: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))


@dataclass
class Model:
    """Whole parsed deck (readInpFile_j.jl:129-150)."""
    parts: List[Part] = field(default_factory=list)
    instances: List[Instance] = field(default_factory=list)
    nsets: List[Nset] = field(default_factory=list)
    elsets: List[Elset] = field(default_factory=list)
    surfaces: List[Surface] = field(default_factory=list)
    amplitudes: List[Amplitude] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    bcs: List[BC] = field(default_factory=list)
    ics: List[IC] = field(default_factory=list)
    cps: List[ContactPair] = field(default_factory=list)
    n_node: int = 0
    coordmat: np.ndarray = field(default_factory=lambda: np.zeros((3, 0)))
    n_element: int = 0
    elementmat: np.ndarray = field(default_factory=lambda: np.zeros((8, 0), np.int64))
    element_material: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))  # 1-based
    element_instance: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))  # 1-based
    d_time: float = 0.0
    end_time: float = 0.0
    mass_scaling: float = 1.0
    contact_flag: int = 0   # 0 none, 1 general, 2 self-contact


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)
