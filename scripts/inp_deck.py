"""Write models as Abaqus ``.inp`` decks that the ``.inp`` readers of both
packages parse back to the same model.

    python3 scripts/inp_deck.py OUT.inp [nx ny nz] [--ductile]
        [--d-time DT] [--end-time T]

writes ``bar_model(nx, ny, nz, ...)`` of the port's ``pre.synthetic``
(default 4 4 16).  From Python, :func:`deck_text` turns any model of the
synthetic builders' kind into deck text (parts, instances, assembly node
sets, ``*Amplitude``, ``*Material`` with ``*Plastic`` and ``*Damage
Initiation``, ``*Dynamic, Explicit``, ``*Boundary``, ``*Initial
Conditions`` and the ``*Contact`` keywords), and :func:`cp_deck_lines`
gives the two-instance ``*Contact Pair`` deck of
``tests/test_oracle_diff.py``.  Floats are written with ``repr``, so they
parse back bit for bit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _floats(values) -> str:
    return ", ".join(repr(float(v)) for v in values)


def _id_lines(ids, per_line=16):
    ids = [int(i) for i in ids]
    return [", ".join(map(str, ids[i:i + per_line]))
            for i in range(0, len(ids), per_line)]


def _instance_of(model, nodes):
    """(instance, instance-local ids) of global 1-based ``nodes``, which
    must all lie in one instance."""
    for inst in model.instances:
        lo, hi = inst.node_offset, inst.node_offset + inst.n_node
        if ((nodes > lo) & (nodes <= hi)).all():
            return inst, nodes - lo
    raise ValueError("a node set spans instances")


def _dof_sets(bc_dof, values):
    """The data lines of one ``*Boundary`` block as (nodes, form, value):
    form "ENCASTRE" for one all-axes dof array with value 0, else the
    single axis (1-3) of each dof array."""
    if (len(bc_dof) == 1 and len(values) == 1 and values[0] == 0.0
            and len(bc_dof[0]) % 3 == 0 and len(bc_dof[0])):
        d = np.asarray(bc_dof[0])
        n = len(d) // 3
        nodes = (d[:n] + 2) // 3
        if (np.array_equal(d, np.concatenate([nodes * 3 - 2, nodes * 3 - 1,
                                              nodes * 3]))):
            return [(nodes, "ENCASTRE", 0.0)]
    out = []
    for dof, val in zip(bc_dof, values):
        d = np.asarray(dof)
        axis = (d - 1) % 3
        if not (axis == axis[0]).all():
            raise ValueError("a dof line mixes axes")
        out.append(((d - 1) // 3 + 1, int(axis[0]) + 1, float(val)))
    return out


def deck_lines(model, heading="synthetic deck") -> list[str]:
    """The deck text of ``model`` as a list of lines."""
    L = ["*Heading", f"** {heading}"]
    for p in model.parts:
        L += [f"*Part, name={p.name}", "*Node"]
        c = np.asarray(p.coordmat, np.float64).T.tolist()
        L += [f"{i + 1}, {x!r}, {y!r}, {z!r}" for i, (x, y, z) in enumerate(c)]
        L.append("*Element, type=C3D8R")
        el = np.asarray(p.elementmat, np.int64).T
        L += [f"{e + 1}, " + ", ".join(map(str, row))
              for e, row in enumerate(el.tolist())]
        L += [f"*Elset, elset=Set-{p.name}, generate",
              f"1, {p.n_element}, 1",
              f"*Solid Section, elset=Set-{p.name}, "
              f"material={p.material_name}", "*End Part", "**"]
    L.append("*Assembly, name=Assembly")
    for inst in model.instances:
        L += [f"*Instance, name={inst.name}, part={inst.part_name}",
              "*End Instance"]
    boundary, initial = [], []
    for k, bc in enumerate(model.bcs):
        block = []
        for j, (nodes, form, val) in enumerate(_dof_sets(bc.dof, bc.value)):
            inst, local = _instance_of(model, np.asarray(nodes))
            name = f"BC-{k + 1}-{j + 1}"
            L.append(f"*Nset, nset={name}, instance={inst.name}")
            L += _id_lines(local)
            block.append(f"{name}, ENCASTRE" if form == "ENCASTRE"
                         else f"{name}, {form}, {form}, {val!r}")
        head = "*Boundary" + (f", amplitude={bc.amp_name}"
                              if bc.amp_name else "")
        boundary += [head] + block + ["**"]
    for k, ic in enumerate(model.ics):
        block = []
        for j, (dof, val) in enumerate(zip(ic.dof, ic.value)):
            d = np.asarray(dof)
            inst, local = _instance_of(model, (d - 1) // 3 + 1)
            name = f"IC-{k + 1}-{j + 1}"
            L.append(f"*Nset, nset={name}, instance={inst.name}")
            L += _id_lines(local)
            block.append(f"{name}, {int((d[0] - 1) % 3) + 1}, "
                         f"{float(val)!r}")
        initial += [f"*Initial Conditions, type={ic.type}"] + block + ["**"]
    L += ["*End Assembly", "**"]
    for a in model.amplitudes:
        L += [f"*Amplitude, name={a.name}",
              _floats(np.stack([a.time, a.value], axis=1).ravel())]
    for mt in model.materials:
        L += [f"*Material, name={mt.name}", "*Density",
              f"{float(mt.density)!r},", "*Elastic",
              _floats([mt.young, mt.poisson])]
        if len(mt.plastic):
            L.append("*Plastic")
            L += [_floats(row) for row in mt.plastic]
        if len(mt.ductile):
            L.append("*Damage Initiation, criterion=DUCTILE")
            L += [_floats(row) for row in mt.ductile]
        if mt.has_failure_stress:
            L += ["*Tensile Failure", f"{float(mt.failure_stress)!r},"]
        L.append("**")
    L += ["*Step, name=Step-1, nlgeom=YES", "*Dynamic, Explicit",
          _floats([model.d_time, model.end_time])]
    if model.mass_scaling != 1.0:
        L.append("*Fixed Mass Scaling, factor="
                 f"{float(model.mass_scaling)!r}")
    L.append("**")
    L += boundary + initial
    if model.contact_flag:
        L += ["*Contact, op=NEW", "*Contact Inclusions, ALL EXTERIOR"
              + (", HAKAIoption=self-contact" if model.contact_flag == 2
                 else ""), "**"]
    L.append("*End Step")
    return L


def deck_text(model, heading="synthetic deck") -> str:
    return "\n".join(deck_lines(model, heading)) + "\n"


def write_deck(path: str, model, heading="synthetic deck") -> str:
    with open(path, "w") as f:
        f.write(deck_text(model, heading))
    return path


def cp_deck_lines(gap=0.018, v0=5.0e4, d_time=2e-8) -> list[str]:
    """The minimal two-instance ``*Contact Pair`` deck of
    ``tests/test_oracle_diff.py:_cp_deck_lines``, line for line: a 2x2x1
    striker falls onto a 4x4x1 plate whose contact surface is its central
    2x2 elements (assembly ``*Elset ... internal, instance=``,
    ``*Surface, type=ELEMENT``, ``*Contact Pair, ... cpset=``)."""
    from hakai_tpu_torch.pre.synthetic import _grid, steel

    ct, et = _grid(4, 4, 1, 2.0, 2.0, 0.25)
    cs, es = _grid(2, 2, 1, 1.0, 1.0, 0.25,
                   origin=(0.43, 0.48, 0.25 + gap))
    mt = steel(plastic=True)
    L = ["*Heading", "** CP-pair oracle fixture"]

    def emit_part(name, coord, elem, elset):
        L.append(f"*Part, name={name}")
        L.append("*Node")
        for i in range(coord.shape[1]):
            L.append(f" {i + 1}, " + ", ".join(
                repr(float(coord[a, i])) for a in range(3)))
        L.append("*Element, type=C3D8")
        for e in range(elem.shape[1]):
            L.append(" " + ", ".join(str(v) for v in [e + 1]
                                     + list(elem[:, e])))
        L.append(f"*Elset, elset={elset}, generate")
        L.append(f" 1, {elem.shape[1]}, 1")
        L.append(f"*Solid Section, elset={elset}, material=steel")
        L.append("*End Part")

    emit_part("target", ct, et, "all-target")
    emit_part("striker", cs, es, "all-striker")
    L += ["*Assembly, name=Assembly",
          "*Instance, name=target-1, part=target", "*End Instance",
          "*Instance, name=striker-1, part=striker", "*End Instance"]
    bottom = np.nonzero(ct[2] == 0.0)[0] + 1
    L.append("*Nset, nset=Set-bottom, instance=target-1")
    for i in range(0, len(bottom), 8):
        L.append(" " + ", ".join(str(v) for v in bottom[i:i + 8]))
    L += ["*Nset, nset=Set-striker, instance=striker-1, generate",
          f" 1, {cs.shape[1]}, 1",
          "*Elset, elset=_CPS-T_S6, internal, instance=target-1",
          " 6, 7, 10, 11",
          "*Surface, type=ELEMENT, name=CPS-T",
          "_CPS-T_S6, S6",
          "*Elset, elset=_CPS-S_S1, internal, instance=striker-1, generate",
          f" 1, {es.shape[1]}, 1",
          "*Surface, type=ELEMENT, name=CPS-S",
          "_CPS-S_S1, S1",
          "*End Assembly",
          "*Material, name=steel",
          "*Density",
          f" {mt.density!r},",
          "*Elastic",
          f" {mt.young!r}, {mt.poisson!r}",
          "*Plastic"]
    for row in mt.plastic:
        L.append(f" {float(row[0])!r}, {float(row[1])!r}")
    L += ["*Dynamic, Explicit",
          f"{d_time!r}, 8e-06",
          "**",
          "*Boundary",
          "Set-bottom, ENCASTRE",
          "**",
          "*Initial Conditions, type=VELOCITY",
          f"Set-striker, 3, {-v0!r}",
          "**",
          "*Contact Pair, interaction=IntProp-1, "
          "mechanical constraint=KINEMATIC, cpset=CPS-1",
          "CPS-S, CPS-T"]
    return L


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hakai_tpu_torch.pre.synthetic import bar_model
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("shape", nargs="*", type=int, default=[4, 4, 16])
    ap.add_argument("--ductile", action="store_true")
    ap.add_argument("--d-time", type=float, default=5e-8)
    ap.add_argument("--end-time", type=float, default=1e-4)
    args = ap.parse_args(argv)
    m = bar_model(*args.shape, d_time=args.d_time, end_time=args.end_time,
                  ductile=args.ductile)
    write_deck(args.out, m, f"bar_model{tuple(args.shape)}")
    print(f"{args.out}: {m.n_node} nodes, {m.n_element} elements")
    return 0


if __name__ == "__main__":
    sys.exit(main())
