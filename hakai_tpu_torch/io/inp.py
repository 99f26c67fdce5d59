"""Abaqus ``.inp`` front-end, the port's own copy of ``hakai_tpu/io/inp.py``:
for the same lines it builds the same :class:`~hakai_tpu_torch.io.model.Model`
(``tests/test_torch_copies.py``).

Reproduces the keyword surface and line-oriented substring-matching semantics
of the reference parser (``HAKAI-v0.0.2/Julia/readInpFile_j.jl:152-1113``):
unknown keywords are silently ignored, matches are substring-based (e.g.
``"*Element"`` also matches ``"*Element, type=C3D8R"``), and part-level
``*Nset`` is only honoured with ``generate``.

The output :class:`~hakai_tpu_torch.io.model.Model` keeps the reference's
global flattening: per-instance translate/rotate applied to part coordinates
(readInpFile_j.jl:567-621), concatenated node/element tables with 1-based ids.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from .model import (
    BC, IC, Amplitude, ContactPair, Elset, Instance, Material, Model, Nset,
    Part, Surface,
)
from .native import parse_numbers


def _after(s: str, key: str) -> str:
    """Return the substring after the first occurrence of ``key``."""
    i = s.index(key)
    return s[i + len(key):]


def _split(line: str) -> List[str]:
    """Strip spaces then split on commas, dropping empty fields — mirrors
    ``split(replace(line, " "=>""), ",", keepempty=false)``."""
    return [t for t in line.replace(" ", "").split(",") if t]


def _generate_range(fields: List[str]) -> np.ndarray:
    """``start, stop, step`` inclusive range (readInpFile_j.jl:288)."""
    start, stop, step = int(fields[0]), int(fields[1]), int(fields[2])
    return np.arange(start, stop + (1 if step > 0 else -1), step, dtype=np.int64)


def read_inp_file(fname: str) -> Model:
    with open(fname, "r") as f:
        lines = f.read().splitlines()
    return parse_inp_lines(lines)


def parse_inp_lines(lines: List[str]) -> Model:
    n = len(lines)
    model = Model()

    # --- Parts (readInpFile_j.jl:165-308) ---
    part_index = [i for i in range(n) if "*Part, name=" in lines[i]]
    for k, pi in enumerate(part_index):
        part = Part()
        ss = _split(lines[pi])
        part.name = _after(ss[1], "name=")

        # *Node block: first "*Node" at/after the part header
        index = next(i for i in range(pi, n) if "*Node" in lines[i])
        n_node = 0
        for i in range(index + 1, n):
            if "*" in lines[i]:
                break
            n_node += 1
        part.n_node = n_node
        block = "\n".join(lines[index + 1: index + 1 + n_node])
        coord = parse_numbers(block, expect=n_node * 4).reshape(n_node, 4)
        part.coordmat = np.ascontiguousarray(coord[:, 1:4].T)  # (3, n_node)

        # *Element block
        index = next(i for i in range(pi, n) if "*Element" in lines[i])
        n_elem = 0
        for i in range(index + 1, n):
            if "*" in lines[i]:
                break
            n_elem += 1
        part.n_element = n_elem
        block = "\n".join(lines[index + 1: index + 1 + n_elem])
        elem = parse_numbers(block, expect=n_elem * 9).reshape(n_elem, 9)
        elem = elem[:, 1:9].astype(np.int64)
        part.elementmat = np.ascontiguousarray(elem.T)  # (8, n_elem)

        # part-level *Nset: only the "generate" form (readInpFile_j.jl:262-290)
        for i in range(pi, n):
            if "*End Part" in lines[i]:
                break
            if "*Nset" in lines[i] and "generate" in lines[i]:
                ns = Nset()
                ss = _split(lines[i])
                ns.name = _after(ss[1], "nset=")
                ns.nodes = _generate_range(_split(lines[i + 1]))
                part.nsets.append(ns)

        # *Solid Section material= (first after part header; readInpFile_j.jl:292-306)
        for i in range(pi, n):
            if "*Solid Section" in lines[i]:
                for tok in _split(lines[i]):
                    if "material=" in tok:
                        part.material_name = _after(tok, "material=")
                        break
                break
        model.parts.append(part)

    # --- Instances (readInpFile_j.jl:312-362) ---
    instance_index = [i for i in range(n) if "*Instance" in lines[i]
                      and "*End Instance" not in lines[i]]
    for ii in instance_index:
        inst = Instance()
        ss = _split(lines[ii])
        inst.name = _after(ss[1], "name=")
        inst.part_name = _after(ss[2], "part=")
        for pid, p in enumerate(model.parts):
            if p.name == inst.part_name:
                inst.part_id = pid + 1
                break
        for i in range(ii + 1, n):
            if "*End Instance" in lines[i]:
                break
            inst.translate.append(lines[i].replace(" ", ""))
        model.instances.append(inst)

    # --- assembly Nsets (readInpFile_j.jl:366-432) ---
    for idx in (i for i in range(n) if "*Nset" in lines[i] and "instance=" in lines[i]):
        ns = Nset()
        ss = _split(lines[idx])
        ns.name = _after(ss[1], "nset=")
        ns.instance_name = _after(ss[2], "instance=")
        for j, inst in enumerate(model.instances):
            if ns.instance_name == inst.name:
                ns.part_name = inst.part_name
                ns.part_id = inst.part_id
                ns.instance_id = j + 1
        if len(ss) == 4 and ss[3] == "generate":
            ns.nodes = _generate_range(_split(lines[idx + 1]))
        else:
            acc: List[int] = []
            for i in range(idx + 1, n):
                if "*" in lines[i]:
                    break
                acc += [int(t) for t in _split(lines[i])]
            ns.nodes = np.asarray(acc, np.int64)
        model.nsets.append(ns)

    # --- assembly Elsets (readInpFile_j.jl:436-514) ---
    for idx in (i for i in range(n) if "*Elset" in lines[i] and "instance=" in lines[i]):
        es = Elset()
        ss = _split(lines[idx])
        es.name = _after(ss[1], "elset=")
        if "instance=" in ss[2]:
            es.instance_name = _after(ss[2], "instance=")
        elif len(ss) > 3 and "instance=" in ss[3]:
            es.instance_name = _after(ss[3], "instance=")
        for j, inst in enumerate(model.instances):
            if es.instance_name == inst.name:
                es.part_name = inst.part_name
                es.part_id = inst.part_id
                es.instance_id = j + 1
        if len(ss) == 4 and ss[3] == "generate":
            es.elements = _generate_range(_split(lines[idx + 1]))
        elif len(ss) == 5 and ss[2] == "internal" and ss[4] == "generate":
            es.elements = _generate_range(_split(lines[idx + 1]))
        elif len(ss) == 4 and ss[2] == "internal":
            acc = []
            for i in range(idx + 1, n):
                if "*" in lines[i]:
                    break
                acc += [int(t) for t in _split(lines[i])]
            es.elements = np.asarray(acc, np.int64)
        # plain 3-field form keeps an empty element list, as in the reference
        model.elsets.append(es)

    # --- Surfaces (readInpFile_j.jl:518-563) ---
    for idx in (i for i in range(n) if "*Surface," in lines[i]):
        sf = Surface()
        ss = _split(lines[idx])
        sf.name = _after(ss[2], "name=")
        acc = []
        for i in range(idx + 1, n):
            if "*" in lines[i]:
                break
            name = _split(lines[i])[0]
            sf.elset_names.append(name)
            for es in model.elsets:
                if name == es.name:
                    sf.instance_id = es.instance_id
                    acc += list(es.elements)
        sf.elements = np.unique(np.asarray(sorted(acc), np.int64))
        model.surfaces.append(sf)

    # --- Global flatten: instance translate/rotate + concat (readInpFile_j.jl:567-621) ---
    n_node = 0
    n_element = 0
    coord_blocks = []
    elem_blocks = []
    for inst in model.instances:
        part = model.parts[inst.part_id - 1]
        ci = part.coordmat.copy()
        inst.node_offset = n_node
        inst.element_offset = n_element
        inst.n_node = part.n_node
        inst.n_element = part.n_element
        for s in reversed(inst.translate):
            ss = [t for t in s.split(",") if t]
            if len(ss) == 3:
                off = np.array([[float(ss[0])], [float(ss[1])], [float(ss[2])]])
                ci = ci + off
            elif len(ss) == 7:
                nv = np.array([float(ss[3]) - float(ss[0]),
                               float(ss[4]) - float(ss[1]),
                               float(ss[5]) - float(ss[2])])
                nv = nv / np.linalg.norm(nv)
                n1, n2, n3 = nv
                d = float(ss[6]) / 180.0 * math.pi
                c, s_ = math.cos(d), math.sin(d)
                T = np.array([
                    [n1*n1*(1-c)+c,    n1*n2*(1-c)-n3*s_, n1*n3*(1-c)+n2*s_],
                    [n1*n2*(1-c)+n3*s_, n2*n2*(1-c)+c,    n2*n3*(1-c)-n1*s_],
                    [n1*n3*(1-c)-n2*s_, n2*n3*(1-c)+n1*s_, n3*n3*(1-c)+c],
                ])
                ci = T @ ci
        coord_blocks.append(ci)
        elem_blocks.append(part.elementmat + n_node)
        n_node += part.n_node
        n_element += part.n_element
    model.n_node = n_node
    model.n_element = n_element
    model.coordmat = (np.concatenate(coord_blocks, axis=1)
                      if coord_blocks else np.zeros((3, 0)))
    model.elementmat = (np.concatenate(elem_blocks, axis=1)
                        if elem_blocks else np.zeros((8, 0), np.int64))

    # --- Amplitudes (readInpFile_j.jl:625-668) ---
    for idx in (i for i in range(n) if "*Amplitude" in lines[i]):
        am = Amplitude()
        ss = _split(lines[idx])
        am.name = _after(ss[1], "name=")
        t_acc: List[float] = []
        v_acc: List[float] = []
        for i in range(idx + 1, n):
            if "*" in lines[i]:
                break
            ss = _split(lines[i])
            for j in range(len(ss) // 2):
                t_acc.append(float(ss[2 * j]))
                v_acc.append(float(ss[2 * j + 1]))
        am.time = np.asarray(t_acc)
        am.value = np.asarray(v_acc)
        model.amplitudes.append(am)

    # --- Materials (readInpFile_j.jl:672-793) ---
    material_index = [i for i in range(n) if "*Material" in lines[i]]
    for idx in material_index:
        mt = Material()
        ss = _split(lines[idx])
        mt.name = _after(ss[1], "name=")
        plastic_index = -1
        ductile_index = -1
        for i in range(idx + 1, n):
            if "*Material" in lines[i] or "**" in lines[i]:
                break
            if "*Density" in lines[i]:
                mt.density = float(_split(lines[i + 1])[0])
            if "*Elastic" in lines[i]:
                ss = _split(lines[i + 1])
                mt.young = float(ss[0])
                mt.poisson = float(ss[1])
            if "*Plastic" in lines[i]:
                plastic_index = i
            if "*Damage Initiation" in lines[i] and "criterion=DUCTILE" in lines[i]:
                ductile_index = i
                mt.fracture_flag = 1
            if "*Tensile Failure" in lines[i]:
                mt.failure_stress = float(_split(lines[i + 1])[0])
                mt.has_failure_stress = True
                mt.fracture_flag = 1
        if plastic_index > idx:
            rows = []
            for i in range(plastic_index + 1, n):
                if "*" in lines[i]:
                    break
                ss = _split(lines[i])
                rows.append([float(ss[0]), float(ss[1])])
            mt.plastic = np.asarray(rows)
        if mt.plastic.shape[0] > 1:
            p = mt.plastic
            mt.Hd = (p[1:, 0] - p[:-1, 0]) / (p[1:, 1] - p[:-1, 1])
        if ductile_index > idx:
            rows = []
            for i in range(ductile_index + 1, n):
                if "*" in lines[i]:
                    break
                ss = _split(lines[i])
                rows.append([float(ss[0]), float(ss[1]), float(ss[2])])
            mt.ductile = np.asarray(rows)
        model.materials.append(mt)

    # --- element -> material / instance maps (readInpFile_j.jl:796-813) ---
    em: List[int] = []
    ei: List[int] = []
    for i, inst in enumerate(model.instances):
        part = model.parts[inst.part_id - 1]
        for j, mt in enumerate(model.materials):
            if part.material_name == mt.name:
                part.material_id = j + 1
                inst.material_id = j + 1
        em += [part.material_id] * part.n_element
        ei += [i + 1] * part.n_element
    model.element_material = np.asarray(em, np.int64)
    model.element_instance = np.asarray(ei, np.int64)

    # --- Step / mass scaling (readInpFile_j.jl:817-840) ---
    for i in range(n):
        if "*Dynamic, Explicit" in lines[i]:
            ss = _split(lines[i + 1])
            model.d_time = float(ss[0])
            model.end_time = float(ss[1])
            break
    for i in range(n):
        if "*Fixed Mass Scaling" in lines[i]:
            model.mass_scaling = float(_after(_split(lines[i])[1], "factor="))
            break

    # --- BCs (readInpFile_j.jl:844-957) ---
    bc_index = [i for i in range(n) if "*Boundary" in lines[i]]
    for idx in bc_index:
        bc = BC()
        ss = _split(lines[idx])
        if len(ss) == 2 and "amplitude=" in ss[1]:
            bc.amp_name = _after(ss[1], "amplitude=")
            for am in model.amplitudes:
                if am.name == bc.amp_name:
                    bc.amplitude = am
                    break
        for i in range(idx + 1, n):
            if "*Boundary" in lines[i] or "**" in lines[i]:
                break
            ss = _split(lines[i])
            bc.nset_name = ss[0]
            nodes = _resolve_nset_nodes(model, bc.nset_name)
            if len(ss) == 2 and "ENCASTRE" in ss[1]:
                dof = np.concatenate([nodes * 3 - 2, nodes * 3 - 1, nodes * 3])
                bc.dof.append(dof)
                bc.value = [0.0]
            elif len(ss) == 3:
                direction = int(ss[2])
                if direction <= 3:
                    bc.dof.append(nodes * 3 - (3 - direction))
                    bc.value.append(0.0)
            elif len(ss) == 4:
                direction = int(ss[2])
                if direction <= 3:
                    bc.dof.append(nodes * 3 - (3 - direction))
                    bc.value.append(float(ss[3]))
        model.bcs.append(bc)

    # --- Initial conditions (readInpFile_j.jl:961-1043) ---
    ic_index = [i for i in range(n) if "*Initial Conditions" in lines[i]]
    for idx in ic_index:
        ic = IC()
        ic.type = _after(_split(lines[idx])[1], "type=")
        for i in range(idx + 1, n):
            if "*Initial Conditions" in lines[i] or "**" in lines[i]:
                break
            ss = _split(lines[i])
            ic.nset_name = ss[0]
            nodes = _resolve_nset_nodes(model, ic.nset_name, first_only=True)
            direction = int(ss[1])
            ic.dof.append(nodes * 3 - (3 - direction))
            ic.value.append(float(ss[2]))
        model.ics.append(ic)

    # --- Contact (readInpFile_j.jl:1047-1102) ---
    for i in range(n):
        if "*Contact" in lines[i]:
            model.contact_flag = 1
            break
    for i in range(n):
        if "*Contact Inclusions" in lines[i] and "HAKAIoption=self-contact" in lines[i]:
            model.contact_flag = 2
            break
    for idx in (i for i in range(n) if "*Contact Pair," in lines[i]):
        cp = ContactPair()
        cp.name = _after(_split(lines[idx])[3], "cpset=")
        ss = _split(lines[idx + 1])
        cp.surface_name_1, cp.surface_name_2 = ss[0], ss[1]
        for sf in model.surfaces:
            if cp.surface_name_1 == sf.name:
                cp.instance_id_1 = sf.instance_id
                cp.elements_1 = sf.elements
            if cp.surface_name_2 == sf.name:
                cp.instance_id_2 = sf.instance_id
                cp.elements_2 = sf.elements
        model.cps.append(cp)

    return model


def _resolve_nset_nodes(model: Model, name: str, first_only: bool = False) -> np.ndarray:
    """Resolve an nset reference to global 1-based node ids.

    ``instance.nset`` names resolve against the part-level nsets
    (readInpFile_j.jl:889-910); bare names against assembly nsets, appending
    *all* same-named sets for BCs (readInpFile_j.jl:913-919) but only the
    first for ICs (readInpFile_j.jl:1020-1026).
    """
    nodes: List[np.ndarray] = []
    if "." in name:
        inst_name, nset_name = name.split(".", 1)
        for j, inst in enumerate(model.instances):
            if inst.name == inst_name:
                part = model.parts[inst.part_id - 1]
                for ns in part.nsets:
                    if ns.name == nset_name:
                        nodes.append(ns.nodes + inst.node_offset)
                        break
                break
    else:
        for ns in model.nsets:
            if ns.name == name:
                nodes.append(ns.nodes + model.instances[ns.instance_id - 1].node_offset)
                if first_only:
                    break
    if not nodes:
        return np.zeros(0, np.int64)
    return np.concatenate(nodes)
