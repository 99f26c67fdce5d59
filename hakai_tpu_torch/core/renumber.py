"""Mesh bandwidth reduction (reverse Cuthill-McKee renumbering).

The Pallas blocked-gather (ops/gather_pallas.py) and the halo decomposition
(parallel/halo.py) need mesh locality: all node ids referenced by a tile of
consecutive elements must fit in a bounded window.  Structured meshes are
naturally banded; gmsh-style decks (e.g. the car-crash meshes) are not, so
lowering renumbers nodes per *part* with RCM and reorders elements by their
minimum new node id.

The renumbering is internal: VTK frames and any user-facing output are mapped
back to the deck's original numbering via the permutations recorded on
:class:`~hakai_tpu.core.lowering.LoweredModel`.
"""
from __future__ import annotations

import copy
from typing import Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import reverse_cuthill_mckee

from ..io.model import Model


def _safe_rank(rank: np.ndarray, ids_1based) -> np.ndarray:
    """Remap 1-based local ids; out-of-range ids (dangling assembly
    reference points) pass through unchanged."""
    ids = np.asarray(ids_1based)
    ok = (ids >= 1) & (ids <= len(rank))
    out = ids.copy()
    out[ok] = rank[ids[ok] - 1] + 1
    return out


def _part_perms(part) -> Tuple[np.ndarray, np.ndarray]:
    """Per-part node rank (old local 0-based -> new local 0-based) and
    element order (new position -> old element index)."""
    n = part.n_node
    em = np.asarray(part.elementmat).T - 1           # (E, 8) 0-based
    if n == 0 or em.size == 0:
        return np.arange(n), np.arange(part.n_element)
    # node adjacency: nodes sharing an element
    pairs_i = np.repeat(em, 8, axis=1).reshape(-1)
    pairs_j = np.tile(em, (1, 8)).reshape(-1)
    adj = coo_matrix((np.ones(len(pairs_i), np.int8), (pairs_i, pairs_j)),
                     shape=(n, n)).tocsr()
    order = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
    rank_rcm = np.empty(n, np.int64)
    rank_rcm[order] = np.arange(n)
    # Geometric sweep candidate: sort nodes along the part's longest
    # coordinate axis (ties by the other axes).  On box-like meshes this
    # gives the optimal cross-section bandwidth, where RCM's diagonal level
    # sets are up to ~3x wider near corners (64x64x512 bar: sweep span
    # 4225 uniform, RCM max 12610, deck x-major 33k).
    c = np.asarray(part.coordmat)
    ax = np.argsort(np.ptp(c, axis=1))               # ascending extent
    sweep = np.lexsort((c[ax[0]], c[ax[1]], c[ax[2]]))
    rank_sweep = np.empty(n, np.int64)
    rank_sweep[sweep] = np.arange(n)
    # Keep whichever numbering has the smallest WORST element node span —
    # the quantity that drives halo width and gather-plan windows.
    best_rank, best_span = np.arange(n), \
        int((em.max(axis=1) - em.min(axis=1)).max())
    for rank in (rank_rcm, rank_sweep):
        new_em = rank[em]
        span = int((new_em.max(axis=1) - new_em.min(axis=1)).max())
        if span < best_span:
            best_rank, best_span = rank, span
    new_em = best_rank[em]
    elem_order = np.argsort(new_em.min(axis=1), kind="stable")
    return best_rank, elem_order


def renumber_model(model: Model) -> Tuple[Model, np.ndarray, np.ndarray]:
    """Return (renumbered deep-copied model, node_new2old (nNode,),
    elem_new2old (nElement,)) with global 0-based permutations mapping the
    new internal order back to the deck's original order."""
    m = copy.deepcopy(model)
    part_rank = {}
    part_eord = {}
    for pid, part in enumerate(m.parts):
        rank, eord = _part_perms(part)
        part_rank[pid] = rank
        part_eord[pid] = eord
        inv = np.empty_like(rank)
        inv[rank] = np.arange(len(rank))             # new -> old
        part.coordmat = np.ascontiguousarray(part.coordmat[:, inv])
        em = np.asarray(part.elementmat)
        em = rank[em - 1] + 1                        # remap node ids
        part.elementmat = np.ascontiguousarray(em[:, eord])
        erank = np.empty_like(eord)
        erank[eord] = np.arange(len(eord))
        part_eord[pid] = (eord, erank)
        for ns in part.nsets:
            ns.nodes = _safe_rank(rank, ns.nodes)

    def node_map_global(dof_or_node, is_dof):
        """Remap resolved global 1-based nodes/dofs."""
        arr = np.asarray(dof_or_node)
        if is_dof:
            node = (arr - 1) // 3
            axis = (arr - 1) % 3
        else:
            node = arr - 1
        out = node.copy()
        for inst in m.instances:
            lo = inst.node_offset
            hi = lo + inst.n_node
            sel = (node >= lo) & (node < hi)
            if sel.any():
                rank = part_rank[inst.part_id - 1]
                out[sel] = rank[node[sel] - lo] + lo
        if is_dof:
            return out * 3 + axis + 1
        return out + 1

    for ns in m.nsets:
        if ns.instance_id > 0 and len(ns.nodes):
            rank = part_rank[ns.part_id - 1]
            ns.nodes = _safe_rank(rank, ns.nodes)
    for es in m.elsets:
        if es.instance_id > 0 and len(es.elements):
            _, erank = part_eord[es.part_id - 1]
            es.elements = erank[np.asarray(es.elements) - 1] + 1
    for sf in m.surfaces:
        if sf.instance_id > 0 and len(sf.elements):
            part_id = m.instances[sf.instance_id - 1].part_id
            _, erank = part_eord[part_id - 1]
            sf.elements = erank[np.asarray(sf.elements) - 1] + 1
    for cp in m.cps:
        for attr, iid in (("elements_1", cp.instance_id_1),
                          ("elements_2", cp.instance_id_2)):
            els = getattr(cp, attr)
            if iid > 0 and len(els):
                part_id = m.instances[iid - 1].part_id
                _, erank = part_eord[part_id - 1]
                setattr(cp, attr, erank[np.asarray(els) - 1] + 1)
    for bc in m.bcs:
        bc.dof = [node_map_global(d, True) for d in bc.dof]
    for ic in m.ics:
        ic.dof = [node_map_global(d, True) for d in ic.dof]

    # rebuild the flattened global tables (translate/rotate unchanged)
    n_node = 0
    coord_blocks = []
    elem_blocks = []
    import math
    for inst in m.instances:
        part = m.parts[inst.part_id - 1]
        ci = part.coordmat.copy()
        for s in reversed(inst.translate):
            ss = [t for t in s.split(",") if t]
            if len(ss) == 3:
                ci = ci + np.array([[float(ss[0])], [float(ss[1])],
                                    [float(ss[2])]])
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
    m.coordmat = np.concatenate(coord_blocks, axis=1)
    m.elementmat = np.concatenate(elem_blocks, axis=1)

    # global permutations: new internal id -> original deck id (0-based)
    node_new2old = np.zeros(m.n_node, np.int64)
    elem_new2old = np.zeros(m.n_element, np.int64)
    for inst in m.instances:
        rank = part_rank[inst.part_id - 1]
        inv = np.empty_like(rank)
        inv[rank] = np.arange(len(rank))
        lo = inst.node_offset
        node_new2old[lo:lo + inst.n_node] = inv + lo
        eord, _ = part_eord[inst.part_id - 1]
        elo = inst.element_offset
        elem_new2old[elo:elo + inst.n_element] = eord + elo
    return m, node_new2old, elem_new2old
