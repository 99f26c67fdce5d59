"""Wrappers of the contact kernels (``csrc/contact.cu``) and their plain
PyTorch versions: the narrow phase (kernel N), the port's design for the
block loop of ``hakai_tpu/ops/contact.py:_pair_force`` (XLA on the TPU),
and the per-node force scatter (kernel S), which replaces the TPU's
scatter-as-gather chain through ``blocked_gather``
(``hakai_tpu/ops/gather_pallas.py`` ``_make_diag_kernel`` and
``_make_merged_kernel`` on the plans ``plan_fgi``/``plan_fgt``/``plan_fx``).

For tensors on the CPU each wrapper runs its plain version; for CUDA
tensors it launches the kernel on the current stream, or raises.

The plain narrow phase is the JAX loop itself: the surviving block pairs
in pair-id order, each a dense (TB, nb) evaluation whose sums are added
per block (force_i) and per block over 3 (force_t).  Its per-pair
arithmetic is written in the kernel's association order with every
constant a tensor of the element type (PyTorch divides by a Python scalar
as a multiply by its reciprocal on the card), so the two take bitwise
equal accept decisions on equal inputs.  The kernel's enumeration of
candidates (the rule that picks the fine or the ddiv hash, and the pairs
each side visits) has a plain twin too: :func:`fine_rule_plain`,
:func:`cell_candidates_plain` and :func:`probe_counts_plain`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..core.lowering import ContactPair, LoweredModel

_NARROW = {torch.float32: "hk_narrow_f32", torch.float64: "hk_narrow_f64"}
# workspace values per triangle and per node (kGeo, kNode in csrc/contact.cu)
_GEO, _NODE = 28, 8
# int32 words of the work list's header (kHeader) and the word of the
# call's rule in it (kRule)
_HEADER, _RULE = 16, 2
# the fine cell over the largest in-range circumradius, and the largest
# extent in fine cells that the rule takes (csrc/contact.cu fine_rule)
_FINE_CELL, _FINE_EXTENT = 1.0625, 32768.0
# (triangles, nodes, dtype, device) -> the narrow phase's workspace
_WORKSPACES: dict = {}
# (force dtype, nodal dtype) -> scatter entry; float32 -> float64 is mixed
_SCATTER = {(torch.float32, torch.float32): "hk_scatter_f32",
            (torch.float64, torch.float64): "hk_scatter_f64",
            (torch.float32, torch.float64): "hk_scatter_f32_f64"}


class PairConstants(NamedTuple):
    """A pair's penalty constants, as Python floats (``_pair_force``)."""
    young: float
    kc: float
    Cr: float
    myu: float
    d_lim: float
    ddiv: float


def pair_constants(model: LoweredModel, pair: ContactPair) -> PairConstants:
    cc = model.config.contact
    return PairConstants(
        young=pair.young,
        kc=cc.kc_self if pair.is_self else cc.kc,
        Cr=cc.Cr_self if pair.is_self else cc.Cr,
        myu=cc.myu,
        d_lim=model.element_min_size * cc.d_lim_scale,
        ddiv=model.element_max_size * (cc.ddiv_scale_self if pair.is_self
                                       else cc.ddiv_scale))


class NarrowCounts(NamedTuple):
    """What ``narrow_phase(..., count=True)`` returns: per item, as each
    side counted it (int32), and the call's rule."""
    node: torch.Tensor      # (Cp,) accepted pairs a node slot
    tri: torch.Tensor       # (Tp,) accepted pairs a triangle slot
    visits: torch.Tensor    # (Cp + Tp,) candidates the item visited
    near: torch.Tensor      # (Cp + Tp,) of them past the radius cull
    fine: torch.Tensor      # () bool: the call took the fine hash


class BroadPhase(NamedTuple):
    """The broad phase's result for one pair (device tensors)."""
    tri_in: torch.Tensor    # (F2,) bool: active and in the overlap range
    node_in: torch.Tensor   # (Ci,) bool
    all_min: torch.Tensor   # (3,) grid origin
    pair_ok: torch.Tensor   # (tri_chunks, n_chunks) bool block pairs kept
    overlap: torch.Tensor   # () bool: the two sides' boxes overlap


def kin_views(kin, ksl):
    """(q0, q1, q2, vel_j0, pos_i, vel_i, pos_jn) of one pair: slices of the
    merged (6, R) kinematics gather."""
    (a0, b0), (a1, b1), (a2, b2), (cs, ce), (js, je) = ksl
    return (kin[:3, a0:b0], kin[:3, a1:b1], kin[:3, a2:b2], kin[3:, a0:b0],
            kin[:3, cs:ce], kin[3:, cs:ce], kin[:3, js:je])


def _sq3(x):
    return (x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]


def _cells(p, lo, ddiv):
    """cell = ceil((p - all_min) / ddiv), int32 (HAKAI_j.jl:2331-2363)."""
    return torch.ceil((p - lo[:, None]) / ddiv).to(torch.int32)


def tri_geometry(q0, q1, q2, c):
    """Per-triangle geometry of ``_pair_force`` (contact.py:266-303) for
    (3, T) vertex rows: (ctr, rmax, nrm, kpen, im (3 rows of (3, T)))."""
    ctr = ((q0 + q1) + q2) / c["three"]
    rmax = torch.sqrt(torch.maximum(torch.maximum(_sq3(q0 - ctr),
                                                  _sq3(q1 - ctr)),
                                    _sq3(q2 - ctr)))
    v1, v2 = q1 - q0, q2 - q0
    L1, L2 = torch.sqrt(_sq3(v1)), torch.sqrt(_sq3(v2))
    Lm = torch.maximum(L1, L2)
    safe_L = torch.where(Lm == 0, 1.0, Lm)
    cr = torch.stack([v1[1] * v2[2] - v1[2] * v2[1],
                      v1[2] * v2[0] - v1[0] * v2[2],
                      v1[0] * v2[1] - v1[1] * v2[0]])
    mag = torch.sqrt(_sq3(cr))
    nrm = cr / torch.where(mag == 0, 1.0, mag)
    d12 = (v1[0] * v2[0] + v1[1] * v2[1]) + v1[2] * v2[2]
    S = c["half"] * torch.sqrt(torch.clamp_min(
        (L1 * L1) * (L2 * L2) - d12 * d12, 0.0))
    kpen = ((c["young"] * S) / safe_L) * c["kc"]
    A = (v1, v2, -nrm)
    det = (((((A[0][0] * A[1][1]) * A[2][2] + (A[1][0] * A[2][1]) * A[0][2])
             + (A[2][0] * A[0][1]) * A[1][2]) - (A[0][0] * A[2][1]) * A[1][2])
           - (A[1][0] * A[0][1]) * A[2][2]) - (A[2][0] * A[1][1]) * A[0][2]
    sd = torch.where(det == 0, 1.0, det)

    def inv_row(r):
        c1, c2 = (r + 1) % 3, (r + 2) % 3
        return torch.stack([A[c1][1] * A[c2][2] - A[c2][1] * A[c1][2],
                            A[c2][0] * A[c1][2] - A[c1][0] * A[c2][2],
                            A[c1][0] * A[c2][1] - A[c2][0] * A[c1][1]]) / sd
    return ctr, rmax, nrm, kpen, (inv_row(0), inv_row(1), inv_row(2))


def constants_on(consts: PairConstants, dtype, device) -> dict:
    """The constants as 0-d tensors of ``dtype`` on ``device``, with the
    literals of the formulas (3, 0.5, 2)."""
    c = {k: torch.tensor(v, dtype=dtype, device=device)
         for k, v in consts._asdict().items()}
    for k, v in (("three", 3.0), ("half", 0.5), ("two", 2.0)):
        c[k] = torch.tensor(v, dtype=dtype, device=device)
    return c


def narrow_phase_plain(pair: ContactPair, kin, ksl, bp: BroadPhase,
                       consts: PairConstants, record: bool = False,
                       sides=None):
    """(force_i (3, Cp), force_t (3, Tp)[, info]) of one pair: the block
    loop of ``_pair_force`` (contact.py:252-374).  With ``record``, ``info``
    holds the accepted (triangle, node slot) pairs in loop order
    (``pairs``), those that passed the cell test and the own-element
    exclusion (``cell_pairs``), and the counts of pairs that reached each
    test (``cell``: both sides in and the cell test passed; ``dist``: the
    circumradius cull passed; ``accept``).
    ``sides`` = (node side's, triangle side's) block-pair masks, by default
    both ``bp.pair_ok``: force_i sums the first's pairs, force_t the
    second's."""
    q0, q1, q2, vj0, pos_i, vel_i, _ = kin_views(kin, ksl)
    dt, dev = kin.dtype, kin.device
    F2, Ci, TB, nb = q0.shape[1], pos_i.shape[1], pair.tb, pair.nb
    c = constants_on(consts, dt, dev)
    force_i = torch.zeros((3, pair.Cp), dtype=dt, device=dev)
    force_t = torch.zeros((3, pair.Tp), dtype=dt, device=dev)
    info = {"pairs": [], "cell_pairs": [], "cell": 0, "dist": 0,
            "accept": 0}
    if bool(bp.overlap):
        ctr, rmax, nrm, kpen, im = tri_geometry(q0, q1, q2, c)
        cell_t = _cells(q0, bp.all_min, c["ddiv"])
        cell_n = _cells(pos_i, bp.all_min, c["ddiv"])
        ids = pair.cand_nodes
        ok_i, ok_t = (x.reshape(-1).tolist() for x in
                      (sides if sides is not None else (bp.pair_ok,) * 2))
        for pid in (p for p, ok in enumerate(zip(ok_i, ok_t)) if any(ok)):
            t0 = (pid // pair.n_chunks) * TB
            c0 = (pid % pair.n_chunks) * nb
            ts, cs = slice(t0, min(t0 + TB, F2)), slice(c0, min(c0 + nb, Ci))
            p, vi = pos_i[:, None, cs], vel_i[:, None, cs]        # (3, 1, C)
            m = (bp.tri_in[ts, None] & bp.node_in[None, cs]
                 & ((cell_t[:, ts, None] - cell_n[:, None, cs]).abs() <= 1
                    ).all(dim=0))
            if pair.is_self:
                m &= ~(pair.tri_enodes[:, ts, None]
                       == ids[None, None, cs]).any(dim=0)
            n_cell = int(m.sum()) if record else 0
            if record:
                hit = torch.nonzero(m)
                info["cell_pairs"].append(torch.stack([hit[:, 0] + t0,
                                                       hit[:, 1] + c0], 1))
            dpc = torch.sqrt(_sq3(p - ctr[:, ts, None]))
            m &= dpc < rmax[ts, None]
            n_dist = int(m.sum()) if record else 0
            b = p - q0[:, ts, None]                                # (3, T, C)
            x1, x2, d = ((r[0][ts, None] * b[0] + r[1][ts, None] * b[1])
                         + r[2][ts, None] * b[2] for r in im)
            m &= ((x1 >= 0.0) & (x2 >= 0.0) & (x1 + x2 <= 1.0)
                  & (d > 0.0) & (d <= c["d_lim"]))
            F = kpen[ts, None] * d
            vr = vi - vj0[:, ts, None]
            magv = torch.sqrt(_sq3(vr))
            ve = torch.where(magv > 0, vr / torch.where(magv == 0, 1.0, magv),
                             0.0)
            n3 = nrm[:, ts, None]
            dot = (ve[0] * n3[0] + ve[1] * n3[1]) + ve[2] * n3[2]
            Cd = (c["two"] * torch.sqrt(pair.cand_mass[None, cs]
                                        * kpen[ts, None])) * c["Cr"]
            f = (F * n3 - (c["myu"] * F) * (ve - dot * n3)) - Cd * vr
            f = torch.where(m, f, 0.0)
            if ok_i[pid]:
                force_i[:, cs] += f.sum(dim=1)
            if ok_t[pid]:
                force_t[:, ts] += f.sum(dim=2) / c["three"]
            if record:
                hit = torch.nonzero(m)
                info["pairs"].append(torch.stack([hit[:, 0] + t0,
                                                  hit[:, 1] + c0], dim=1))
                info["cell"] += n_cell
                info["dist"] += n_dist
                info["accept"] += len(hit)
    if record:
        for k in ("pairs", "cell_pairs"):
            info[k] = (torch.cat(info[k]) if info[k] else
                       torch.zeros((0, 2), dtype=torch.long, device=dev))
        return force_i, force_t, info
    return force_i, force_t


def narrow_buckets(n_tri: int, n_node: int) -> int:
    """Buckets B that the workspace holds for each of the narrow phase's
    two spatial hashes (the ddiv hash or the fine hash, whichever a call
    builds): the least power of two above an eighth of the larger side, 64
    at least.  Shapes alone set it.  A call takes the least power of two of
    them that is not below its in-range items (64 to B), found on the
    device, so its scan reads no more buckets than its items need (a
    fracture deck's face inventory is mostly out of range); a collision
    costs only candidates that the exact-cell test drops."""
    return max(64, 1 << (max(n_tri, n_node) // 8).bit_length())


def _header(B: int) -> int:
    """Offset of the work list's header in the int32 workspace."""
    return 4 * B + 4 + -(-max(1, 2 * B // 1024) // 4) * 4


def narrow_workspace(n_tri: int, n_node: int, dtype, device):
    """(int32 bucket counts and starts, the work list's header (its
    counter, the call's rule, R and E), work list and item records,
    element-type rows, B): the narrow phase's workspace for a pair of these
    shapes, allocated once per shapes, dtype and device and rewritten by
    every call (calls run in stream order, so pairs of equal shapes can
    share it).  Either hash a call builds, the ddiv hash or the fine hash,
    lives in the same buckets and records: the fine hash adds only the
    header's 12 words beside the counters.  Its counters start zero, and
    each call leaves them so."""
    key = (n_tri, n_node, dtype, device)
    if key not in _WORKSPACES:
        B, items = narrow_buckets(n_tri, n_node), n_tri + n_node
        _WORKSPACES[key] = (
            torch.zeros(_header(B) + _HEADER + -(-items // 4) * 4
                        + 8 * items, dtype=torch.int32, device=device),
            torch.empty(_GEO * n_tri + _NODE * n_node + 4 * items,
                        dtype=dtype, device=device), B)
    return _WORKSPACES[key]


def _bucket(cells, B):
    """csrc/contact.cu's bucket of (3, n) int64 cells."""
    h = ((cells[0] * 73856093) ^ (cells[1] * 19349663)
         ^ (cells[2] * 83492791)) & 0xFFFFFFFF
    return h & (B - 1)


def _probe(own, own_cell, other, other_cell, B):
    """(own item, other item) for every listed own item and every listed
    other item whose cell lies within one cell of its own: the buckets of
    the 27 cells around each own cell in a hash of the other side, each
    bucket filtered by the exact probed cell: the kernel's enumeration."""
    dev = own.device
    b = _bucket(other_cell, B)
    order = torch.argsort(b, stable=True)
    keys = torch.arange(B, device=dev)
    start = torch.searchsorted(b[order], keys)
    size = torch.searchsorted(b[order], keys, right=True) - start
    near = torch.tensor([(x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1)
                         for x in (-1, 0, 1)], device=dev).T
    cell = (own_cell[:, :, None] + near[:, None, :]).reshape(3, -1)
    pb = _bucket(cell, B)
    n = size[pb]
    visit = torch.repeat_interleave(torch.arange(len(pb), device=dev), n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    j = order[start[pb][visit] + torch.arange(len(visit), device=dev)
              - first]
    exact = (other_cell[:, j] == cell[:, visit]).all(dim=0)
    return own[visit[exact] // 27], other[j[exact]]


class FineRule(NamedTuple):
    """Kernel N's rule for one call: which hash it builds."""
    on: torch.Tensor        # () bool: the fine hash
    inv: torch.Tensor       # () 1 / h, the fine cell's inverse
    reach: torch.Tensor     # () R, the largest in-range circumradius


def _rule(kin, ksl, bp: BroadPhase, c):
    """(FineRule, centroids, circumradii) of one call; see
    :func:`fine_rule_plain`."""
    q0, q1, q2, _, pos_i, _, _ = kin_views(kin, ksl)
    ctr, rmax = tri_geometry(q0, q1, q2, c)[:2]
    lo = bp.all_min[:, None]
    tin, nin = bp.tri_in & bp.overlap, bp.node_in & bp.overlap
    zero = kin.new_zeros(1)
    reach = torch.cat([zero, rmax[tin]]).amax()
    extent = torch.cat([zero, (ctr - lo).abs()[:, tin].reshape(-1),
                        (pos_i - lo).abs()[:, nin].reshape(-1)]).amax()
    h = reach * torch.tensor(_FINE_CELL, dtype=kin.dtype, device=kin.device)
    inv = torch.ones_like(h) / h
    on = (h * c["two"] <= c["ddiv"]) & (extent * inv <= _FINE_EXTENT)
    return FineRule(on, inv, reach), ctr, rmax


def fine_rule_plain(kin, ksl, bp: BroadPhase,
                    consts: PairConstants) -> FineRule:
    """The rule of ``csrc/contact.cu`` (``fine_rule``) on the device of its
    inputs: R, the largest circumradius of the call's in-range triangles;
    E, the largest |x - all_min| of their centroids and of the in-range
    nodes' positions; the fine hash where its cell h = 17/16 R is at most
    half of ddiv and E / h is at most 2^15 (nothing in range, or R or E
    not finite: the ddiv hash).  Both decide from the same floats."""
    return _rule(kin, ksl, bp, constants_on(consts, kin.dtype,
                                            kin.device))[0]


def _enumerate(pair: ContactPair, kin, ksl, bp: BroadPhase,
               consts: PairConstants, sides, buckets, fine):
    """Kernel N's enumeration of one call: (rule, [node side's, triangle
    side's] (k, n, tested, near)): the (triangle, node slot) pairs each
    listed in-range item visits (the other side's in-range items whose
    cell in the call's hash lies within one of its own), whether each
    passes the tests before the radius cull (on the fine hash the +-1
    ddiv-cell test; the side's block-pair mask; on a self pair the
    own-element exclusion) and whether it passes the radius cull too.
    ``fine`` None takes the rule's hash, False the ddiv hash."""
    q0, _, _, _, pos_i, _, _ = kin_views(kin, ksl)
    c = constants_on(consts, kin.dtype, kin.device)
    rule, ctr, rmax = _rule(kin, ksl, bp, c)
    use = fine is None and bool(rule.on)
    ct = _cells(q0, bp.all_min, c["ddiv"]).long()
    cn = _cells(pos_i, bp.all_min, c["ddiv"]).long()
    if use:
        lo = bp.all_min[:, None]
        kt = torch.floor((ctr - lo) * rule.inv).long()
        kn = torch.floor((pos_i - lo) * rule.inv).long()
    else:
        kt, kn = ct, cn
    oks = (bp.pair_ok,) * 2 if sides is None else tuple(sides)
    tri = torch.nonzero(bp.tri_in & bp.overlap).reshape(-1)
    node = torch.nonzero(bp.node_in & bp.overlap).reshape(-1)
    # a rank's share probes from its own blocks' items (one device: all)
    nl, tl = ((node, tri) if sides is None else
              (node[oks[0].any(dim=0)[node // pair.nb]],
               tri[oks[1].any(dim=1)[tri // pair.tb]]))
    B = buckets or narrow_buckets(q0.shape[1], pos_i.shape[1])
    out = []
    for side, ok in enumerate(oks):
        if side == 0:
            n, k = _probe(nl, kn[:, nl], tri, kt[:, tri], B)
        else:
            k, n = _probe(tl, kt[:, tl], node, kn[:, node], B)
        tested = ok[k // pair.tb, n // pair.nb]
        if use:
            tested &= ((ct[:, k] - cn[:, n]).abs() <= 1).all(dim=0)
        if pair.is_self:
            tested &= ~(pair.tri_enodes[:, k].long()
                        == pair.cand_nodes[n].long()).any(dim=0)
        near = tested & (torch.sqrt(_sq3(pos_i[:, n] - ctr[:, k]))
                         < rmax[k])
        out.append((k, n, tested, near))
    return rule, out


def cell_candidates_plain(pair: ContactPair, kin, ksl, bp: BroadPhase,
                          consts: PairConstants, sides=None, buckets=None,
                          fine=None):
    """The (triangle, node slot) pairs each side of kernel N tests past the
    cell test, as (node side's, triangle side's) (P, 2) int64 lists: the
    in-range nodes probing a hash of the in-range triangles, and the
    triangles probing a hash of the nodes; each pair in a block pair of
    that side's mask (``sides``, by default both ``bp.pair_ok``) and, on a
    self pair, not of the triangle's own element.  On the ddiv hash the
    hashes key triangles by q0's ddiv cell and nodes by theirs, and a pair
    is within one ddiv cell; on the fine hash they key triangles by their
    centroid's fine cell and nodes by theirs, and a pair is within one fine
    cell and one ddiv cell.  ``fine`` None takes the hash of the call's
    rule (:func:`fine_rule_plain`), as the kernel does; False the ddiv
    hash, the 27-cell sweep.
    ``buckets`` (default :func:`narrow_buckets` of the shapes) sets B;
    fewer buckets only add collisions.  The plain twin of the kernel's
    cull, for tests; nothing on the main path calls it."""
    _, sides_out = _enumerate(pair, kin, ksl, bp, consts, sides, buckets,
                              fine)
    return tuple(torch.stack([k[t], n[t]], dim=1)
                 for k, n, t, _ in sides_out)


def probe_counts_plain(pair: ContactPair, kin, ksl, bp: BroadPhase,
                       consts: PairConstants, sides=None, fine=None):
    """(visits, near, rule) of one call as kernel N counts them: per force
    column (node slots, then triangle slots; (Cp + Tp,) int32) the
    candidates the item visited (the other side's items in its probed
    cells) and of those the ones past the radius cull, and the call's
    :class:`FineRule`; ``fine`` as for :func:`cell_candidates_plain`."""
    rule, sides_out = _enumerate(pair, kin, ksl, bp, consts, sides, None,
                                 fine)
    cols = pair.Cp + pair.Tp
    visits = torch.zeros(cols, dtype=torch.long, device=kin.device)
    near = torch.zeros_like(visits)
    for side, (k, n, _, nr) in enumerate(sides_out):
        col = n if side == 0 else pair.Cp + k
        visits += torch.bincount(col, minlength=cols)
        near += torch.bincount(col[nr], minlength=cols)
    return visits.int(), near.int(), rule


def narrow_phase(pair: ContactPair, kin, ksl, bp: BroadPhase,
                 consts: PairConstants, force, offsets, count=False,
                 sides=None):
    """Write one pair's force_i into ``force[:, off_i:off_i + Cp]`` and its
    force_t (reactions over 3) into ``force[:, off_t:off_t + Tp]``.

    ``kin`` (6, R) merged kinematics in the element dtype, ``ksl`` the
    pair's slices of it, ``bp`` its broad phase.  On the card one call is
    five kernels on the current stream: every in-range item is sorted into
    a spatial hash of its side, by its ddiv cell or, where the call's
    in-range triangles reach less than half of ddiv, by a finer cell sized
    to the radius cull's reach; then a warp per in-range item probes the
    other side's hash in the 27 cells around its own (``csrc/contact.cu``),
    in :func:`narrow_workspace`.  Either hash gives the same forces, bit
    for bit.  With ``count`` it returns :class:`NarrowCounts`: the
    accepted pairs per node slot (Cp,) and per triangle slot (Tp,), int32,
    as each side counted them, the candidates each item visited and those
    past the radius cull, and whether the call took the fine hash (on the
    CPU, the twin's, :func:`probe_counts_plain`); else None.  ``sides`` =
    (node side's, triangle side's) block-pair masks, by default both
    ``bp.pair_ok``; with them, only the items of blocks that have a set
    pair in their side's mask probe the other side (the rest find no
    candidate and write zeros)."""
    off_i, off_t = offsets
    if kin.device.type == "cpu":
        out = narrow_phase_plain(pair, kin, ksl, bp, consts, record=count,
                                 sides=sides)
        force[:, off_i:off_i + pair.Cp] = out[0]
        force[:, off_t:off_t + pair.Tp] = out[1]
        if count:
            hit = out[2]["pairs"]
            visits, near, rule = probe_counts_plain(pair, kin, ksl, bp,
                                                    consts, sides)
            return NarrowCounts(
                torch.bincount(hit[:, 1], minlength=pair.Cp).int(),
                torch.bincount(hit[:, 0], minlength=pair.Tp).int(),
                visits, near, rule.on)
        return None
    if kin.device.type != "cuda":
        raise ValueError(f"no narrow-phase kernel for device {kin.device}")
    entry = _NARROW.get(kin.dtype)
    if entry is None:
        raise TypeError(f"no narrow-phase kernel for {kin.dtype}")
    dt, R, W = kin.dtype, kin.shape[1], force.shape[1]
    F2, Ci = pair.tri_nodes.shape[1], pair.cand_nodes.shape[0]
    oks = (bp.pair_ok,) * 2 if sides is None else tuple(sides)
    # a rank's share lists only its own blocks' items (one device: all)
    lists = (None, None) if sides is None else (oks[0].any(dim=0),
                                                oks[1].any(dim=1))
    blocks = (pair.tri_chunks, pair.n_chunks)
    spec = {"kin": (kin, (6, R), dt), "force": (force, (3, W), dt),
            "tri_in": (bp.tri_in, (F2,), torch.bool),
            "node_in": (bp.node_in, (Ci,), torch.bool),
            "pair_ok (nodes)": (oks[0], blocks, torch.bool),
            "pair_ok (triangles)": (oks[1], blocks, torch.bool),
            "overlap": (bp.overlap, (), torch.bool),
            "all_min": (bp.all_min, (3,), dt),
            "cand_mass": (pair.cand_mass, (Ci,), dt),
            "cand_nodes": (pair.cand_nodes, (Ci,), torch.int32)}
    if pair.is_self:
        spec["tri_enodes"] = (pair.tri_enodes, (8, F2), torch.int32)
    _build.check_inputs(kin.device, spec)
    if max(off_i + pair.Cp, off_t + pair.Tp) > W:
        raise ValueError("pair force columns exceed the force buffer")
    iws, fws, B = narrow_workspace(F2, Ci, dt, kin.device)
    cols = pair.Cp + pair.Tp
    cnt = torch.empty(3 * cols, dtype=torch.int32,
                      device=kin.device) if count else None
    (t0, _), (t1, _), (t2, _), (cs, _), _ = ksl
    _build.launch(
        entry, kin.device, kin, R, t0, t1, t2, cs, F2, Ci, pair.tb, pair.nb,
        pair.tri_chunks, pair.n_chunks, bp.tri_in, bp.node_in, *oks, *lists,
        bp.overlap, bp.all_min, pair.cand_mass, pair.cand_nodes,
        pair.tri_enodes if pair.is_self else None, consts.young, consts.kc,
        consts.Cr, consts.myu, consts.d_lim, consts.ddiv, force, W, off_i,
        off_t, cnt, iws, fws, B)
    if not count:
        return None
    return NarrowCounts(cnt[:pair.Cp], cnt[pair.Cp:cols],
                        cnt[cols:2 * cols], cnt[2 * cols:],
                        iws[_header(B) + _RULE].clone() != 0)



def scatter_forces_plain(model: LoweredModel, force, out_dtype=None):
    """(3, N) nodal contact force from the (3, W) pair-force buffer: each
    node adds its table's first entries and subtracts the rest, in table
    order, in the buffer's dtype; stored in ``out_dtype``."""
    out_dtype = force.dtype if out_dtype is None else out_dtype
    ptr, mid, col = model.fs_ptr.long(), model.fs_mid.long(), \
        model.fs_col.long()
    count = ptr[1:] - ptr[:-1]
    acc = torch.zeros((3, model.N), dtype=force.dtype, device=force.device)
    for k in range(int(count.max()) if model.N else 0):
        rows = torch.nonzero(count > k).reshape(-1)
        e = ptr[rows] + k
        x = force[:, col[e]]
        a = acc[:, rows]
        acc[:, rows] = torch.where(e < mid[rows], a + x, a - x)
    return acc.to(out_dtype)


def scatter_forces(model: LoweredModel, force, out_dtype=None):
    """Kernel S: the (3, N) contact force from the pair-force buffer,
    summed in its dtype and stored in ``out_dtype`` (default: its dtype),
    in table order; the kernel reads the table as ``model.fs_sorted``."""
    out_dtype = force.dtype if out_dtype is None else out_dtype
    if force.device.type == "cpu":
        return scatter_forces_plain(model, force, out_dtype)
    if force.device.type != "cuda":
        raise ValueError(f"no scatter kernel for device {force.device}")
    entry = _SCATTER.get((force.dtype, out_dtype))
    if entry is None:
        raise TypeError(f"no scatter kernel for {force.dtype} -> "
                        f"{out_dtype}")
    N, W = model.N, model.fs_width
    _build.check_inputs(force.device, {
        "force": (force, (3, W), force.dtype),
        "fs_ptr": (model.fs_ptr, (N + 1,), torch.int32),
        "fs_mid": (model.fs_mid, (N,), torch.int32),
        "fs_sorted": (model.fs_sorted, tuple(model.fs_col.shape),
                      torch.int32)})
    out = torch.empty((3, N), dtype=out_dtype, device=force.device)
    _build.launch(entry, force.device, force, W, model.fs_ptr, model.fs_mid,
                  model.fs_sorted, model.fs_nb, model.fs_bits, model.fs_emax,
                  N, out)
    return out
