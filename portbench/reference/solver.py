"""A plain explicit hex8 solver: the benchmark's reference for what
``hakai_tpu_torch.run()`` computes on its decks.

Written from the equations of HAKAI's explicit solver (central
difference with a lumped mass, 8-point hex8 elements with a mean-dilatation
B-bar, hypoelastic stress with J2 radial return on a piecewise-linear
hardening curve, ductile erosion on the Gauss-point means, and penalty
node-to-triangle contact over all exterior faces with re-exposure), in
plain PyTorch on dense tensors, in deck order, with no padding, no
renumbering, no packing and no kernels.  It imports nothing of the
program.  The lowering (masses, boundary and initial conditions, faces,
triangles and contact candidates) is worked out again here from a
:class:`~portbench.reference.decks.Deck`.

Everything runs in one dtype (float64 by default) but contact, whose
accept tests run in the contact dtype: the element dtype the
configuration states (float32 for mixed), since a node that lies on a
triangle's edge to within rounding is accepted or not by the rounding.
Tensors are
element-major: positions (n, 3), element nodes (E, 8, 3), Gauss-point
fields (E, 8, ...), stress in Voigt order xx, yy, zz, xy, yz, xz.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .decks import DENSITY, DUCTILE, PLASTIC, POISSON, YOUNG, Deck

# HAKAI's contact constants (ContactConfig defaults of the deck's solver)
MYU, KC, CR, D_LIM_SCALE, DDIV_SCALE = 0.25, 1.0, 0.0, 0.3, 1.1
# the hex8 face node slots, as HAKAI's get_element_face lists them
FACE_SLOTS = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 5, 4],
                       [1, 2, 6, 5], [2, 3, 7, 6], [3, 0, 4, 7]])
# node-triangle pairs evaluated at once in the contact search
PAIR_BLOCK = 1 << 22
# the element dtype of each configured precision: contact's dtype
ELEMENT_DTYPE = {"float32": torch.float32, "mixed": torch.float32,
                 "float64": torch.float64}


def _sq3(x):
    """|x|^2 of (..., 3) rows, summed as (x0^2 + x1^2) + x2^2."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]


def shape_gradients() -> np.ndarray:
    """(8 Gauss points, 3 parent axes, 8 nodes) dN_i/dxi_a of the trilinear
    hex at the 2x2x2 points +-1/sqrt(3)."""
    corner = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                       [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                      float)
    g = 1.0 / np.sqrt(3.0)
    gp = np.array([[a, b, c] for a in (-g, g) for b in (-g, g)
                   for c in (-g, g)])
    out = np.zeros((8, 3, 8))
    for k, x in enumerate(gp):
        for i, c in enumerate(corner):
            f = 1.0 + x * c                       # (3,) factors
            for a in range(3):
                out[k, a, i] = 0.125 * c[a] * np.prod(np.delete(f, a))
    return out


@dataclass
class Pair:
    """One directional contact pair: side i's nodes against side j's
    triangles (global 0-based ids)."""
    tri: torch.Tensor          # (T, 3) triangle vertices
    tri_elem: torch.Tensor     # (T,) owner element
    tri_init: torch.Tensor     # (T,) bool initially exposed
    tri_twin: torch.Tensor     # (T,) element across the face, -1 none
    inodes: torch.Tensor       # (Ci,) candidate nodes of side i
    i_init: torch.Tensor
    i_owner: torch.Tensor      # (Ci, K) owners of its internal faces, -1
    jnodes: torch.Tensor       # (Cj,) surface nodes of side j
    j_init: torch.Tensor
    j_owner: torch.Tensor


def _instance_surface(coord, elem, inst):
    """Faces of one instance: (quads (F, 4) outward, owner (F,), twin
    (F,) -1 none, initially exposed (F,): the exterior ones)."""
    e0, ne = inst.elem_offset, inst.n_elem
    el = elem[:, e0:e0 + ne].T                              # (ne, 8)
    quads = el[:, FACE_SLOTS].reshape(-1, 4)
    owner = np.repeat(np.arange(e0, e0 + ne), 6)
    p = coord[:, quads]                                     # (3, F, 4)
    ctr = np.repeat(coord[:, el].mean(axis=2), 6, axis=1)
    nrm = np.cross((p[:, :, 1] - p[:, :, 0]).T, (p[:, :, 3] - p[:, :, 0]).T)
    inward = (nrm.T * (ctr - p[:, :, 0])).sum(axis=0) > 0.0
    quads[inward] = quads[inward][:, [0, 3, 2, 1]]
    _, inv, cnt = np.unique(np.sort(quads, axis=1), axis=0,
                            return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    exterior = cnt[inv] == 1
    twin = np.full(len(quads), -1, np.int64)
    order = np.argsort(inv, kind="stable")
    shared = order[cnt[inv][order] == 2]
    a, b = shared[0::2], shared[1::2]
    twin[a], twin[b] = owner[b], owner[a]
    init = exterior.copy()
    # HAKAI's surface loop stops one face short (j = 1:nE*6-1): the
    # instance's last face in deck order is never initially exposed
    init[-1] = False
    return quads, owner, twin, init


def _surface_nodes(quads, owner, twin, init):
    """(nodes, initially exposed, owners (C, K) of the internal faces
    that hold each node, -1 padded): a node becomes exposed when one of
    them dies."""
    internal = twin >= 0
    nodes = np.unique(quads[init | internal])
    node_init = np.isin(nodes, np.unique(quads[init]))
    rows = np.nonzero(internal)[0]
    pairs = np.concatenate([
        np.stack([quads[rows].reshape(-1),
                  np.repeat(owner[rows], 4)], axis=1),
        np.stack([quads[rows].reshape(-1),
                  np.repeat(twin[rows], 4)], axis=1)])
    pairs = np.unique(pairs, axis=0) if len(pairs) else pairs.reshape(0, 2)
    slot = np.searchsorted(nodes, pairs[:, 0])
    rank = np.arange(len(pairs)) - np.searchsorted(pairs[:, 0], pairs[:, 0])
    own = np.full((len(nodes), max(int(rank.max()) + 1 if len(rank) else 1,
                                   1)), -1, np.int64)
    own[slot, rank] = pairs[:, 1]
    return nodes, node_init, own


class Reference:
    """The lowered deck and its time loop."""

    def __init__(self, deck: Deck, device, dtype=torch.float64,
                 contact_dtype=torch.float64):
        self.deck, self.dev, self.dt_ = deck, torch.device(device), dtype
        self.cdt = contact_dtype
        coord, elem = deck.coord, deck.elem
        n, E = deck.n_node, deck.n_elem
        t = self._t
        self.coord = t(coord.T)                                 # (n, 3)
        self.elem = torch.as_tensor(elem.T.copy(), device=self.dev)  # (E,8)
        self.pus = t(shape_gradients())                         # (8, 3, 8)
        pos = coord[:, elem]                                    # (3, 8, E)
        J = np.einsum("kai,bie->ekab", shape_gradients(), pos)
        vol = np.linalg.det(J).sum(axis=1)
        mass = np.zeros(n)
        np.add.at(mass, elem.reshape(-1), np.tile(DENSITY * vol / 8.0, 8))
        self.mass = t(mass)[:, None]                            # (n, 1)
        edges = np.stack([np.linalg.norm(pos[:, 0] - pos[:, s], axis=0)
                          for s in (1, 3, 4)])
        self.min_size, self.max_size = float(edges.min()), float(edges.max())
        self.dt = float(deck.d_time)
        self.steps = int(np.floor(deck.end_time / self.dt))
        G = YOUNG / 2.0 / (1.0 + POISSON)
        self.G, self.lam = G, YOUNG * POISSON / ((1 + POISSON)
                                                 * (1 - 2 * POISSON))
        self.hard_eps = t(PLASTIC[:, 1])
        self.hard_slope = t(np.diff(PLASTIC[:, 0]) / np.diff(PLASTIC[:, 1]))
        # prescribed dofs: value * amplitude(t), the amplitude 1 if none
        held = np.zeros((n, 3), bool)
        held[deck.fixed_nodes] = True
        pulled = np.zeros((n, 3), bool)
        pulled[deck.pulled_nodes, 2] = True
        held &= ~pulled
        self.held = torch.as_tensor(held | pulled, device=self.dev)
        self.pulled = torch.as_tensor(pulled, device=self.dev)
        velo0 = np.zeros((n, 3))
        velo0[deck.ic_nodes, 2] = deck.ic_vz
        self.velo0 = t(velo0)
        self.pairs = self._contact() if deck.contact else []
        # the contact constants as 0-d tensors of the contact dtype
        self.cc = {k: torch.tensor(v, dtype=self.cdt, device=self.dev)
                   for k, v in dict(
                       young=YOUNG, kc=KC, Cr=CR, myu=MYU,
                       d_lim=self.min_size * D_LIM_SCALE,
                       ddiv=self.max_size * DDIV_SCALE, three=3.0, half=0.5,
                       two=2.0, one=1.0).items()}
        self.cmass = self.mass[:, 0].to(self.cdt)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               device=self.dev).to(self.dt_)

    # ----------------------------------------------------------- lowering
    def _contact(self):
        """Every directional pair of two instances (``contact_flag`` 1).
        A deck that puts an instance against itself (``contact_flag`` 2,
        or one instance with contact) raises: this reference has no self
        pair, and a configuration that needs one brings a reference of
        its own (``portbench/reference/<name>.py``)."""
        deck, dev = self.deck, self.dev
        if deck.contact_flag == 2 or len(deck.instances) == 1:
            name = deck.instances[0].name
            raise ValueError(
                f"{type(self).__name__}: the deck's contact_flag "
                f"{deck.contact_flag} over {len(deck.instances)} "
                f"instance(s) gives the self pair (0, 0), {name} against "
                f"itself, which this reference does not form")
        surf = [_instance_surface(deck.coord, deck.elem, inst)
                for inst in deck.instances]
        nodes = [_surface_nodes(*f) for f in surf]
        pairs = []
        for i in range(len(deck.instances)):
            for j in range(len(deck.instances)):
                if i == j:
                    continue
                quads, owner, twin, init = surf[j]
                tri = np.stack([quads[:, [0, 1, 2]], quads[:, [2, 3, 0]]],
                               axis=1).reshape(-1, 3)
                inodes, i_init, i_own = nodes[i]
                jnodes, j_init, j_own = nodes[j]
                g = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
                pairs.append(Pair(
                    tri=g(tri), tri_elem=g(np.repeat(owner, 2)),
                    tri_init=g(np.repeat(init, 2)),
                    tri_twin=g(np.repeat(twin, 2)), inodes=g(inodes),
                    i_init=g(i_init), i_owner=g(i_own), jnodes=g(jnodes),
                    j_init=g(j_init), j_owner=g(j_own)))
        return pairs

    # -------------------------------------------------------------- state
    def initial_state(self) -> dict:
        n, E, z = self.deck.n_node, self.deck.n_elem, self._zeros
        return dict(step=torch.zeros((), dtype=torch.long, device=self.dev),
                    disp=z(n, 3), disp_pre=-self.velo0 * self.dt,
                    velo=self.velo0.clone(), Q=z(n, 3), stress=z(E, 8, 6),
                    strain=z(E, 6), eq_ps=z(E, 8),
                    yield_s=torch.full((E, 8), PLASTIC[0, 0],
                                       dtype=self.dt_, device=self.dev),
                    triax=z(E, 8), contact=z(n, 3),
                    alive=torch.ones(E, dtype=torch.bool, device=self.dev))

    def state_of(self, f: dict) -> dict:
        """A state from deck-order arrays (``step``, nodal (n, 3) ``disp``,
        ``disp_pre``, ``velo``, ``Q``; ``stress`` (E, 8, 6), ``strain``
        (E, 6), ``eq_ps`` and ``yield_s`` (E, 8), ``alive`` (E,)), such as
        the program's own state at the start of a chunk."""
        s = {k: self._t(f[k]) for k in ("disp", "disp_pre", "velo", "Q",
                                        "stress", "strain", "eq_ps",
                                        "yield_s")}
        s["step"] = torch.tensor(int(f["step"]), device=self.dev)
        s["alive"] = torch.as_tensor(np.asarray(f["alive"], bool),
                                     device=self.dev)
        s["triax"] = self._zeros(self.deck.n_elem, 8)
        s["contact"] = self._zeros(self.deck.n_node, 3)
        return s

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dt_, device=self.dev)

    # ------------------------------------------------------------ physics
    def contact_force(self, pos, velo, alive):
        """(n, 3) penalty force of every directional pair on ``pos`` and
        ``velo`` (n, 3) with the life mask ``alive`` (E,), the pairs
        evaluated in the contact dtype."""
        out = torch.zeros_like(pos)
        pc, vc = pos.to(self.cdt), velo.to(self.cdt)
        for p in self.pairs:
            self._pair_force(p, pc, vc, alive, out)
        return out

    @staticmethod
    def _exposed(init, owners, alive):
        dead = (owners >= 0) & ~alive[owners.clamp_min(0)]
        return init | dead.any(dim=1)

    def _pair_force(self, p: Pair, pos, velo, alive, out):
        """Add one pair's forces to ``out`` (n, 3).  ``pos`` and ``velo``
        are in the contact dtype, and every accept test's operands are
        formed in it in one fixed association order, so that the tests
        take the same decisions as any implementation that evaluates the
        same formulas in that dtype on the same positions."""
        tri_on = ((p.tri_init | ((p.tri_twin >= 0)
                                 & ~alive[p.tri_twin.clamp_min(0)]))
                  & alive[p.tri_elem])
        i_on = self._exposed(p.i_init, p.i_owner, alive)
        j_on = self._exposed(p.j_init, p.j_owner, alive)
        if not (bool(tri_on.any()) and bool(i_on.any())
                and bool(j_on.any())):
            return
        pi, pj = pos[p.inodes[i_on]], pos[p.jnodes[j_on]]
        lo = torch.maximum(pi.amin(0), pj.amin(0))
        hi = torch.minimum(pi.amax(0), pj.amax(0))
        if not bool((lo <= hi).all()):
            return
        origin = torch.minimum(pi.amin(0), pj.amin(0))
        v = pos[p.tri]                                          # (T, 3, 3)
        tri_in = tri_on & ~((v < lo).all(dim=1).any(dim=1)
                            | (v > hi).all(dim=1).any(dim=1))
        pn = pos[p.inodes]
        node_in = i_on & ((pn >= lo) & (pn <= hi)).all(dim=1)
        ts = torch.nonzero(tri_in).reshape(-1)
        ns = p.inodes[torch.nonzero(node_in).reshape(-1)]
        if len(ts) == 0 or len(ns) == 0:
            return
        c = self.cc
        q0, q1, q2 = v[ts, 0], v[ts, 1], v[ts, 2]               # (t, 3)
        ctr = ((q0 + q1) + q2) / c["three"]
        rmax = torch.sqrt(torch.maximum(torch.maximum(
            _sq3(q0 - ctr), _sq3(q1 - ctr)), _sq3(q2 - ctr)))
        e1, e2 = q1 - q0, q2 - q0
        L1, L2 = torch.sqrt(_sq3(e1)), torch.sqrt(_sq3(e2))
        Lm = torch.maximum(L1, L2)
        cr = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                          e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                          e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], 1)
        mag = torch.sqrt(_sq3(cr))
        nrm = cr / torch.where(mag == 0, c["one"], mag)[:, None]
        d12 = (e1[:, 0] * e2[:, 0] + e1[:, 1] * e2[:, 1]) + e1[:, 2] * e2[:, 2]
        area = c["half"] * torch.sqrt(torch.clamp_min(
            (L1 * L1) * (L2 * L2) - d12 * d12, 0.0))
        kpen = ((c["young"] * area)
                / torch.where(Lm == 0, c["one"], Lm)) * c["kc"]
        # rows of the inverse of [e1 e2 -n]: (x1, x2, d) with
        # p - q0 = x1 e1 + x2 e2 - d n
        A = (e1, e2, -nrm)
        det = (((((A[0][:, 0] * A[1][:, 1]) * A[2][:, 2]
                  + (A[1][:, 0] * A[2][:, 1]) * A[0][:, 2])
                 + (A[2][:, 0] * A[0][:, 1]) * A[1][:, 2])
                - (A[0][:, 0] * A[2][:, 1]) * A[1][:, 2])
               - (A[1][:, 0] * A[0][:, 1]) * A[2][:, 2]) \
            - (A[2][:, 0] * A[1][:, 1]) * A[0][:, 2]
        sd = torch.where(det == 0, c["one"], det)[:, None]
        im = []
        for r in range(3):
            a1, a2 = A[(r + 1) % 3], A[(r + 2) % 3]
            im.append(torch.stack(
                [a1[:, 1] * a2[:, 2] - a2[:, 1] * a1[:, 2],
                 a2[:, 0] * a1[:, 2] - a1[:, 0] * a2[:, 2],
                 a1[:, 0] * a2[:, 1] - a2[:, 0] * a1[:, 1]], 1) / sd)
        cell_t = torch.ceil((q0 - origin) / c["ddiv"]).to(torch.int32)
        cell_n = torch.ceil((pos[ns] - origin) / c["ddiv"]).to(torch.int32)
        vj0 = velo[p.tri[ts, 0]]
        rows = max(1, PAIR_BLOCK // len(ts))
        for a in range(0, len(ns), rows):
            nb = ns[a:a + rows]
            x = pos[nb]                                         # (c, 3)
            near = ((cell_t[None] - cell_n[a:a + rows, None]).abs()
                    <= 1).all(dim=2)
            near &= torch.sqrt(_sq3(x[:, None] - ctr[None])) < rmax[None]
            i, k = torch.nonzero(near, as_tuple=True)
            if len(i) == 0:
                continue
            b = x[i] - q0[k]
            x1, x2, d = ((m[k, 0] * b[:, 0] + m[k, 1] * b[:, 1])
                         + m[k, 2] * b[:, 2] for m in im)
            ok = ((x1 >= 0) & (x2 >= 0) & (x1 + x2 <= 1) & (d > 0)
                  & (d <= c["d_lim"]))
            i, k, d = i[ok], k[ok], d[ok]
            F = kpen[k] * d
            n3 = nrm[k]
            vr = velo[nb[i]] - vj0[k]
            mv = torch.sqrt(_sq3(vr))
            ve = torch.where((mv > 0)[:, None],
                             vr / torch.where(mv == 0, c["one"], mv)[:, None],
                             0.0)
            dot = (ve[:, 0] * n3[:, 0] + ve[:, 1] * n3[:, 1]) \
                + ve[:, 2] * n3[:, 2]
            Cd = (c["two"] * torch.sqrt(self.cmass[nb[i]] * kpen[k])) \
                * c["Cr"]
            f = ((F[:, None] * n3 - (c["myu"] * F)[:, None]
                  * (ve - dot[:, None] * n3)) - Cd[:, None] * vr)
            f = f.to(out.dtype)
            out.index_add_(0, nb[i], f)
            for s in range(3):
                out.index_add_(0, p.tri[ts[k], s], -f / 3.0)

    def hardening(self, eq_ps):
        """Slope of the hardening curve at ``eq_ps``: the segment that holds
        it, the first for 0 and the last beyond the table."""
        seg = torch.zeros(eq_ps.shape, dtype=torch.long, device=self.dev)
        for e in self.hard_eps[1:-1]:
            seg += eq_ps > e
        return self.hard_slope[seg]

    def elements(self, x_new, du, s):
        """Element update on node positions ``x_new`` and increments ``du``
        (n, 3): (nodal internal force (n, 3), stress, strain, eq_ps, yield,
        triaxiality); dead elements give no force and no plastic flow.
        Gauss-point fields are (E, 8) components."""
        alive = s["alive"]
        pus24 = self.pus.reshape(24, 8)
        J = (pus24 @ x_new[self.elem]).view(-1, 8, 3, 3)      # dx_b/dxi_a
        Gd = (pus24 @ du[self.elem]).view(-1, 8, 3, 3)        # ddu_b/dxi_a
        j = [[J[..., a, b] for b in range(3)] for a in range(3)]
        cof = [[j[(a + 1) % 3][(b + 1) % 3] * j[(a + 2) % 3][(b + 2) % 3]
                - j[(a + 1) % 3][(b + 2) % 3] * j[(a + 2) % 3][(b + 1) % 3]
                for b in range(3)] for a in range(3)]
        det = j[0][0] * cof[0][0] + j[0][1] * cof[0][1] + j[0][2] * cof[0][2]
        inv = [[cof[b][a] / det for b in range(3)] for a in range(3)]
        # g[a][b] = d du_b / d x_a = sum_c inv[a][c] Gd[c][b]
        g = [[inv[a][0] * Gd[..., 0, b] + inv[a][1] * Gd[..., 1, b]
              + inv[a][2] * Gd[..., 2, b] for b in range(3)] for a in range(3)]
        w = det.abs()
        V = w.sum(dim=1, keepdim=True)
        tr = g[0][0] + g[1][1] + g[2][2]
        vbar = (w * tr).sum(dim=1, keepdim=True) / V / 3.0       # (E, 1)
        de = [g[0][0] - tr / 3 + vbar, g[1][1] - tr / 3 + vbar,
              g[2][2] - tr / 3 + vbar, g[0][1] + g[1][0], g[1][2] + g[2][1],
              g[0][2] + g[2][0]]
        G, lam = self.G, self.lam
        st = s["stress"]
        trial = [st[..., c] + lam * 3.0 * vbar + 2 * G * de[c]
                 for c in range(3)] + [st[..., c] + G * de[c]
                                       for c in range(3, 6)]
        mean = (trial[0] + trial[1] + trial[2]) / 3.0
        dev = [trial[0] - mean, trial[1] - mean, trial[2] - mean] + trial[3:]
        vm = torch.sqrt(1.5 * (dev[0] ** 2 + dev[1] ** 2 + dev[2] ** 2
                               + 2.0 * (dev[3] ** 2 + dev[4] ** 2
                                        + dev[5] ** 2)))
        y, H = s["yield_s"], self.hardening(s["eq_ps"])
        plastic = (vm > y) & alive[:, None]
        dep = torch.where(plastic, (vm - y) / (3.0 * G + H), 0.0)
        scale = torch.where(plastic, (y + H * dep)
                            / torch.where(vm == 0, 1.0, vm), 1.0)
        sig = [dev[c] * scale + (mean if c < 3 else 0.0) for c in range(6)]
        # force: sum over points of dN_i/dx_a X_ab, X the deviatoric part
        # of the point's stress plus the element's mean pressure (B-bar)
        sm = (sig[0] + sig[1] + sig[2]) / 3.0
        coef = w / V * (det * sm).sum(dim=1, keepdim=True) - det * sm
        X = [[det * sig[k] + (coef if a == b else 0.0)
              for b, k in enumerate(row)]
             for a, row in enumerate(((0, 3, 5), (3, 1, 4), (5, 4, 2)))]
        # M[c][b] = sum_a inv[a][c] X[a][b]; qe[i, b] = sum pus[k,c,i] M
        M = torch.stack([torch.stack([inv[0][c] * X[0][b] + inv[1][c] * X[1][b]
                                      + inv[2][c] * X[2][b]
                                      for b in range(3)], dim=-1)
                         for c in range(3)], dim=2)            # (E, 8, 3, 3)
        qe = pus24.T @ M.reshape(-1, 24, 3)                    # (E, 8, 3)
        qe = torch.where(alive[:, None, None], qe, 0.0)
        Q = torch.zeros_like(x_new).index_add_(
            0, self.elem.reshape(-1), qe.reshape(-1, 3))
        vm_f = torch.sqrt(0.5 * ((sig[0] - sig[1]) ** 2
                                 + (sig[1] - sig[2]) ** 2
                                 + (sig[0] - sig[2]) ** 2
                                 + 6.0 * (sig[3] ** 2 + sig[4] ** 2
                                          + sig[5] ** 2)))
        triax = torch.where(vm_f < 1e-10, 0.0,
                            sm / torch.where(vm_f == 0, 1.0, vm_f))
        strain = s["strain"] + torch.stack([d.mean(dim=1) for d in de], -1)
        return (Q, torch.stack(sig, dim=-1), strain, s["eq_ps"] + dep,
                y + H * dep, torch.where(alive[:, None], triax, 0.0))

    def fracture_strain(self, t_e):
        (f0, t0), (f1, t1) = DUCTILE[0, :2], DUCTILE[1, :2]
        inside = (t_e >= t0) & (t_e < t1)
        return torch.where(inside, f0 + (f1 - f0) / (t1 - t0) * (t_e - t0),
                           torch.full_like(t_e, DUCTILE[-1, 0]))

    def step(self, s: dict) -> dict:
        """One central-difference step of state ``s``; ``s["step"]`` is a
        0-d tensor, the steps done."""
        dt = self.dt
        k = s["step"] + 1
        pos = self.coord + s["disp"]
        fc = (self.contact_force(pos, s["velo"], s["alive"]) if self.pairs
              else torch.zeros_like(pos))
        disp = 2.0 * s["disp"] - s["disp_pre"] \
            + (fc - s["Q"]) * (dt * dt) / self.mass
        amp = k * dt / self.deck.ramp_end if self.deck.ramp_end else 1.0
        disp = torch.where(self.held, torch.where(
            self.pulled, self.deck.pull * amp, 0.0), disp)
        velo = (disp - s["disp"]) / dt
        Q, sig, strain, eq, y, triax = self.elements(
            self.coord + disp, disp - s["disp"], s)
        alive = s["alive"]
        if self.deck.ductile:
            t_e, v_e = triax.mean(dim=1), eq.mean(dim=1)
            dies = alive & (t_e >= 0) & (v_e >= self.fracture_strain(t_e))
            alive = alive & ~dies
            sig = torch.where(alive[:, None, None], sig, 0.0)
            strain = torch.where(alive[:, None], strain, 0.0)
        return dict(step=k, disp=disp, disp_pre=s["disp"], velo=velo, Q=Q,
                    stress=sig, strain=strain, eq_ps=eq, yield_s=y,
                    triax=triax, alive=alive, contact=fc)

    def run(self, state=None, steps=None) -> dict:
        """The state ``steps`` steps (default: to the deck's end) on from
        ``state`` (default: the initial state)."""
        s = self.initial_state() if state is None else state
        for _ in range(self.steps if steps is None else steps):
            s = self.step(s)
        return s


def node_fields(ref: Reference, s: dict) -> dict:
    """A frame's node fields: element means of the Gauss-point values,
    averaged over each node's elements (dead ones, zeroed, included), and
    the von Mises stress of the averaged stress."""
    n = ref.deck.n_node
    cnt = torch.zeros(n, dtype=ref.dt_, device=ref.dev).index_add_(
        0, ref.elem.reshape(-1), torch.ones(ref.elem.numel(), dtype=ref.dt_,
                                            device=ref.dev))

    def avg(e):                                     # (E, c) -> (n, c)
        acc = torch.zeros((n, e.shape[1]), dtype=ref.dt_, device=ref.dev)
        acc.index_add_(0, ref.elem.reshape(-1),
                       e[:, None, :].expand(-1, 8, -1).reshape(-1, e.shape[1]))
        return acc / cnt[:, None]

    st = avg(s["stress"].mean(dim=1))
    out = dict(stress=st, strain=avg(s["strain"]),
               eq_ps=avg(s["eq_ps"].mean(dim=1, keepdim=True))[:, 0],
               triax=avg(s["triax"].mean(dim=1, keepdim=True))[:, 0])
    sx, sy, sz, txy, tyz, txz = st.unbind(dim=1)
    out["mises"] = torch.sqrt(0.5 * ((sx - sy) ** 2 + (sy - sz) ** 2
                                     + (sx - sz) ** 2
                                     + 6.0 * (txy ** 2 + tyz ** 2
                                              + txz ** 2)))
    return out
