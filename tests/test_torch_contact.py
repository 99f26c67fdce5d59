"""Contact in the port against the JAX package, one force evaluation at a
time: the two-body cases of tests/test_contact.py with their analytic
checks, the erosion re-exposure and the self-contact exclusion, and the
plain versions of the gather and scatter kernels against the JAX pieces
they replace; and the narrow kernel's cull (a spatial hash of grid cells)
in its plain twin against the plain narrow phase."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hakai_tpu.config import ContactConfig, SolverConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.ops.contact import _pad_last, _pair_force
from hakai_tpu.ops.contact import contact_forces as jax_contact_forces
from hakai_tpu.ops.contact import contact_forces_pv as jax_forces_pv
from hakai_tpu.ops.contact import pair_activity as jax_pair_activity
from hakai_tpu.ops.gather_pallas import blocked_gather, plan_blocked_gather
from hakai_tpu.pre.synthetic import impact_model
from hakai_tpu_torch.core.lowering import model_from_numpy
from hakai_tpu_torch.core.state import init_state
from hakai_tpu_torch.ops.contact import (contact_forces, contact_forces_pv,
                                         pair_activity)
from hakai_tpu_torch.ops.contact_cuda import (_FINE_CELL, PairConstants,
                                              _sq3, cell_candidates_plain,
                                              constants_on, fine_rule_plain,
                                              kin_views, narrow_buckets,
                                              narrow_phase_plain,
                                              narrow_workspace,
                                              scatter_forces, tri_geometry)
from hakai_tpu_torch.ops.gather_cuda import gather_cols
from test_contact import _corner_node, two_body_model
from test_element import unit_cube_model
from test_torch_slice import jax_model_numpy

REL = 1e-12      # float64: the same formulas in another association order


def carried(jm, keep=None):
    """The port's model of a JAX lowering (float64 on the CPU); ``keep``
    selects the directional pairs to carry (all by default)."""
    fields, static = jax_model_numpy(jm)
    fields["pairs"] = [p for i, p in enumerate(fields["pairs"])
                       if keep is None or keep(jm.pairs[i])]
    return model_from_numpy(fields, static, "cpu")


def _check(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= REL * max(scale, 1e-300), \
        (np.abs(got - ref).max(), scale)


def _forces(m, cfg=None):
    jm = jax_lower(m, cfg or SolverConfig())
    tm = carried(jm)
    return jm, tm, np.asarray(jax_contact_forces(jm, jax_init_state(jm))), \
        contact_forces(tm, init_state(tm)).numpy()


def _slab_pair_force(m, velo=None):
    """The pair of upper-cube nodes against the slab's triangles alone, in
    both packages (tests/test_contact.py takes this pair's _pair_force)."""
    jm = jax_lower(m)
    js = jax_init_state(jm)
    if velo is not None:
        js = js.replace(velo=jnp.asarray(velo))
    pair = next(p for p in jm.pairs if p.j_instance == 0)
    ref = np.asarray(_pair_force(jm, pair, jm.coord + js.disp, js.velo,
                                 js.element_flag))
    tm = carried(jm, keep=lambda p: p.j_instance == 0)
    got = contact_forces_pv(tm, tm.coord.clone(), torch.as_tensor(
        np.array(js.velo)), tm.elem_exists).numpy()
    return ref, got


def test_penalty_force_magnitude():
    """A strictly interior penetrating node: F = young*S/Lmax*kc*d along
    +z, reactions -F/3 on the vertices; momentum sums to zero."""
    d = 0.01
    m = two_body_model(gap=-d, upper_shift=(0.1, 0.2))
    _, _, ref, got = _forces(m)
    _check(got, ref)
    np.testing.assert_allclose(got.sum(axis=1), 0.0, atol=1e-10)
    ref_p, got_p = _slab_pair_force(m)
    _check(got_p, ref_p)
    nid = _corner_node(m, [0.1, 0.2, 1 - d])
    expect = 100.0 * 0.125 / np.sqrt(0.5) * d
    np.testing.assert_allclose(got_p[:, nid], [0.0, 0.0, expect], atol=1e-12)


def test_friction_force_direction():
    """A sliding node: friction opposes the tangential relative velocity
    with |f| = myu*F."""
    d = 0.01
    m = two_body_model(gap=-d, upper_shift=(0.1, 0.2))
    nid = _corner_node(m, [0.1, 0.2, 1 - d])
    velo = np.zeros((3, jax_lower(m).N))
    velo[0, nid] = 3.0
    ref, got = _slab_pair_force(m, velo)
    _check(got, ref)
    F = 100.0 * 0.125 / np.sqrt(0.5) * d
    np.testing.assert_allclose(got[2, nid], F, atol=1e-12)
    np.testing.assert_allclose(got[0, nid], -0.25 * F, atol=1e-12)


@pytest.mark.parametrize("gap", [0.05, -0.2])
def test_no_force_when_separated_or_too_deep(gap):
    """Separated bodies, and a penetration deeper than d_lim = 0.3 *
    elementMinSize = 0.15: no force in either package."""
    _, _, ref, got = _forces(two_body_model(gap=gap))
    assert not ref.any() and not got.any()


def test_static_cull_and_engaged_offgrid():
    """An engaged off-grid configuration, lowered with the culled and with
    the full inventory: both packages, both lowerings agree."""
    m = two_body_model(gap=-0.02, upper_shift=(0.13, 0.07))
    _, tm, ref, got = _forces(m)
    assert all(p.static_activity for p in tm.pairs) and np.abs(ref).max() > 0
    _check(got, ref)
    _, tm, ref2, got2 = _forces(m, SolverConfig(
        contact=ContactConfig(static_cull=False)))
    assert not any(p.static_activity for p in tm.pairs)
    _check(got2, ref2)
    np.testing.assert_allclose(got2, got, rtol=1e-12, atol=1e-14)


def test_reexposure_after_deletion():
    """Deleting a slab element under a penetrating node: the activity
    masks equal JAX's bitwise, the dead element's triangles leave, its
    twins' faces appear, and the forces agree."""
    m = two_body_model(gap=-0.01, upper_shift=(0.13, 0.07), nx_low=2)
    jm = jax_lower(m, SolverConfig(contact=ContactConfig(static_cull=False)))
    tm = carried(jm)
    flag = np.asarray(jm.elem_exists).copy()
    flag[0] = False
    for jp, tp in zip(jm.pairs, tm.pairs):
        for a, b in zip(jax_pair_activity(jp, jnp.asarray(flag)),
                        pair_activity(tp, torch.as_tensor(flag))):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    pair = next(p for p in tm.pairs if p.j_instance == 0)
    tri = pair_activity(pair, torch.as_tensor(flag))[0].numpy()
    te, tw = pair.tri_elem.numpy(), pair.tri_twin.numpy()
    assert not tri[te == 0].any() and tri[(tw == 0) & (te != 0)].all()
    js = jax_init_state(jm)
    pos = jm.coord + js.disp
    ref = np.asarray(jax_forces_pv(jm, pos, js.velo, jnp.asarray(flag)))
    got = contact_forces_pv(tm, tm.coord.clone(), tm.velo0.clone(),
                            torch.as_tensor(flag)).numpy()
    assert np.abs(ref).max() > 0
    _check(got, ref)


def test_self_contact_excludes_own_element():
    """A self pair on an isolated cube: every node belongs to the elements
    of the triangles it could touch, so no force."""
    m = unit_cube_model()
    m.contact_flag = 2
    _, tm, ref, got = _forces(m)
    assert len(tm.pairs) == 1 and tm.pairs[0].is_self
    assert not ref.any() and not got.any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_plain_matches_blocked_gather(dtype):
    """gather_cols (CPU: its plain version) against blocked_gather, which
    on the CPU takes the XLA gather: bitwise, for a merged contact-style
    index list."""
    rng = np.random.default_rng(5)
    S = 4096
    src = rng.normal(size=(6, S)).astype(dtype)
    idx = np.concatenate([rng.integers(0, S, 3000), np.arange(100, 2148)])
    plan = plan_blocked_gather(idx, S)
    ref = np.asarray(blocked_gather(jnp.asarray(src), plan))
    got = gather_cols(torch.as_tensor(src),
                      torch.as_tensor(idx.astype(np.int32))).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def _jax_scatter(pair, force_i, force_t, N):
    """The JAX pair's force epilogue on given force_i/force_t
    (hakai_tpu/ops/contact.py:375-403, scatter-as-gather)."""
    Ci, F2 = pair.cand_nodes.shape[0], pair.tri_nodes.shape[1]
    fi = _pad_last(force_i[:, :Ci], pair.fgi_src)
    gi = blocked_gather(fi, pair.plan_fgi).reshape(3, -1, N)
    g = jnp.where(pair.fgi_mask[None], gi, 0.0).sum(axis=1)
    ft = _pad_last(force_t[:, :F2], pair.fgt_src)
    if pair.fgt_segmask is not None:
        c = blocked_gather(ft, pair.plan_fgt)
        for si, s in enumerate(pair.fgt_strides):
            sh = jnp.pad(c[:, s:], ((0, 0), (0, s)))
            c = c + jnp.where(pair.fgt_segmask[si][None], sh, 0.0)
        f_tn = blocked_gather(_pad_last(c, pair.fgt_k), pair.plan_pick)
        f_tn = jnp.where(pair.fgt_tnvalid[None], f_tn, 0.0)
    else:
        gt = blocked_gather(ft, pair.plan_fgt).reshape(3, pair.fgt_vl,
                                                       pair.fgt_n)
        f_tn = jnp.where(pair.fgt_mask[None], gt, 0.0).sum(axis=1)
    fx = blocked_gather(f_tn, pair.plan_fx)[:, :N]
    return g - jnp.where(pair.fx_mask[None], fx, 0.0)


def test_scatter_plain_matches_jax_epilogue():
    """The per-node force table (kernel S's plain version) against the JAX
    scatter-as-gather epilogue, summed over both pairs, on seeded force_i
    and force_t: 1e-14 normwise in float64.  Blocks of 128 triangles and
    32 nodes leave padding columns in the buffer."""
    jm = jax_lower(impact_model(n=3), SolverConfig(
        contact=ContactConfig(tri_block=128, node_block=32)))
    tm = carried(jm)
    rng = np.random.default_rng(11)
    force = torch.zeros((3, tm.fs_width), dtype=torch.float64)
    ref = np.zeros((3, tm.N))
    for jp, tp, (off_i, off_t) in zip(jm.pairs, tm.pairs, tm.fs_offsets):
        fi = rng.normal(size=(3, tp.cand_nodes.shape[0]))
        ft = rng.normal(size=(3, tp.tri_nodes.shape[1]))
        force[:, off_i:off_i + fi.shape[1]] = torch.as_tensor(fi)
        force[:, off_t:off_t + ft.shape[1]] = torch.as_tensor(ft)
        ref += np.asarray(_jax_scatter(jp, jnp.asarray(fi), jnp.asarray(ft),
                                       tm.N))
    got = scatter_forces(tm, force).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-14 * scale
    # padding columns are never read
    unread = torch.ones(tm.fs_width, dtype=torch.bool)
    unread[tm.fs_col.long()] = False
    assert 0 < int(unread.sum()) < tm.fs_width
    force[:, unread] = float("nan")
    np.testing.assert_array_equal(scatter_forces(tm, force).numpy(), got)


def test_pairs_and_tables_move_with_the_model():
    """LoweredModel.to carries the pairs and the contact tables; the
    kernels' input check names a tensor left on another device."""
    from hakai_tpu_torch import _build
    tm = carried(jax_lower(impact_model(n=2), SolverConfig()))
    moved = tm.to("meta")
    for p in moved.pairs:
        for f in dataclasses.fields(p):
            v = getattr(p, f.name)
            if isinstance(v, torch.Tensor):
                assert v.device.type == "meta", f.name
    assert moved.ckin_idx.device.type == moved.fs_col.device.type == \
        moved.fs_sorted.device.type == "meta"
    assert moved.fs_offsets == tm.fs_offsets and moved.pairs[0].tb == \
        tm.pairs[0].tb
    assert (moved.fs_nb, moved.fs_bits, moved.fs_emax) == (
        tm.fs_nb, tm.fs_bits, tm.fs_emax) and tm.fs_emax > 0
    with pytest.raises(ValueError, match="cand_mass is on cpu"):
        _build.check_inputs(torch.device("meta"), {
            "cand_mass": (tm.pairs[0].cand_mass,
                          tuple(tm.pairs[0].cand_mass.shape),
                          tm.pairs[0].cand_mass.dtype)})


def test_narrow_phase_counts_accepted_pairs():
    """narrow_phase's count option, which the check of the kernel against
    its plain version reads: the interior penetrating node of the penalty
    case is accepted once, both sides count the same pairs, and counting
    leaves the forces as they are."""
    from hakai_tpu_torch.ops.contact import broad_phase, contact_kinematics
    from hakai_tpu_torch.ops.contact_cuda import narrow_phase, pair_constants
    d = 0.01
    m = two_body_model(gap=-d, upper_shift=(0.1, 0.2))
    tm = carried(jax_lower(m))
    nid = _corner_node(m, [0.1, 0.2, 1 - d])
    kin = contact_kinematics(tm, tm.coord.clone(), tm.velo0.clone())
    forces = []
    for count in (True, False):
        force = torch.zeros((3, tm.fs_width), dtype=torch.float64)
        for i, p in enumerate(tm.pairs):
            c, ksl = pair_constants(tm, p), tm.ckin_slices[i]
            bp = broad_phase(p, kin, ksl, pair_activity(p, tm.elem_exists), c)
            out = narrow_phase(p, kin, ksl, bp, c, force, tm.fs_offsets[i],
                               count=count)
            if not count:
                assert out is None
                continue
            per_node, per_tri = out.node, out.tri
            assert per_node.shape == (p.Cp,) and per_tri.shape == (p.Tp,)
            assert per_node.dtype == per_tri.dtype == torch.int32
            assert int(per_node.sum()) == int(per_tri.sum())
            accepted = torch.cat([per_node, per_tri])
            assert out.visits.shape == out.near.shape == (p.Cp + p.Tp,)
            assert bool((out.visits >= out.near).all())
            assert bool((out.near >= accepted).all())
            assert out.fine.dtype == torch.bool and out.fine.dim() == 0
            if p.j_instance == 0:
                slot = int(torch.nonzero(p.cand_nodes == nid)[0, 0])
                assert int(per_node[slot]) == 1
        forces.append(force)
    assert torch.equal(forces[0], forces[1]) and forces[0].abs().max() > 0


def _state(deck):
    """(port model, state) of a CPU float64 deck for the cull tests: the
    penalty pair at rest, the off-grid n=4 impact 70 steps in (in contact,
    9 of 128 elements eroded), the self-contact plates 40 steps in."""
    from hakai_tpu_torch import SolverConfig as PortConfig
    from hakai_tpu_torch import lower, run_chunk
    from hakai_tpu_torch.pre import synthetic as tsyn
    from test_torch_contact_run import tie_free_impact
    if deck == "penalty":
        tm = carried(jax_lower(two_body_model(gap=-0.01,
                                              upper_shift=(0.1, 0.2))))
        return tm, init_state(tm)
    m, steps = ((tie_free_impact(tsyn, n=4, d_time=1e-8, end_time=1e-5), 70)
                if deck == "impact" else (tsyn.self_contact_model(), 40))
    tm = lower(m, PortConfig(dtype="float64"), device="cpu")
    return tm, run_chunk(tm, init_state(tm), steps)


@pytest.mark.parametrize("buckets", [None, 1])
@pytest.mark.parametrize("deck,world", [("penalty", 1), ("impact", 1),
                                        ("self", 1), ("impact", 2)])
def test_cell_candidates_match_plain(deck, world, buckets):
    """The narrow kernel's enumeration (its plain twin: each side's items
    probing the other side's spatial hash in the 27 cells around their
    own, exact cells only, within the side's block-pair mask) on the ddiv
    hash finds the plain narrow phase's pairs within one cell, each once:
    on the penalty pair, the eroded impact, the self-contact plates (own
    elements excluded) and a deal_block_pairs share of each of 2 ranks;
    with the shapes' buckets and with one bucket for all (every probe a
    collision).  On the hash the call's rule picks (the fine hash on the
    impact's cube triangles), each pair is found once, lies among those,
    and includes every one of them that passes the radius cull."""
    from hakai_tpu_torch.ops.contact import (broad_phase, contact_activity,
                                             contact_kinematics,
                                             deal_block_pairs)
    from hakai_tpu_torch.ops.contact_cuda import pair_constants
    tm, ts = _state(deck)
    if deck == "impact":
        assert 0 < int(ts.element_flag.sum()) < tm.n_element
    kin = contact_kinematics(tm, tm.coord + ts.disp, ts.velo)
    acts = contact_activity(tm, ts.element_flag)
    found = engaged = 0
    for i, p in enumerate(tm.pairs):
        ksl, c = tm.ckin_slices[i], pair_constants(tm, p)
        bp = broad_phase(p, kin, ksl, acts[i], c)
        for rank in range(world):
            sides = None if world == 1 else deal_block_pairs(bp.pair_ok,
                                                             rank, world)
            oks = (bp.pair_ok,) * 2 if sides is None else sides
            got = cell_candidates_plain(p, kin, ksl, bp, c, sides=sides,
                                        buckets=buckets, fine=False)
            ruled = cell_candidates_plain(p, kin, ksl, bp, c, sides=sides,
                                          buckets=buckets)
            fi, ft, info = narrow_phase_plain(p, kin, ksl, bp, c,
                                              record=True, sides=sides)
            ref = info["cell_pairs"]
            assert len(ref) == info["cell"]
            q0, q1, q2, _, pos_i, _, _ = kin_views(kin, ksl)
            ctr, rmax = tri_geometry(q0, q1, q2, constants_on(
                c, kin.dtype, kin.device))[:2]
            passing = ref[torch.sqrt(_sq3(pos_i[:, ref[:, 1]]
                                          - ctr[:, ref[:, 0]]))
                          < rmax[ref[:, 0]]]
            union = set()
            for pairs, fine_pairs, ok in zip(got, ruled, oks):
                want = ref[ok[ref[:, 0] // p.tb, ref[:, 1] // p.nb]]
                mine = set(map(tuple, pairs.tolist()))
                assert len(mine) == len(pairs)
                assert mine == set(map(tuple, want.tolist()))
                union |= mine
                fine_set = set(map(tuple, fine_pairs.tolist()))
                assert len(fine_set) == len(fine_pairs)
                assert fine_set <= mine
                keep = passing[ok[passing[:, 0] // p.tb,
                                  passing[:, 1] // p.nb]]
                assert set(map(tuple, keep.tolist())) <= fine_set
            assert union == set(map(tuple, ref.tolist()))
            if world == 1:
                assert len(got[0]) == len(got[1]) == info["cell"]
            found += info["cell"]
            engaged += bool(fine_rule_plain(kin, ksl, bp, c).on)
    assert found > 0
    assert engaged == (world if deck == "impact" else 0)


@pytest.mark.parametrize("shape,want", [
    ((0, 0), 64), ((5, 3), 64), ((1100, 7), 256),
    ((27648, 18818), 4096), ((14406, 1437696), 262144)])
def test_narrow_buckets(shape, want):
    """B of the narrow kernel's hashes: the least power of two above an
    eighth of the larger side (64 at least), from the shapes alone; the
    workspace of a shape, its dtype and device is allocated once: int32
    counters (zero), starts, the work list's 16-word header (its counter,
    the call's rule, the fine hash's R and E), a work list and two records
    an item, and 28 values a triangle, 8 a node and 4 an item of the
    element type: the fine hash shares the buckets and records of the ddiv
    hash and adds 12 header words."""
    assert narrow_buckets(*shape) == want == narrow_buckets(*shape[::-1])
    assert want & (want - 1) == 0 and want > max(shape) // 8
    iws, fws, B = narrow_workspace(*shape, torch.float64, torch.device("cpu"))
    tiles, items = max(1, B // 512), sum(shape)
    assert B == want and iws.dtype == torch.int32 and not iws.any()
    assert iws.numel() == 4 * B + 4 + -(-tiles // 4) * 4 + 16 + \
        -(-items // 4) * 4 + 8 * items
    assert fws.dtype == torch.float64 and fws.numel() == \
        32 * shape[0] + 12 * shape[1]
    again = narrow_workspace(*shape, torch.float64, torch.device("cpu"))
    assert again[0] is iws and again[1] is fws


def _pressed(deck):
    """(port model, its initial state) of a deck whose bodies overlap from
    the start, for the narrow kernel's rule: the impact at n = 4 and 16
    with its cube moved off the slab's grid and 0.005 into it, two unit
    cubes pressed together, the self-contact plates 0.01 into each other,
    and a 2x2x8 bar with self-contact."""
    from hakai_tpu_torch import SolverConfig as PortConfig
    from hakai_tpu_torch import lower
    from hakai_tpu_torch.pre import synthetic as tsyn
    if deck.startswith("impact"):
        m = tsyn.offset_instance(tsyn.impact_model(n=int(deck[6:])), 1,
                                 0.013, 0.017)
        inst = m.instances[1]
        part = m.parts[inst.part_id - 1]
        part.coordmat = part.coordmat - np.array([[0.0], [0.0], [0.055]])
        m.coordmat = m.coordmat.copy()
        m.coordmat[2, inst.node_offset:inst.node_offset + inst.n_node] -= \
            0.055
    elif deck == "two_body":
        m = two_body_model(gap=-0.02, upper_shift=(0.13, 0.07))
    elif deck == "self":
        m = tsyn.self_contact_model(gap=-0.01)
    else:
        m = tsyn.bar_model(2, 2, 8)
        m.contact_flag = 2
    tm = lower(m, PortConfig(dtype="float64"), device="cpu")
    return tm, init_state(tm)


@pytest.mark.parametrize("deck,want", [
    ("impact16", {(1, 0): True, (0, 1): True}),
    ("impact4", {(1, 0): False, (0, 1): True}),
    ("two_body", {(1, 0): False, (0, 1): False}),
    ("self", {(0, 0): False}), ("bar", {(0, 0): False})])
def test_fine_rule_per_pair(deck, want):
    """Which pairs the narrow kernel's rule sends to the fine hash (keyed
    by (node instance, triangle instance)): a pair whose in-range
    triangles reach at most about half of ddiv, which follows the model's
    largest element.  The impact's cube (0.6 / n) and its slab at n = 16
    (2 / 32 in plane) lie under the slab's 0.2 mm thickness (ddiv 0.22):
    fine; at n = 4 the slab's 0.25 triangles reach too far.  Uniform
    meshes (the unit cubes, the bar) and the self pairs (ddiv_scale_self
    0.6): ddiv cells.  Every pair overlaps, so the rule sees its items."""
    from hakai_tpu_torch.ops.contact import (broad_phase, contact_activity,
                                             contact_kinematics)
    from hakai_tpu_torch.ops.contact_cuda import pair_constants
    tm, ts = _pressed(deck)
    kin = contact_kinematics(tm, tm.coord + ts.disp, ts.velo)
    acts = contact_activity(tm, ts.element_flag)
    got = {}
    for i, p in enumerate(tm.pairs):
        ksl, c = tm.ckin_slices[i], pair_constants(tm, p)
        bp = broad_phase(p, kin, ksl, acts[i], c)
        assert bool(bp.overlap) and bool(bp.tri_in.any())
        rule = fine_rule_plain(kin, ksl, bp, c)
        got[(p.i_instance, p.j_instance)] = bool(rule.on)
        assert bool(rule.on) == bool(
            2 * _FINE_CELL * float(rule.reach) <= c.ddiv)
    assert got == want


def _random_pair(dtype, seed):
    """A stand-in pair of seeded random geometry for the fine hash's cull:
    triangles of three kinds (regular, needles a dozen times longer than
    wide, and near-degenerate ones whose third corner lies 1e-6 of an edge
    off the other two's line) with centroids snapped to fine-cell edges,
    and nodes random, on fine and ddiv cell edges, and just inside and
    outside each triangle's cull sphere along the axes and diagonals; ddiv
    2.3 fine cells, so the rule takes the fine hash."""
    from types import SimpleNamespace

    from hakai_tpu_torch.ops.contact_cuda import BroadPhase
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.rand(*shape, generator=g, dtype=torch.float64)
    T = 90
    size = 0.02 * (0.3 + rnd(T))
    e1 = torch.nn.functional.normalize(rnd(3, T) - 0.5, dim=0)
    e2 = torch.nn.functional.normalize(torch.linalg.cross(
        e1, rnd(3, T) - 0.5, dim=0), dim=0)
    kind = torch.arange(T) % 3
    length = torch.where(kind == 1, 12.0, 1.0) * size
    width = torch.where(kind == 2, 1e-6, 1.0) * size
    base = 0.2 + 0.6 * rnd(3, T)
    q0 = base
    q1 = base + length * e1
    q2 = base + 0.5 * length * e1 + torch.where(kind == 2, width, width) \
        * e2
    lo = torch.tensor([0.1, -0.05, 0.15], dtype=torch.float64)
    R = float(torch.sqrt(torch.stack([
        _sq3(q - ((q0 + q1) + q2) / 3) for q in (q0, q1, q2)]).amax()))
    h = 1.0625 * R
    ddiv = 2.3 * h
    # centroids of every other triangle onto a fine-cell edge
    ctr = ((q0 + q1) + q2) / 3
    snap = lo[:, None] + torch.round((ctr - lo[:, None]) / h) * h - ctr
    snap[:, 1::2] = 0.0
    q0, q1, q2 = q0 + snap, q1 + snap, q2 + snap
    ctr = ((q0 + q1) + q2) / 3
    rmax = torch.sqrt(torch.stack([_sq3(q - ctr) for q in (q0, q1, q2)])
                      .amax(dim=0))
    dirs = torch.cat([torch.eye(3), -torch.eye(3),
                      torch.nn.functional.normalize(
                          torch.tensor([[1.0, 1, 1], [1, -1, 1],
                                        [-1, 1, -1]]), dim=1).T.double().T],
                     dim=0).T                                   # (3, 9)
    shell = [ctr[:, :, None] + (rmax * f)[None, :, None] * dirs[:, None]
             for f in (1 - 1e-7, 1 + 1e-7, 0.999, 0.5)]
    nodes = [0.1 + 1.0 * rnd(3, 600),
             lo[:, None] + torch.round((0.2 + 0.6 * rnd(3, 200)) / h) * h,
             lo[:, None] + torch.round((0.2 + 0.6 * rnd(3, 200)) / ddiv)
             * ddiv] + [s.reshape(3, -1) for s in shell]
    pos = torch.cat(nodes, dim=1)
    C = pos.shape[1]
    kin = torch.cat([torch.cat([q0, q1, q2, pos], dim=1),
                     torch.zeros(3, 3 * T + C, dtype=torch.float64)]
                    ).to(dtype)
    ksl = ((0, T), (T, 2 * T), (2 * T, 3 * T), (3 * T, 3 * T + C), (0, 0))
    pair = SimpleNamespace(tb=T, nb=C, Cp=C, Tp=T, is_self=False)
    bp = BroadPhase(torch.ones(T, dtype=torch.bool),
                    torch.ones(C, dtype=torch.bool), lo.to(dtype),
                    torch.ones((1, 1), dtype=torch.bool),
                    torch.tensor(True))
    consts = PairConstants(young=1.0, kc=1.0, Cr=0.0, myu=0.0, d_lim=1.0,
                           ddiv=ddiv)
    return pair, kin, ksl, bp, consts


@pytest.mark.parametrize("seed", [3, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fine_hash_is_conservative(dtype, seed):
    """The fine hash drops only pairs that the radius cull rejects: on
    seeded random geometry (regular, stretched and near-degenerate
    triangles, items on fine and ddiv cell edges and on the edges of the
    cull spheres), every pair within one ddiv cell that passes the radius
    cull is among each side's fine-hash candidates, and every candidate
    lies within one ddiv cell; in float32 and float64."""
    from hakai_tpu_torch.ops.contact_cuda import _cells
    pair, kin, ksl, bp, consts = _random_pair(dtype, seed)
    rule = fine_rule_plain(kin, ksl, bp, consts)
    assert bool(rule.on)
    got = cell_candidates_plain(pair, kin, ksl, bp, consts)
    coarse = cell_candidates_plain(pair, kin, ksl, bp, consts, fine=False)
    q0, q1, q2, _, pos, _, _ = kin_views(kin, ksl)
    ctr, rmax = tri_geometry(q0, q1, q2, constants_on(
        consts, kin.dtype, kin.device))[:2]
    ddiv = torch.tensor(consts.ddiv, dtype=dtype)
    ct, cn = _cells(q0, bp.all_min, ddiv), _cells(pos, bp.all_min, ddiv)
    cell = ((ct[:, :, None] - cn[:, None, :]).abs() <= 1).all(dim=0)
    near = torch.sqrt(_sq3(pos[:, None, :] - ctr[:, :, None])) \
        < rmax[:, None]
    want = set(map(tuple, torch.nonzero(cell & near).tolist()))
    within = set(map(tuple, torch.nonzero(cell).tolist()))
    assert len(want) > 100
    assert len(got[0]) < len(coarse[0]) / 2
    for pairs in got:
        mine = set(map(tuple, pairs.tolist()))
        assert want <= mine <= within
