"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the fixture) where there is no
CUDA device.  The file imports only the port, so it runs on a GPU machine
with nvcc and without JAX (``--noconftest`` skips ``tests/conftest.py``,
which configures JAX):
    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

from hakai_tpu_torch import SolverConfig, _build, init_state, lower, run_chunk
from hakai_tpu_torch.ops.assemble_cuda import (assemble_internal_force,
                                               blocked_assemble,
                                               blocked_assemble_plain,
                                               plan_assemble)
from hakai_tpu_torch.ops.element import (assemble_internal_force_plain,
                                         element_core_packed_plain,
                                         element_core_plain,
                                         gather_element_nodes,
                                         neg_jacobian_count, triax_stress)
from hakai_tpu_torch.ops.element_cuda import (element_core_packed,
                                              element_update)
from hakai_tpu_torch.pre.synthetic import bar_model
from rank_workers import loop_entries

pytestmark = pytest.mark.cuda

# normwise kernel-vs-plain tolerance: same formulas, other association order
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the triaxiality mean/vm: a quotient with cancelling deviatoric
# differences, 10x the element bound
TRIAX_TOL = {torch.float32: 1e-4, torch.float64: 1e-11}


def _launched(fn, *args, **kw):
    """(``fn(*args, **kw)``, the kernel launches it made by C entry)."""
    before = _build.LAUNCHES.copy()
    out = fn(*args, **kw)
    return out, _build.LAUNCHES - before


def port_fast_model(deck, cfg, device="cpu"):
    """The port's lowering of ``deck`` with ``coord_e`` formed as the
    lowering forms it on meshes of 2,048 elements and more (f64
    difference, then the element dtype), so ``run_chunk`` takes the packed
    loop also on a smaller mesh (the twin of ``test_torch_slice.
    jax_fast_model``)."""
    m = lower(deck, cfg, device=device)
    coord, elem = m.coord.double(), m.elem.long()
    return dataclasses.replace(m, coord_e=(
        coord[:, elem] - coord[:, elem[0]][:, None, :]).to(m.edtype))


def erosion_free_impact():
    """The offset n=4 impact (its first contact within 100 steps) with its
    ductile table taken out: a contact deck whose ranks hoist the life
    mask once a chunk."""
    from hakai_tpu_torch.pre.synthetic import impact_model, offset_instance
    m = offset_instance(impact_model(n=4, v0=2e5, d_time=1e-8,
                                     end_time=1e-6), 1, 0.013, 0.017)
    for mt in m.materials:
        mt.ductile, mt.fracture_flag = np.zeros((0, 3)), 0
    return m


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    E, N = m.E, m.N
    disp = rng.normal(scale=1e-3, size=(3, N))
    P = np.concatenate([rng.normal(scale=300.0, size=(48, E)),
                        rng.normal(scale=1e-3, size=(6, E)), np.zeros((2, E)),
                        rng.uniform(0.0, 0.3, (8, E)),
                        755.0 + rng.uniform(0.0, 300.0, (8, E))])
    flag = m.elem_exists.clone()
    flag[1] = False

    def t(a, dt):
        return torch.as_tensor(a, device=m.device).to(dt).contiguous()
    return (t(P, m.edtype), flag, t(disp, m.dtype),
            t(disp + rng.normal(scale=2e-4, size=(3, N)), m.dtype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_element_kernel_matches_plain(cuda, dtype):
    m = lower(bar_model(8, 8, 32), SolverConfig(dtype=dtype, elem_pad=4096),
              device=cuda)
    args = _inputs(m, 1)
    (Pk, qk), n = _launched(element_core_packed, m, *args)
    Pp, qp = element_core_packed_plain(m, *args)
    assert n == {loop_entries(m, False)[0]: 1}
    assert _rel(Pk, Pp) <= TOL[m.dtype] and _rel(qk, qp) <= TOL[m.dtype]
    assert not Pk[54:56].any() and not qk[:, ~args[1]].any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_assembly_kernel_matches_plain(cuda, dtype):
    m = lower(bar_model(8, 8, 32), SolverConfig(dtype=dtype), device=cuda)
    qe = torch.randn(24, m.E, dtype=m.dtype, device=cuda)
    Q = assemble_internal_force(m, qe)
    assert _rel(Q, assemble_internal_force_plain(m, qe)) <= TOL[m.dtype]
    assert torch.equal(Q, assemble_internal_force(m, qe))   # no atomics


def node_block_grouping(inc_idx, inc_mask, r_tile):
    """The incidence table (V, N), padded with masked entries to whole
    tiles of nodes, as node-block-major (nblk, V, r_tile) rows: output
    tile b sums its V slot tiles in the order v = 0..V-1."""
    V, N = inc_idx.shape
    nblk = -(-N // r_tile)
    idx = np.zeros((V, nblk * r_tile), np.int64)
    mask = np.zeros((V, nblk * r_tile), bool)
    idx[:, :N], mask[:, :N] = inc_idx, inc_mask
    return (idx.reshape(V, nblk, r_tile).transpose(1, 0, 2).reshape(-1),
            mask.reshape(V, nblk, r_tile).transpose(1, 0, 2).reshape(-1))


@pytest.mark.parametrize("dtype", ["float32", "float64", "mixed"])
def test_grouped_assembly_matches_kernel_b(cuda, dtype):
    """The grouped entry (TPU kernels #9/#10) on the node-block-major
    grouping of the incidence table: bitwise kernel B's Q, within the
    assembly tolerance of its plain version, and what a model carrying
    the plan assembles with, one grouped launch and no kernel B launch."""
    m = lower(bar_model(8, 8, 32), SolverConfig(dtype=dtype), device=cuda)
    V, N, E = m.inc_idx.shape[0], m.N, m.E
    idx, mask = node_block_grouping(m.inc_idx.cpu().numpy(),
                                    m.inc_mask.cpu().numpy(), 2048)
    plan = plan_assemble(idx, mask, 8 * E, V).to(cuda)
    qe = torch.randn(24, E, dtype=m.edtype, device=cuda)
    src = qe.reshape(3, 8 * E)
    got = blocked_assemble(src, plan, m.dtype)[:, :N]
    assert got.dtype == m.dtype
    assert torch.equal(got, assemble_internal_force(m, qe, m.dtype))
    plain = blocked_assemble_plain(src, plan).to(m.dtype)[:, :N]
    assert _rel(got, plain) <= TOL[m.edtype]
    grouped = dataclasses.replace(m, plan_asm=plan)
    Q, n = _launched(assemble_internal_force, grouped, qe, m.dtype)
    assert torch.equal(Q, got)
    assert n == {{"float32": "hk_blocked_assemble_f32",
                  "float64": "hk_blocked_assemble_f64",
                  "mixed": "hk_blocked_assemble_f32_f64"}[dtype]: 1}


# the element arrays of a lowered model (last axis E)
ELEMENT_FIELDS = ("elem", "elem_exists", "coord_e", "mat_id", "G_e", "lam_e",
                  "has_plastic_e", "yield0_e", "vol_e")


def first_elements(m, E):
    """``m`` cut to its first ``E`` element lanes, the nodes kept."""
    return dataclasses.replace(m, E=E, **{
        f: getattr(m, f)[..., :E].contiguous() for f in ELEMENT_FIELDS})


def _cut(x, E):
    return x[..., :E].contiguous()


@pytest.mark.parametrize("E", [1, 31, 32, 33, 4096])
@pytest.mark.parametrize("dtype", ["float32", "float64", "mixed"])
@pytest.mark.parametrize("entry", ["packed", "unpacked"])
def test_element_kernel_at_tile_edges(cuda, entry, dtype, E):
    """Each entry of the element kernel, with and without the triaxiality
    output, at E = 1, one below, at and one above a multiple of its
    32-element tile, and at 4,096 lanes of which 2,048 pad the 8x8x32 bar:
    within the element bounds of its plain version, its lanes bitwise those
    of a launch over the whole mesh, a second launch bitwise the first, and
    no force on dead or padding lanes."""
    m = port_fast_model(bar_model(8, 8, 32, ductile=True),
                        SolverConfig(dtype=dtype, elem_pad=4096), cuda)
    assert m.E == 4096 and int(m.elem_exists.sum()) == 2048
    mc = first_elements(m, E)
    for want_triax in (False, True):
        if entry == "packed":
            P, flag, disp, dprev = _inputs(m, 5)
            args = (_cut(P, E), _cut(flag, E), disp, dprev)
            outs = [element_core_packed(mc, *args, want_triax=want_triax)
                    for _ in range(2)]
            whole = element_core_packed(m, P, flag, disp, dprev,
                                        want_triax=want_triax)
            ref = element_core_packed_plain(mc, *args, want_triax)
            qe = outs[0][1]
        else:
            u = _update_inputs(m, 5)
            flag = u[-1]
            uc = u[:2] + tuple(_cut(x, E) for x in u[2:])
            outs = [element_update(mc, *uc, want_triax=want_triax)
                    for _ in range(2)]
            whole = element_update(m, *u, want_triax=want_triax)
            pos_e, du = gather_element_nodes(mc, uc[0], uc[1])
            res = element_core_plain(mc, pos_e, du, *uc[2:])
            ref = (res, triax_stress(res.stress)) if want_triax else res

            def fields(x):   # Qe, stress, strain, eq_ps, yield_s[, triax]
                return (list(x[0][:5]) + [x[1]]) if want_triax else \
                    list(x[:5])
            outs, whole, ref = [fields(o) for o in outs], fields(whole), \
                fields(ref)
            qe = outs[0][0]
        tols = [TOL[m.edtype]] * (len(ref) - want_triax) \
            + [TRIAX_TOL[m.edtype]] * want_triax
        for a, b, w, r, tol in zip(*outs, whole, ref, tols):
            assert a.dtype == r.dtype == m.edtype and a.shape == r.shape
            assert torch.equal(a, b) and torch.equal(a, _cut(w, E))
            assert _rel(a, r) <= tol
        assert not qe[..., ~_cut(flag, E)].any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_element_kernel_reads_large_tables_from_memory(cuda, dtype):
    """A hardening table too large for the kernel's shared-memory staging
    (2 KB; here its columns padded to 300, its rows unchanged) is read
    from device memory instead, with the same bits, in both entries."""
    m = port_fast_model(bar_model(8, 8, 32),
                        SolverConfig(dtype=dtype, elem_pad=4096), cuda)
    pad = 300 - m.hard_strain.shape[1]
    big = dataclasses.replace(
        m, hard_strain=torch.nn.functional.pad(m.hard_strain, (0, pad)),
        hard_slope=torch.nn.functional.pad(m.hard_slope, (0, pad)))
    args, u = _inputs(m, 6), _update_inputs(m, 6)
    for a, b in zip(element_core_packed(m, *args, want_triax=True),
                    element_core_packed(big, *args, want_triax=True)):
        assert torch.equal(a, b)
    ra, ta = element_update(m, *u, want_triax=True)
    rb, tb = element_update(big, *u, want_triax=True)
    assert torch.equal(ta, tb)
    assert all(torch.equal(a, b) for a, b in zip(ra, rb))
    assert (args[0][56:64] != element_core_packed(m, *args)[0][56:64]).any()


def incidence(V, N, E, masked, seed):
    """A random (V, N) incidence table into 8E columns with a share
    ``masked`` of its slots masked, a masked slot's index far out of range
    (the kernel must not load it), and one node with every slot masked."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 8 * E, size=(V, N))
    mask = rng.random((V, N)) >= masked
    mask[:, 7] = False
    return np.where(mask, idx, 1 << 30).astype(np.int32), mask


@pytest.mark.parametrize("V", [1, 8, 11])
@pytest.mark.parametrize("types", [("float32", "float32"),
                                   ("float64", "float64"),
                                   ("float32", "float64")])
def test_assembly_kernel_on_synthetic_tables(cuda, V, types):
    """Kernel B on random incidence tables of V = 1, 8 (the hex meshes')
    and 11 (above the 8 slots a thread has in flight at once), a quarter
    of the slots masked, over N = 1,000 columns (a ragged last block):
    on integer forces (exact sums) bitwise the float64 sum in slot order,
    rounded; on random forces bitwise a sum in slot order in the force
    type; bitwise equal on a second launch; and, as the grouped entry on
    the node-block-major grouping of the table, bitwise kernel B."""
    qdt, odt = (getattr(torch, t) for t in types)
    m = lower(bar_model(4, 4, 16), SolverConfig(dtype=types[0]), device=cuda)
    N, E = 1000, m.E
    idx, mask = incidence(V, N, E, 0.25, V)
    mg = dataclasses.replace(m, N=N, inc_idx=torch.as_tensor(idx, device=cuda),
                             inc_mask=torch.as_tensor(mask, device=cuda))
    rng = np.random.default_rng(V + 1)
    q_int = rng.integers(-1024, 1025, size=(24, E)).astype(np.float64)
    want = np.where(mask[None], q_int.reshape(3, 8 * E)[:, np.where(
        mask, idx, 0)], 0.0).sum(axis=1)
    got = assemble_internal_force(mg, torch.as_tensor(q_int, device=cuda)
                                  .to(qdt), odt)
    assert got.dtype == odt
    assert torch.equal(got, torch.as_tensor(want, device=cuda).to(odt))
    qe = torch.as_tensor(rng.normal(scale=100.0, size=(24, E)),
                         device=cuda).to(qdt)
    Q = assemble_internal_force(mg, qe, odt)
    assert torch.equal(Q, assemble_internal_force(mg, qe, odt))
    qf, safe = qe.reshape(3, 8 * E), torch.as_tensor(
        np.where(mask, idx, 0), device=cuda).long()
    acc = torch.zeros((3, N), dtype=qdt, device=cuda)
    for v in range(V):
        acc = acc + torch.where(mg.inc_mask[v], qf[:, safe[v]], 0.0)
    assert torch.equal(Q, acc.to(odt))
    gi, gm = node_block_grouping(np.where(mask, idx, 0), mask, 256)
    plan = plan_assemble(gi, gm, 8 * E, V, 256).to(cuda)
    assert torch.equal(blocked_assemble(qf, plan, odt)[:, :N], Q)


def test_wrappers_refuse_wrong_inputs(cuda):
    m = port_fast_model(bar_model(4, 4, 16), SolverConfig(dtype="float32"),
                        cuda)
    P, flag, disp, dprev = _inputs(m, 2)
    with pytest.raises(TypeError):
        element_core_packed(m, P.double(), flag, disp, dprev)
    with pytest.raises(ValueError):
        element_core_packed(m, P[:, :8], flag, disp, dprev)
    with pytest.raises(ValueError):
        assemble_internal_force(m, torch.zeros(24, m.E + 8, device=cuda))
    with pytest.raises(ValueError, match="coord_e"):
        element_core_packed(dataclasses.replace(m, coord_e=None), P, flag,
                            disp, dprev)
    u = _update_inputs(m, 2)
    with pytest.raises(TypeError):
        element_update(m, u[0].double(), *u[1:])
    with pytest.raises(ValueError):
        element_update(m, *u[:2], u[2][..., :8], *u[3:])


def _update_inputs(m, seed):
    """(position, d_disp, stress, strain, eq_ps, yield_s, flag) for the
    unpacked entry, in the element dtype, from :func:`_inputs`."""
    P, flag, disp, dprev = _inputs(m, seed)
    E, edt = m.E, m.edtype
    return ((m.coord + disp).to(edt), (disp - dprev).to(edt),
            P[:48].reshape(6, 8, E).contiguous(), P[48:54].contiguous(),
            P[56:64].contiguous(), P[64:72].contiguous(), flag)


@pytest.mark.parametrize("dtype", ["float32", "float64", "mixed"])
@pytest.mark.parametrize("want_triax", [False, True])
def test_element_update_kernel_matches_plain(cuda, dtype, want_triax):
    """The unpacked entry (TPU kernel #3, the generic step's) against its
    plain version on the 8x8x32 bar with 2,048 padding lanes: every output
    within the element bounds, dead and padding lanes without force, the
    launch counted by its C entry, no negative-Jacobian count without a
    metrics stream."""
    m = lower(bar_model(8, 8, 32), SolverConfig(dtype=dtype, elem_pad=4096,
                                                gather_mode="xla"),
              device=cuda)
    assert m.coord_e is None and m.E == 4096
    u = _update_inputs(m, 4)
    out, n = _launched(element_update, m, *u, want_triax=want_triax)
    pos_e, du = gather_element_nodes(m, u[0], u[1])
    ref = element_core_plain(m, pos_e, du, *u[2:])
    res = out[0] if want_triax else out
    assert n == {loop_entries(m, True)[0]: 1}
    assert int(res.neg_jacobian) == 0
    for name in ("Qe", "stress", "strain", "eq_ps", "yield_s"):
        a, b = getattr(res, name), getattr(ref, name)
        assert a.dtype == b.dtype == m.edtype and a.shape == b.shape, name
        assert _rel(a, b) <= TOL[m.edtype], name
    assert not res.Qe[..., ~u[-1]].any()
    if want_triax:
        assert _rel(out[1], triax_stress(ref.stress)) <= TRIAX_TOL[m.edtype]


def _bench_bar_counting(cuda, dtype, tmp_path, stream=True):
    """The bench bar (32x32x128) lowered for the generic step, with a
    metrics stream configured (the path is never opened here)."""
    m = lower(bar_model(32, 32, 128), SolverConfig(
        dtype=dtype, gather_mode="xla", metrics_path=str(
            tmp_path / "m.jsonl") if stream else None), device=cuda)
    assert m.coord_e is None and m.node_new2old is None
    return m


def _count_inputs(m, seed, invert):
    """:func:`_update_inputs` with, when ``invert``, the bar's four top
    corners pushed 1 mm down, through their elements (0.39 mm high)."""
    u = list(_update_inputs(m, seed))
    if invert:
        top = [((i * 33) + j) * 129 + 128 for i in (0, 32) for j in (0, 32)]
        pos = u[0].clone()
        pos[2, top] -= 1.0
        u[0] = pos
    return u


def _plain_count(m, u):
    return int(neg_jacobian_count(m, u[0][:, m.elem], u[-1]))


@pytest.mark.parametrize("invert", [True, False], ids=["inverted", "clean"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_count_matches_plain(cuda, dtype, invert, tmp_path):
    """With a metrics stream the unpacked entry counts the negative
    Jacobians itself (one launch of its C entry): equal to the
    plain count on the bench bar, clean and with inverted corners, eager
    and through replays of a captured graph, which zero the count each
    time (the inverted state replayed twice counts the same)."""
    m = _bench_bar_counting(cuda, dtype, tmp_path)
    u = _count_inputs(m, 5, invert)
    want = _plain_count(m, u)
    assert (want > 0) == invert
    (res, tri), n = _launched(element_update, m, *u, want_triax=True)
    assert n == {loop_entries(m, True)[0]: 1} and tri.shape == (8, m.E)
    assert res.neg_jacobian.dtype == torch.int32
    assert int(res.neg_jacobian) == want
    other = _count_inputs(m, 6, not invert)
    static = [x.clone() for x in u]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out, _ = element_update(m, *static, want_triax=True)
    for x in (u, other, u, u):
        for s, v in zip(static, x):
            s.copy_(v)
        g.replay()
        torch.cuda.synchronize()
        assert int(out.neg_jacobian) == _plain_count(m, x)
    assert torch.equal(out.Qe, res.Qe)


def test_no_count_without_a_stream(cuda, tmp_path):
    """Without a metrics stream the unpacked entry is launched (once, the
    entry a stream's launch takes) without a count: the count reads 0
    with inverted corners; the outputs equal the counting launch's."""
    m = _bench_bar_counting(cuda, "float32", tmp_path, stream=False)
    u = _count_inputs(m, 5, True)
    (res, tri), n = _launched(element_update, m, *u, want_triax=True)
    assert n == {"hk_element_update_f32": 1}
    assert int(res.neg_jacobian) == 0 and _plain_count(m, u) > 0
    mc = _bench_bar_counting(cuda, "float32", tmp_path)
    rc, tc = element_update(mc, *u, want_triax=True)
    assert int(rc.neg_jacobian) == _plain_count(m, u)
    for name in ("Qe", "stress", "strain", "eq_ps", "yield_s"):
        assert torch.equal(getattr(rc, name), getattr(res, name)), name
    assert torch.equal(tc, tri)


def test_packed_entries_resources_unchanged(cuda):
    """The packed instantiations the chunk loop runs, f32 and mixed, with
    and without triaxiality, hold the kernel table's 64 registers and 4
    blocks an SM without spills: the count's template flag left them as
    they were.  The unpacked entries' with the count are printed."""
    from hakai_tpu_torch import _build
    m = lower(bar_model(8, 8, 32, ductile=True), SolverConfig(), device=cuda)
    M, W = m.hard_strain.shape
    for which in (0, 2, 5, 7):
        r = _build.resources("hk_element_resources", which, M, W)
        assert (r["registers"], r["blocks"], r["local"]) == (64, 4, 0), \
            (which, r)
    for which in (3, 8, 10, 12, 4, 9, 11, 13):
        print(which, _build.resources("hk_element_resources", which, M, W))


@pytest.mark.parametrize("loop", ["generic", "packed"])
def test_run_chunk_card_matches_cpu_f64(cuda, loop):
    """The 4x4x16 bar (below 2,048 elements: the generic step; with
    port_fast_model the packed loop) for 50 plastic f64 steps on the card
    and on the CPU."""
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4)
    cfg = SolverConfig(dtype="float64")
    low = lower if loop == "generic" else port_fast_model
    mg, mc = low(bar, cfg, device=cuda), low(bar, cfg, device="cpu")
    assert (mg.coord_e is None) == (loop == "generic")
    g = run_chunk(mg, init_state(mg), 50)
    c = run_chunk(mc, init_state(mc), 50)
    assert c.eq_ps.max() > 0
    for name in ("disp", "velo", "stress", "eq_ps", "yield_s", "triax"):
        assert _rel(getattr(g, name).cpu(), getattr(c, name)) <= 1e-10, name


@pytest.mark.parametrize("dtype", ["float32", "float64", "mixed"])
def test_element_kernel_triax_matches_plain(cuda, dtype):
    """Every instantiation with the triaxiality output (mixed: float64
    disp/dprev, float32 math), against the plain twin."""
    m = lower(bar_model(8, 8, 32, ductile=True),
              SolverConfig(dtype=dtype, elem_pad=4096), device=cuda)
    args = _inputs(m, 3)
    (Pk, qk, tk), n = _launched(element_core_packed, m, *args,
                                want_triax=True)
    Pp, qp, tp = element_core_packed_plain(m, *args, want_triax=True)
    assert n == {loop_entries(m, False)[0]: 1}
    assert Pk.dtype == qk.dtype == tk.dtype == m.edtype
    assert tk.shape == (8, m.E)
    assert _rel(Pk, Pp) <= TOL[m.edtype] and _rel(qk, qp) <= TOL[m.edtype]
    assert _rel(tk, tp) <= TRIAX_TOL[m.edtype]


def test_mixed_assembly_stores_float64(cuda):
    """Mixed precision: the float32 sum is stored as float64, with the bits
    of the float32 kernel's sum cast afterwards."""
    m = lower(bar_model(8, 8, 32), SolverConfig(dtype="mixed"), device=cuda)
    qe = torch.randn(24, m.E, dtype=torch.float32, device=cuda)
    Q = assemble_internal_force(m, qe, torch.float64)
    assert Q.dtype == torch.float64 and Q.shape == (3, m.N)
    assert torch.equal(Q, assemble_internal_force(m, qe).double())
    assert _rel(Q, assemble_internal_force_plain(m, qe).double()) <= 1e-6


def _impact(dtype, device, steps=90, ductile=True, n=4):
    """The tie-free impact (cube off the slab's grid lines) lowered on
    ``device`` and stepped past its first contact: n=4 at d_time 1e-8
    (contact at step ~63), n=12 at 4e-9 (its cfl_dt is 8.3e-9; contact at
    step 158)."""
    from hakai_tpu_torch.pre.synthetic import impact_model, offset_instance
    deck = offset_instance(impact_model(n=n, v0=8.0e4,
                                        d_time=1e-8 if n == 4 else 4e-9,
                                        end_time=1e-5), 1, 0.013, 0.017)
    if not ductile:
        deck.materials[0].ductile = np.zeros((0, 3))
    m = lower(deck, SolverConfig(dtype=dtype), device=device)
    return m, run_chunk(m, init_state(m), steps)


@pytest.mark.parametrize("n,steps,dtype", [
    (4, 90, "mixed"), (4, 90, "float64"),
    (12, 190, "mixed"), (12, 190, "float64")])
def test_contact_kernels_match_plain(cuda, n, steps, dtype):
    """Kernels G, N and S against their plain versions on a state in
    contact: the gather bitwise; the narrow phase as a step launches it
    with forces within the element bounds, every node's and every
    triangle's accepted pairs equal to the plain version's (the deck has
    no ties), its visited candidates, those past the radius cull and its
    rule equal to its plain twin's (the n = 12 deck takes the fine hash on
    a pair at least), bitwise repeatable and unchanged by counting; the
    scatter within the assembly's bounds."""
    from hakai_tpu_torch.ops.contact import (broad_phase, contact_activity,
                                             contact_kinematics)
    from hakai_tpu_torch.ops.contact_cuda import (narrow_phase,
                                                  narrow_phase_plain,
                                                  pair_constants,
                                                  probe_counts_plain,
                                                  scatter_forces,
                                                  scatter_forces_plain)
    from hakai_tpu_torch.ops.gather_cuda import gather_cols, gather_cols_plain
    m, s = _impact(dtype, cuda, steps, n=n)
    edt = m.edtype
    pos, vel = (m.coord + s.disp).to(edt), s.velo.to(edt)
    kin = contact_kinematics(m, pos, vel)
    assert torch.equal(kin, gather_cols_plain(torch.cat([pos, vel]),
                                              m.ckin_idx))
    acts = contact_activity(m, s.element_flag)
    force = torch.empty((3, m.fs_width), dtype=edt, device=cuda)
    accepts = fine = 0
    for i, p in enumerate(m.pairs):
        ksl, c = m.ckin_slices[i], pair_constants(m, p)
        bp = broad_phase(p, kin, ksl, acts[i], c)
        off_i, off_t = m.fs_offsets[i]
        counts, n_launched = _launched(narrow_phase, p, kin, ksl, bp, c,
                                       force, (off_i, off_t), count=True)
        per_node, per_tri = counts.node, counts.tri
        assert n_launched == {"hk_narrow_f32" if edt == torch.float32
                              else "hk_narrow_f64": 1}
        fi, ft, info = narrow_phase_plain(p, kin, ksl, bp, c, record=True)
        visits, near, rule = probe_counts_plain(p, kin, ksl, bp, c)
        assert torch.equal(counts.visits, visits)
        assert torch.equal(counts.near, near)
        assert bool(counts.fine) == bool(rule.on)
        fine += bool(rule.on)
        hit = info["pairs"]
        assert torch.equal(per_node, torch.bincount(
            hit[:, 1], minlength=p.Cp).int())
        assert torch.equal(per_tri, torch.bincount(
            hit[:, 0], minlength=p.Tp).int())
        accepts += info["accept"]
        assert _rel(force[:, off_i:off_i + p.Cp], fi) <= TOL[edt]
        assert _rel(force[:, off_t:off_t + p.Tp], ft) <= TOL[edt]
        again = [torch.zeros_like(force) for _ in range(2)]
        for f in again:
            assert narrow_phase(p, kin, ksl, bp, c, f, (off_i, off_t)) is None
        assert torch.equal(again[0], again[1])
        for a, b in ((off_i, p.Cp), (off_t, p.Tp)):
            assert torch.equal(again[0][:, a:a + b], force[:, a:a + b])
    assert accepts > 0 and fine >= (n == 12)
    g = scatter_forces(m, force, m.dtype)
    assert g.dtype == m.dtype
    assert _rel(g, scatter_forces_plain(m, force, m.dtype)) <= \
        (1e-6 if edt == torch.float32 else 1e-14)
    assert torch.equal(g, scatter_forces(m, force, m.dtype))
    assert torch.equal(gather_cols(kin, m.ckin_idx[:100]),
                       gather_cols_plain(kin, m.ckin_idx[:100]))


def stacked_model(copies=70, n=16, gap=-0.01):
    """``copies`` coincident unit cubes (each with 8 nodes of its own) under
    an n x n x 1 plate pressed ``-gap`` into their top face, off their
    grid: each plate node lies over ``copies`` top triangles and each top
    triangle under up to 153 plate nodes, more than the 64 (2 a lane) that
    the narrow kernel's warp holds in registers on either side."""
    from hakai_tpu_torch.io.model import Instance, Model, Part
    from hakai_tpu_torch.pre.synthetic import _grid, steel
    c1, e1 = _grid(1, 1, 1, 1.0, 1.0, 1.0)
    c1 = np.tile(c1, copies)
    e1 = np.concatenate([e1 + 8 * i for i in range(copies)], axis=1)
    c2, e2 = _grid(n, n, 1, 0.8, 0.8, 0.2, origin=(0.113, 0.087, 1.0 + gap))
    mt = steel()
    p1 = Part(name="stack", n_node=c1.shape[1], coordmat=c1,
              n_element=e1.shape[1], elementmat=e1, material_name=mt.name,
              material_id=1)
    p2 = Part(name="plate", n_node=c2.shape[1], coordmat=c2,
              n_element=e2.shape[1], elementmat=e2, material_name=mt.name,
              material_id=1)
    insts = [Instance(name="stack-1", part_name="stack", part_id=1,
                      material_id=1, n_node=p1.n_node,
                      n_element=p1.n_element),
             Instance(name="plate-1", part_name="plate", part_id=2,
                      material_id=1, node_offset=p1.n_node,
                      element_offset=p1.n_element, n_node=p2.n_node,
                      n_element=p2.n_element)]
    n_el = p1.n_element + p2.n_element
    return Model(parts=[p1, p2], instances=insts, materials=[mt],
                 n_node=p1.n_node + p2.n_node,
                 coordmat=np.concatenate([c1, c2], axis=1), n_element=n_el,
                 elementmat=np.concatenate([e1, e2 + p1.n_node], axis=1),
                 element_material=np.ones(n_el, np.int64),
                 element_instance=np.concatenate(
                     [np.ones(p1.n_element, np.int64),
                      np.full(p2.n_element, 2, np.int64)]),
                 d_time=1e-8, end_time=1e-6, contact_flag=1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_narrow_kernel_drops_no_accept(cuda, dtype):
    """Nodes that accept 70 triangles and triangles that accept up to 153
    nodes, past the 64 a warp's register lists hold: every node's and
    every triangle's accepted pairs equal the plain version's (20,230 in
    all), forces within the element bounds, bitwise repeatable."""
    from hakai_tpu_torch.ops.contact import (broad_phase, contact_activity,
                                             contact_kinematics)
    from hakai_tpu_torch.ops.contact_cuda import (narrow_phase,
                                                  narrow_phase_plain,
                                                  pair_constants)
    m = lower(stacked_model(), SolverConfig(dtype=dtype), device=cuda)
    s = init_state(m)
    kin = contact_kinematics(m, (m.coord + s.disp).to(m.edtype),
                             s.velo.to(m.edtype))
    acts = contact_activity(m, s.element_flag)
    most, accepts = [0, 0], 0
    for i, p in enumerate(m.pairs):
        ksl, c = m.ckin_slices[i], pair_constants(m, p)
        bp = broad_phase(p, kin, ksl, acts[i], c)
        off_i, off_t = m.fs_offsets[i]
        force = torch.full((2, 3, m.fs_width), float("nan"), dtype=m.edtype,
                           device=cuda)
        per_node, per_tri = narrow_phase(p, kin, ksl, bp, c, force[0],
                                         (off_i, off_t), count=True)[:2]
        narrow_phase(p, kin, ksl, bp, c, force[1], (off_i, off_t))
        fi, ft, info = narrow_phase_plain(p, kin, ksl, bp, c, record=True)
        hit = info["pairs"]
        assert torch.equal(per_node, torch.bincount(
            hit[:, 1], minlength=p.Cp).int())
        assert torch.equal(per_tri, torch.bincount(
            hit[:, 0], minlength=p.Tp).int())
        for a, b, ref in ((off_i, p.Cp, fi), (off_t, p.Tp, ft)):
            assert torch.equal(force[0, :, a:a + b], force[1, :, a:a + b])
            if ref.abs().max() > 0:
                assert _rel(force[0, :, a:a + b], ref) <= TOL[m.edtype]
            else:
                assert not force[0, :, a:a + b].any()
        most = [max(most[0], int(per_node.max())),
                max(most[1], int(per_tri.max()))]
        accepts += info["accept"]
    assert accepts == 20230 and most == [70, 153]


def test_contact_run_chunk_card_matches_cpu_f64(cuda):
    """The impact through its first contact in float64 on the card and on
    the CPU: the same trajectory to roundoff."""
    g = _impact("float64", cuda, 150)[1]
    c = _impact("float64", "cpu", 150)[1]
    assert c.contact_force.abs().max() > 0 or c.eq_ps.max() > 0
    for name in ("disp", "velo", "contact_force", "stress", "eq_ps"):
        assert _rel(getattr(g, name).cpu(), getattr(c, name)) <= 1e-10, name


@pytest.mark.parametrize("dtype", ["float64", "mixed"])
def test_self_contact_card_matches_cpu(cuda, dtype):
    """The self-contact plates (the self pair's kernels, with own-element
    exclusion) on the card and on the CPU: at step 40, in contact, and at
    the deck's end, step 200, after contact moved the lower plate.
    float64 agrees to roundoff (disp, velo, contact force), mixed in disp
    within the float32 bound of the trajectory phase of chip_smoke.py."""
    from hakai_tpu_torch.pre.synthetic import self_contact_model
    deck = self_contact_model()
    cfg = SolverConfig(dtype=dtype)
    runs = []
    for dev in (cuda, "cpu"):
        m = lower(deck, cfg, device=dev)
        assert len(m.pairs) == 1 and m.pairs[0].is_self
        s40 = run_chunk(m, init_state(m), 40)
        runs.append((s40, run_chunk(m, s40, 160)))
    (g40, g), (c40, c) = runs
    assert c40.contact_force.abs().max() > 0
    assert c.disp[:, m.coord[2] == 0.2].abs().max() > 1e-6
    names = ("disp", "velo", "contact_force") if dtype == "float64" else \
        ("disp",)
    for a, b in ((g40, c40), (g, c)):
        for name in names:
            assert _rel(getattr(a, name).cpu(), getattr(b, name)) <= \
                (1e-10 if dtype == "float64" else 2e-5), name


def test_pairs_left_on_the_cpu_raise(cuda):
    """A model whose contact pairs were not moved to the card fails the
    kernels' input check instead of passing CPU pointers (a fracture-free
    deck: its pairs need no activity masks, whose indexing would stop at
    PyTorch's own device check first)."""
    import dataclasses
    m, s = _impact("mixed", cuda, 0, ductile=False)
    assert all(p.static_activity for p in m.pairs)
    cpu_pairs = tuple(p.to("cpu") for p in m.pairs)
    with pytest.raises(ValueError, match="is on cpu"):
        run_chunk(dataclasses.replace(m, pairs=cpu_pairs), s, 1)


@pytest.mark.parametrize("loop", ["generic", "packed"])
def test_mixed_fracture_run_chunk_card_matches_cpu(cuda, loop):
    """The ductile bar in mixed precision for 500 steps (past the first
    deletions, near step 454-480 on the CPU) on the card and on the CPU,
    on the generic step and on the packed loop: equal flags, and each
    state field within 10x the float32 envelope (the CPU mixed run against
    the CPU float64 run)."""
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4, ductile=True)
    low = lower if loop == "generic" else port_fast_model
    out = {}
    for dev, dt in ((cuda, "mixed"), ("cpu", "mixed"), ("cpu", "float64")):
        m = low(bar, SolverConfig(dtype=dt), device=dev)
        out[(str(dev), dt)] = run_chunk(m, init_state(m), 500)
    g, c, c64 = out[("cuda", "mixed")], out[("cpu", "mixed")], \
        out[("cpu", "float64")]
    assert g.disp.dtype == g.Q.dtype == torch.float64
    assert g.stress.dtype == torch.float32
    assert not c.element_flag.all()
    assert torch.equal(g.element_flag.cpu(), c.element_flag)
    for name in ("disp", "velo", "Q", "stress", "eq_ps", "triax"):
        env = max(_rel(getattr(c, name).double(),
                       getattr(c64, name).double()), 2.0 ** -23)
        err = _rel(getattr(g, name).cpu().double(),
                   getattr(c, name).double())
        assert err <= 10 * env, (name, err, env)


@pytest.mark.parametrize("layout", ["strided", "tilemajor", "flat"])
def test_stream_kernel_matches_plain(cuda, layout):
    """TPU kernel #11's replacement, each layout bit for bit its plain
    version (x + 1.0 in float32), one launch counted."""
    from hakai_tpu_torch.ops.stream_cuda import (layout_shape, stream_add1,
                                                 stream_add1_plain)
    shape = layout_shape(layout, 8192, 2048)
    x = torch.as_tensor(np.random.default_rng(11).normal(
        scale=1e3, size=shape), dtype=torch.float32, device=cuda)
    got, n = _launched(stream_add1, x, layout, TE=2048)
    torch.cuda.synchronize()
    assert torch.equal(got, stream_add1_plain(x))
    assert n == {"hk_stream_add1_f32": 1}


@pytest.mark.parametrize("E,TE", [(5003, 2048), (4096, 1000), (6, 4),
                                  (5000, 2048)])
def test_stream_kernel_ragged_strided(cuda, E, TE):
    """The strided layout's ragged last tile, and rows or tiles that are no
    multiple of 4 floats (the scalar path), are written exactly, nothing
    past them."""
    from hakai_tpu_torch.ops.stream_cuda import stream_add1
    x = torch.arange(72 * E, dtype=torch.float32, device=cuda).view(72, E)
    out = torch.full_like(x, -7.0)
    stream_add1(x, "strided", out=out, TE=TE)
    torch.cuda.synchronize()
    assert torch.equal(out, x + 1.0)


def test_stream_kernel_refuses_wrong_inputs(cuda):
    """The wrapper raises on what the kernel does not take: another dtype,
    a misaligned or non-contiguous array, an output of another shape."""
    from hakai_tpu_torch.ops.stream_cuda import stream_add1
    with pytest.raises(TypeError, match="float32"):
        stream_add1(torch.zeros(72, 64, dtype=torch.float64, device=cuda),
                    "strided", TE=32)
    flat = torch.zeros(72 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        stream_add1(flat[1:].view(72, 64), "strided", TE=32)
    with pytest.raises(ValueError, match="contiguous"):
        stream_add1(torch.zeros(64, 72, device=cuda).t(), "strided", TE=32)
    with pytest.raises(ValueError, match="shape"):
        stream_add1(torch.zeros(72, 64, device=cuda), "strided",
                    out=torch.zeros(72, 65, device=cuda), TE=32)


@pytest.mark.parametrize("mode", ["copy", "stackrows", "selrows",
                                  "gatherrow"])
@pytest.mark.parametrize("tiles,builds", [(512, 60), (133, 70), (3, 5),
                                          (1, 8), (131, 100), (600, 60)])
def test_interleave_kernel_matches_plain(cuda, mode, tiles, builds):
    """TPU kernel #12's replacement, each mode bit for bit its plain
    version on a random window: the probe's 512 tiles x 60 builds (copy's
    and gatherrow's last slabs held in registers), a tile count an SM
    more than the card's SMs with builds past the window (the wrap), few
    builds (below 16: part of a staging group), one tile, one tile an SM
    with builds wrapping past the registers' first pass, and more tiles
    than the blocks hold at once; other row offsets; one launch
    counted."""
    from hakai_tpu_torch.ops.interleave_cuda import (interleave,
                                                     interleave_plain)
    src = torch.as_tensor(np.random.default_rng(12).normal(
        scale=100.0, size=(64, 8, 128)), dtype=torch.float32, device=cuda)
    for off in ((0, 1, 2, 3, 0, 1, 2, 3), (5, 0, 7, 1, 2, 9, 3, 0)):
        out = torch.full((tiles * 8, 128), float("nan"), device=cuda)
        got, n = _launched(interleave, src, mode, tiles, builds, off,
                           out=out)
        torch.cuda.synchronize()
        assert torch.equal(got, interleave_plain(src, mode, tiles, builds,
                                                 off))
        assert n == {"hk_interleave_f32": 1}


@pytest.mark.parametrize("mode", ["copy", "gatherrow"])
def test_interleave_kernel_wide_window(cuda, mode):
    """A window of 100 slabs and 130 builds: slabs 0-55 in shared memory,
    56-63 in registers, 64-99 through L1/L2, the builds wrapping past the
    window; into an output 4 bytes off 16-byte alignment.  Bit for bit
    the plain version."""
    from hakai_tpu_torch.ops.interleave_cuda import (interleave,
                                                     interleave_plain)
    src = torch.as_tensor(np.random.default_rng(13).normal(
        size=(100, 8, 128)), dtype=torch.float32, device=cuda)
    tiles = 140
    flat = torch.full((tiles * 1024 + 1,), float("nan"), device=cuda)
    out = flat[1:].view(tiles * 8, 128)
    got = interleave(src, mode, tiles, 130, out=out)
    torch.cuda.synchronize()
    assert torch.equal(got, interleave_plain(src, mode, tiles, 130))


def _scatter_table(rows, adds, width, seed, device, words_over=None):
    """A force table in the lowering's layout (the CSR and kernel S's
    block-sorted copy) for the given row lengths and leading adds, random
    columns below ``width``; the words laid out as for ``words_over``
    columns (default ``width``)."""
    from types import SimpleNamespace

    from hakai_tpu_torch.core.lowering import _scatter_blocks
    rows, adds = np.asarray(rows), np.asarray(adds)
    ptr = np.concatenate([[0], np.cumsum(rows)]).astype(np.int32)
    col = np.random.default_rng(seed).integers(0, width, ptr[-1])
    words, nb, bits, emax = _scatter_blocks(ptr, col, words_over or width)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)
    return SimpleNamespace(
        N=len(rows), fs_width=width, fs_ptr=t(ptr), fs_col=t(col),
        fs_mid=t(ptr[:-1] + adds), fs_sorted=t(words), fs_nb=nb,
        fs_bits=bits, fs_emax=emax)


@pytest.mark.parametrize("types", [("float32", "float32"),
                                   ("float64", "float64"),
                                   ("float32", "float64")])
def test_scatter_kernel_on_synthetic_tables(cuda, types):
    """Kernel S on a table of 1,000 nodes with empty rows, rows of 70
    entries (past a thread's wave and a warp), subtract-only and add-only
    rows and a ragged last block: bitwise its plain version in every type
    pair, on a second launch too; and with the words laid out for 2^24
    columns, where the nodes go in smaller blocks."""
    from hakai_tpu_torch.ops.contact_cuda import (scatter_forces,
                                                  scatter_forces_plain)
    fdt, odt = (getattr(torch, t) for t in types)
    rng = np.random.default_rng(5)
    rows = rng.choice([0, 1, 10, 19, 37, 70], size=1000)
    adds = np.minimum(rows, rng.integers(0, 3, 1000))
    adds[::7] = 0                                # subtract-only rows
    adds[3::11] = rows[3::11]                    # add-only rows
    force = torch.as_tensor(rng.normal(size=(3, 20000)), device=cuda).to(fdt)
    for words_over, nb in ((None, 32), (1 << 24, 4)):
        tab = _scatter_table(rows, adds, 20000, 6, cuda, words_over)
        assert tab.fs_nb == nb
        got = scatter_forces(tab, force, odt)
        assert got.dtype == odt
        assert torch.equal(got, scatter_forces_plain(tab, force, odt))
        assert torch.equal(got, scatter_forces(tab, force, odt))


def test_interleave_kernel_refuses_wrong_inputs(cuda):
    """The wrapper raises on what the kernel does not take: another dtype,
    a misaligned or non-contiguous window, an output of another shape,
    stackrows' slabs past shared memory."""
    from hakai_tpu_torch.ops.interleave_cuda import interleave
    with pytest.raises(TypeError, match="float32"):
        interleave(torch.zeros(64, 8, 128, dtype=torch.float64,
                               device=cuda), "copy", 2, 4)
    flat = torch.zeros(64 * 8 * 128 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        interleave(flat[1:].view(64, 8, 128), "copy", 2, 4)
    with pytest.raises(ValueError, match="contiguous"):
        interleave(torch.zeros(128, 8, 64, device=cuda).transpose(0, 2),
                   "copy", 2, 4)
    with pytest.raises(ValueError, match="shape"):
        interleave(torch.zeros(64, 8, 128, device=cuda), "copy", 2, 4,
                   out=torch.zeros(8, 128, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        interleave(torch.zeros(64, 8, 128, device=cuda), "selrows", 2, 60,
                   (41, 0, 0, 0, 0, 0, 0, 0))


# ---- the chunk loop as captured CUDA graphs (solver/graph.py) ----

def _graph_vs_eager(m, s0, n, k=None):
    """graph_chunk against eager_chunk from ``s0`` over ``n`` steps: every
    state field bit for bit (work and triax included), and the graph
    chunk's launches of the element and assembly kernels equal to its
    steps.  Returns the graph chunk's state."""
    from hakai_tpu_torch.solver.explicit import eager_chunk, graph_chunk
    from hakai_tpu_torch.solver.graph import GRAPH_STEPS
    eager = eager_chunk(m, s0, n)
    got, launched = _launched(graph_chunk, m, s0, n, k or GRAPH_STEPS)
    for entry in loop_entries(m, m.coord_e is None):
        assert launched[entry] == n, entry
    differ = [f.name for f in dataclasses.fields(got)
              if not torch.equal(getattr(got, f.name),
                                 getattr(eager, f.name))]
    assert differ == []
    assert int(got.t) == int(s0.t) + n
    return got


def test_graph_chunk_f32_packed_bitwise(cuda):
    """The f32 8x8x32 bar (2,048 elements: the packed loop), 2K + 5 steps
    in graphs of K and the remainder, and in graphs of 8 and the
    remainder: bitwise the eager loop; run_chunk takes the graph path on
    the card, and captures no length twice."""
    from hakai_tpu_torch.solver.graph import GRAPH_STEPS as K
    m = lower(bar_model(8, 8, 32, d_time=5e-8, end_time=1e-4),
              SolverConfig(dtype="float32", energy_check=True), device=cuda)
    assert m.coord_e is not None
    s0 = init_state(m)
    n = 2 * K + 5
    got = _graph_vs_eager(m, s0, n)
    _graph_vs_eager(m, s0, n, k=8)
    assert got.eq_ps.max() > 0
    lengths = sorted({K, n % K, 8, n % 8} - {0})
    assert sorted(m._chunk_graphs["packed"].graphs) == lengths
    again = run_chunk(m, s0, n)
    assert all(torch.equal(getattr(again, f.name), getattr(got, f.name))
               for f in dataclasses.fields(got))
    assert sorted(m._chunk_graphs["packed"].graphs) == lengths


@pytest.mark.parametrize("loop", ["generic", "packed"])
def test_graph_chunk_mixed_fracture_bitwise(cuda, loop):
    """The mixed ductile 4x4x16 bar over a chunk of 500 steps that deletes
    elements (first deletions near step 454-480), on the generic step and
    on the packed loop: bitwise the eager loop."""
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4, ductile=True)
    low = lower if loop == "generic" else port_fast_model
    m = low(bar, SolverConfig(dtype="mixed", energy_check=True),
            device=cuda)
    got = _graph_vs_eager(m, init_state(m), 500)
    assert not got.element_flag[:m.n_element].all()


@pytest.mark.parametrize("dtype", ["float64", "mixed"])
def test_graph_chunk_generic_bitwise(cuda, dtype, tmp_path):
    """The generic step in float64 and mixed precision, with the energy
    balance and a metrics stream (the negative-Jacobian count runs in the
    step), 100 plastic steps: bitwise the eager loop."""
    m = lower(bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4),
              SolverConfig(dtype=dtype, energy_check=True,
                           metrics_path=str(tmp_path / "m.jsonl")),
              device=cuda)
    assert m.coord_e is None
    got = _graph_vs_eager(m, init_state(m), 100)
    assert got.eq_ps.max() > 0 and got.work.abs().max() > 0


def test_graph_chunk_contact_bitwise(cuda):
    """The n=4 tie-free impact through its first contact (near step 63),
    mixed: bitwise the eager loop, with one gather (of the listed
    triangles: the chunks carry the activity), one narrow phase a pair
    and one scatter launched a step."""
    m, s0 = _impact("mixed", cuda, 0)
    got, n = _launched(_graph_vs_eager, m, s0, 90)
    assert (n["hk_gather_listed_f32"], n["hk_narrow_f32"],
            n["hk_scatter_f32_f64"]) == \
        (2 * 90, 2 * 90 * len(m.pairs), 2 * 90)   # eager and graph chunks
    assert got.contact_force.abs().max() > 0


def test_graph_chunk_keeps_returned_states(cuda):
    """A state returned by run_chunk is unchanged by the next chunk, which
    overwrites the graphs' static buffers; chunks of K + 5 and 2K + 7
    compose to the eager loop's 3K + 12 steps, bit for bit."""
    from hakai_tpu_torch.solver.explicit import eager_chunk
    from hakai_tpu_torch.solver.graph import GRAPH_STEPS as K
    m = lower(bar_model(8, 8, 32, d_time=5e-8, end_time=1e-4),
              SolverConfig(dtype="float32"), device=cuda)
    s0 = init_state(m)
    s1 = run_chunk(m, s0, K + 5)
    kept = {f.name: getattr(s1, f.name).clone()
            for f in dataclasses.fields(s1)}
    s2 = run_chunk(m, s1, 2 * K + 7)
    assert all(torch.equal(getattr(s1, k), v) for k, v in kept.items())
    whole = eager_chunk(m, s0, 3 * K + 12)
    assert all(torch.equal(getattr(s2, f.name), getattr(whole, f.name))
               for f in dataclasses.fields(s2))


@pytest.mark.parametrize("case", ["packed", "generic", "contact"])
def test_nccl_rank_graph_chunk_bitwise(cuda, case):
    """One NCCL rank on the card, its chunk replaying captured graphs with
    its collectives inside them (the qe all-gather; on the erosion-free
    contact deck also the narrow phase's all-reduce and the life mask
    hoisted into the comm's buffer): bit for bit the rank's eager chunk
    and one device's run_chunk, in chunks of 2K + 5 and 7 steps, with the
    element kernel's and the assembly's launches equal to the steps."""
    from hakai_tpu_torch.parallel.dist import launch
    from hakai_tpu_torch.parallel.sharding import chunk_rank
    from hakai_tpu_torch.solver.graph import GRAPH_STEPS as K
    if case == "packed":
        m = lower(bar_model(8, 8, 32, d_time=5e-8, end_time=1e-4),
                  SolverConfig(dtype="float32", energy_check=True),
                  device="cpu")
    elif case == "generic":
        m = lower(bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4,
                            ductile=True),
                  SolverConfig(dtype="mixed", energy_check=True),
                  device="cpu")
    else:
        m = lower(erosion_free_impact(), SolverConfig(dtype="mixed"),
                  device="cpu")
    assert (m.coord_e is not None) == (case == "packed")
    chunks = [2 * K + 5, 7] if case != "contact" else [2 * K + 36, 7]
    graph, eager = launch(chunk_rank, 1, "cuda", "nccl", [
        dict(model=m, chunks=chunks), dict(model=m, chunks=chunks,
                                           eager=True)])
    md = m.to(cuda)
    ref = run_chunk(md, run_chunk(md, init_state(md), chunks[0]), chunks[1])
    for rec in (graph, eager):
        for entry in loop_entries(m, case != "packed"):
            assert rec["launches"][entry] == sum(chunks), entry
        assert [f.name for f in dataclasses.fields(ref)
                if not torch.equal(getattr(rec["state"], f.name),
                                   getattr(ref, f.name).cpu())] == []
    loop = "packed" if case == "packed" else "generic"
    assert sorted(graph["captures"][loop]) == sorted(
        {K, chunks[0] % K, chunks[1]})
    assert eager["captures"] == {}
    if case == "contact":
        assert graph["contact_max"][-1] > 0


# ---- the step's stages: kernels I, E and A (csrc/integrate.cu,
# erosion.cu, broad.cu) against their plain versions ----

# dwork against torch.sum of the plain version: the kernel sums the
# products in double in another order (relative to the larger entry)
DWORK_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the erosion tables of tests/test_torch_erosion.py: two tables of several
# segments (one vertical), one material without a table
DU_TABLES = (((1.0, 0.0), (0.3, 0.3)),
             (),
             ((1.2, -0.5), (0.8, 0.0), (0.8, 0.0), (0.4, 0.5)))


def _amp_bar(dtype, device, energy=True):
    """The 4x4x16 bar with a 5-knot amplitude (a dip in it) and damping."""
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4)
    bar.amplitudes[0].time = np.array([0.0, 2e-6, 5e-6, 8e-6, 1e-5])
    bar.amplitudes[0].value = np.array([0.0, 0.4, 0.3, 0.9, 1.0])
    return lower(bar, SolverConfig(dtype=dtype, energy_check=energy,
                                   damping_C=2.0e3), device=device)


@pytest.mark.parametrize("contact", [False, True])
@pytest.mark.parametrize("energy", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64", "mixed"])
def test_integrate_kernel_matches_plain(cuda, dtype, energy, contact):
    """Kernel I against its plain version on the card, at steps in every
    amplitude segment and past the table: the step counter, disp_new,
    velo and the element-dtype inputs bitwise; dwork within DWORK_TOL."""
    from hakai_tpu_torch.ops.integrate import central_difference_plain
    from hakai_tpu_torch.ops.integrate_cuda import (_ENTRIES,
                                                    central_difference)
    m = _amp_bar(dtype, cuda, energy)
    rng = np.random.default_rng(3)

    def rand(scale):
        return torch.as_tensor(rng.normal(scale=scale, size=(3, m.N)),
                               device=cuda).to(m.dtype)
    s0 = init_state(m).replace(disp=rand(1e-3), disp_pre=rand(1e-3),
                               Q=rand(1e2))
    ext = rand(1e2) if contact else None
    for t in (0, 50, 120, 170, 400):
        s = s0.replace(t=torch.tensor(t, dtype=torch.int32, device=cuda))
        got, n = _launched(central_difference, m, s, ext,
                           element_inputs=True)
        assert n == {_ENTRIES[(m.dtype, m.edtype)]: 1}
        ref = central_difference_plain(m, s, ext, element_inputs=True)
        for name in ("t", "disp_new", "velo", "position", "d_disp"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        if energy:
            assert _rel(got.dwork, ref.dwork) <= DWORK_TOL[m.dtype]
            again = central_difference(m, s, ext)
            assert torch.equal(again.dwork, got.dwork)
            assert again.position is None
        else:
            assert got.dwork is None


def _erosion_inputs(E, dtype, device, seed):
    rng = np.random.default_rng(seed)
    eq = rng.uniform(0.0, 1.4, (8, E))
    tri = rng.uniform(-0.7, 0.8, (8, E))
    for i, knot in enumerate((0.0, 0.3, -0.5, 0.5)):
        tri[:, i::16] = knot
        eq[:, i + 4::16] = eq[0, i + 4::16]
    flag = rng.uniform(size=E) > 0.1
    mat = rng.integers(0, len(DU_TABLES), E).astype(np.int32)
    stress = rng.normal(size=(6, 8, E))
    strain = rng.normal(size=(6, E))

    def t(a, dt=dtype):
        return torch.as_tensor(a, device=device).to(dt).contiguous()
    return (t(eq), t(tri), t(flag, torch.bool), t(mat, torch.int32),
            t(stress), t(strain))


@pytest.mark.parametrize("step", ["packed", "generic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_erosion_kernel_matches_plain(cuda, dtype, step):
    """Kernel E against its plain version on the card, every output
    bitwise: the masked triaxiality (packed step), the zeroed stress and
    strain (generic step), the flags and the carried deletion flag; a
    walk that deletes nothing clears the flag."""
    from types import SimpleNamespace

    from hakai_tpu_torch.core.lowering import _ductile_tables
    from hakai_tpu_torch.ops.erosion import erosion_delete_mask_plain
    from hakai_tpu_torch.ops.erosion_cuda import erosion_walk
    E = 5003
    eq, tri, flag, mat, stress, strain = _erosion_inputs(E, dtype, cuda, 9)
    knots, rows = _ductile_tables(DU_TABLES)
    m = SimpleNamespace(du_tables=DU_TABLES, mat_id=mat,
                        du_knots=torch.as_tensor(knots, device=cuda),
                        du_n=torch.as_tensor(rows, device=cuda))
    carry = SimpleNamespace(flags=torch.zeros(3, dtype=torch.int32,
                                              device=cuda))
    packed = step == "packed"
    tri_ref = torch.where(flag[None, :], tri, 0.0) if packed else tri
    flag_ref, del_ref = erosion_delete_mask_plain(m, eq, tri_ref, flag)
    tri_in = tri.clone()
    got, n = _launched(erosion_walk, m, eq, tri_in, flag, mask_triax=packed,
                       stress=None if packed else stress.clone(),
                       strain=None if packed else strain.clone(),
                       carry=carry)
    assert n == {"hk_erosion_f32" if dtype == torch.float32
                 else "hk_erosion_f64": 1}
    assert torch.equal(got.element_flag, flag_ref)
    assert torch.equal(got.deleted, del_ref)
    assert torch.equal(got.triax, tri_ref)
    if not packed:
        keep = flag_ref[None, :]
        assert torch.equal(got.stress, torch.where(keep[None], stress, 0.0))
        assert torch.equal(got.strain, torch.where(keep, strain, 0.0))
    assert del_ref.any() and int(carry.flags[2]) == 1
    assert carry.flags[:2].tolist() == [0, 0]
    erosion_walk(m, eq, tri.clone(), torch.zeros_like(flag), carry=carry)
    assert carry.flags.tolist() == [0, 0, 0]


@pytest.mark.parametrize("dtype", ["mixed", "float64"])
def test_broad_kernel_matches_plain(cuda, dtype):
    """Kernel A against its plain version on the n=4 impact past first
    contact with a dozen elements deleted, each pair: the BroadPhase
    bitwise, recomputing the masks (no carry: every slot swept), through
    a carry whose flag is set (``list_active`` fills the masks and the
    list, bitwise ``active_list_plain``, and the range cull visits the
    list; ``tri_in`` is the carry's) and keeping them (flag clear: the
    carried masks and list are read, not recomputed, even where the life
    mask has changed)."""
    from hakai_tpu_torch.ops.activity import ActivityCarry
    from hakai_tpu_torch.ops.broad_cuda import (active_list_plain, broad,
                                                broad_phase, list_active)
    from hakai_tpu_torch.ops.contact import (contact_activity,
                                             contact_kinematics)
    from hakai_tpu_torch.ops.contact_cuda import pair_constants
    m, s = _impact(dtype, cuda, 90)
    flag = s.element_flag.clone()
    alive = torch.nonzero(flag).reshape(-1)
    flag[alive[-12:]] = False
    kin = contact_kinematics(m, (m.coord + s.disp).to(m.edtype),
                             s.velo.to(m.edtype))
    acts = contact_activity(m, flag)
    stale = contact_activity(m, s.element_flag)
    carry, kept = ActivityCarry(m), ActivityCarry(m)
    changed = torch.ones((), dtype=torch.int32, device=cuda)
    clear = torch.zeros_like(changed)
    overlaps = 0
    for i, p in enumerate(m.pairs):
        ksl, c = m.ckin_slices[i], pair_constants(m, p)
        ref = broad_phase(p, kin, ksl, acts[i], c)
        got, n = _launched(broad, p, kin, ksl, flag, c)
        assert n == {"hk_broad_f32" if kin.dtype == torch.float32
                     else "hk_broad_f64": 1}
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        pc = carry.pairs[i]
        _, n = _launched(list_active, p, flag, pc, changed, carry.stats,
                         i == len(m.pairs) - 1)
        assert n == {"hk_broad_list": 1}
        ids, starts = active_list_plain(acts[i][0], p.tb)
        assert torch.equal(pc.ids[:len(ids)], ids)
        assert torch.equal(pc.starts, starts)
        got = broad(p, kin, ksl, flag, c, pc, changed)
        assert got.tri_in is pc.tri_in
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert all(torch.equal(a, b) for a, b in zip(pc.masks, acts[i]))
        # the masks and list of the older life mask, kept under a clear
        # flag
        kc = kept.pairs[i]
        list_active(p, s.element_flag, kc, changed, kept.stats,
                    i == len(m.pairs) - 1)
        broad(p, kin, ksl, s.element_flag, c, kc, changed)
        held = [x.clone() for x in (*kc.masks, kc.ids, kc.starts)]
        list_active(p, flag, kc, clear, kept.stats,
                    i == len(m.pairs) - 1)
        got = broad(p, kin, ksl, flag, c, kc, clear)
        assert all(torch.equal(a, b) for a, b in zip(
            (*kc.masks, kc.ids, kc.starts), held))
        assert all(torch.equal(a, b) for a, b in zip(kc.masks, stale[i]))
        ref = broad_phase(p, kin, ksl, stale[i], c)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        overlaps += int(ref.overlap) + int(ref.pair_ok.sum())
    assert overlaps > 0
    listed = sum(int(a[0].sum()) for a in acts)
    assert carry.stats.tolist() == [1, 0, listed]


def test_graph_chunk_carries_activity_bitwise(cuda):
    """The n=4 impact in float64 with its ductile table of 0.02/0.01 (the
    tests' tie-free impact), steps 60-120 (through first contact, near
    step 63) through graphs and the eager loop (both carrying the masks
    and the lists of active triangles) and stepped outside any chunk
    (recomputing them every step, every slot swept): every field bitwise,
    with deletions and contact in the chunk; kernels I, E, A (its list
    and its broad phase) and the listed gather launched a step."""
    from hakai_tpu_torch.pre.synthetic import impact_model, offset_instance
    from hakai_tpu_torch.solver.explicit import step
    deck = offset_instance(impact_model(n=4, v0=8.0e4, d_time=1e-8,
                                        end_time=1e-5), 1, 0.013, 0.017)
    deck.materials[0].ductile = np.array([[0.02, 0.0, 30.0],
                                          [0.01, 0.3, 30.0]])
    m = lower(deck, SolverConfig(dtype="float64", energy_check=True),
              device=cuda)
    s0 = run_chunk(m, init_state(m), 60)
    n = 60
    got, launched = _launched(_graph_vs_eager, m, s0, n, k=8)
    assert [launched[e] for e in ("hk_integrate_f64", "hk_erosion_f64",
                                  "hk_broad_f64", "hk_broad_list",
                                  "hk_gather_listed_f64",
                                  "hk_gather_cols_f64")] == \
        [2 * n, 2 * n, 2 * n * len(m.pairs), 2 * n * len(m.pairs), 2 * n, 0]
    s, fired = s0, False
    for _ in range(n):
        s = step(m, s)
        fired |= bool(s.contact_force.abs().max() > 0)
    assert all(torch.equal(getattr(got, f.name), getattr(s, f.name))
               for f in dataclasses.fields(s))
    assert int(got.element_flag.sum()) < int(s0.element_flag.sum())
    assert fired


def _eroding_impact(dtype, device, steps):
    """The tests' tie-free n=4 impact (ductile table 0.02/0.01), lowered
    on ``device`` for ``steps`` steps of 1e-8 s in 4 chunks."""
    from hakai_tpu_torch.pre.synthetic import impact_model, offset_instance
    deck = offset_instance(impact_model(n=4, v0=8.0e4, d_time=1e-8,
                                        end_time=(steps + 0.5) * 1e-8),
                           1, 0.013, 0.017)
    deck.materials[0].ductile = np.array([[0.02, 0.0, 30.0],
                                          [0.01, 0.3, 30.0]])
    m = lower(deck, SolverConfig(dtype=dtype, output_num=4), device=device)
    assert m.time_num == steps
    return m


@pytest.mark.parametrize("dtype", ["mixed", "float64"])
def test_listed_contact_matches_dense_every_step(cuda, dtype, monkeypatch):
    """The eroding n=4 impact, 180 steps (first contact near step 63, then
    deletions), element dtype float32 and float64: at every step of a
    chunk that carries the lists of active triangles, the BroadPhase
    (tri_in, node_in, all_min, pair_ok, overlap) bitwise the dense
    sweep's (no carry) and the plain version's on the same state, every
    kin entry a kernel reads bitwise the whole gather's, the list the
    active mask's ids, and the state (the contact force included) bitwise
    a step without a carry; the lists grow (a face re-exposed) and shrink
    (an owner deleted).  The same steps through captured graphs (replays
    of 8) end bitwise the eager steps, the carry's buffers included, and
    ``run()`` of the deck (4 chunks, graphs of 32 and the remainder)
    counts in ``contact_rebuilds`` each step that followed a deletion and
    in ``contact_listed_max`` the most triangles active at a step over the
    pairs' slots."""
    from hakai_tpu_torch import run
    from hakai_tpu_torch.ops import contact as oc
    from hakai_tpu_torch.ops.activity import chunk_carry
    from hakai_tpu_torch.ops.broad_cuda import broad_phase, pair_activity
    from hakai_tpu_torch.ops.contact_cuda import pair_constants
    from hakai_tpu_torch.solver.explicit import graph_chunk, step
    T = 180
    m = _eroding_impact(dtype, cuda, T)
    consts = [pair_constants(m, p) for p in m.pairs]
    seen = {"bp": []}
    real_broad, real_kin = oc.broad, oc.contact_kinematics

    def kin_rec(model, pos, vel, carry=None):
        seen["kin"] = real_kin(model, pos, vel, carry)
        return seen["kin"]

    def broad_rec(*a, **kw):
        bp = real_broad(*a, **kw)
        seen["bp"].append(tuple(x.clone() for x in bp))
        return bp
    monkeypatch.setattr(oc, "contact_kinematics", kin_rec)
    monkeypatch.setattr(oc, "broad", broad_rec)
    carry = chunk_carry(m)
    s = init_state(m)
    s0 = None
    alive, listed, grew, shrank, contact = [], [], False, False, False
    prev = None
    for k in range(T):
        if k == 60:
            s0 = s
        flag = s.element_flag
        seen["bp"].clear()
        got = step(m, s, carry=carry)
        kin_l, bp_l = seen["kin"], list(seen["bp"])
        seen["bp"].clear()
        ref = step(m, s)
        kin_d, bp_d = seen["kin"], seen["bp"]
        differ = [f.name for f in dataclasses.fields(got)
                  if not torch.equal(getattr(got, f.name),
                                     getattr(ref, f.name))]
        assert differ == [], (k, differ)
        read = torch.zeros_like(kin_d, dtype=torch.bool)
        now = []
        for i, p in enumerate(m.pairs):
            act = pair_activity(p, flag)
            plain = broad_phase(p, kin_d, m.ckin_slices[i], act, consts[i])
            for a, b, c in zip(bp_l[i], bp_d[i], plain):
                assert torch.equal(a, b) and torch.equal(a, c), k
            pc = carry.pairs[i]
            ids = pc.ids[:int(pc.starts[-1])].clone()
            assert torch.equal(ids, torch.nonzero(act[0]).reshape(-1).int())
            now.append(ids)
            (a0, _), (a1, _), (a2, _), (cs, ce), (js, je) = \
                m.ckin_slices[i]
            ids = ids.long()
            read[:, a0 + ids] = True
            read[:3, a1 + ids] = True
            read[:3, a2 + ids] = True
            read[:, cs:ce] = True
            read[:3, js:je] = True
        assert torch.equal(kin_l[read], kin_d[read]), k
        if prev is not None:
            grew |= any(bool((~torch.isin(a, b)).any())
                        for a, b in zip(now, prev))
            shrank |= any(bool((~torch.isin(b, a)).any())
                          for a, b in zip(now, prev))
        prev = now
        listed.append(sum(len(x) for x in now))
        contact |= bool(got.contact_force.abs().max() > 0)
        s = got
        alive.append(int(s.element_flag.sum()))
    assert grew and shrank and contact
    monkeypatch.undo()
    # the steps from 60 through graphs, on a model of their own
    mg = _eroding_impact(dtype, cuda, T)
    g = graph_chunk(mg, s0, T - 60, k=8)
    assert all(torch.equal(getattr(g, f.name), getattr(s, f.name))
               for f in dataclasses.fields(s))
    for a, b in zip(mg._activity["carry"].pairs, carry.pairs):
        n = int(b.starts[-1])
        assert all(torch.equal(x, y) for x, y in zip(
            (*a.masks, a.ids[:n], a.starts, a.tri_in),
            (*b.masks, b.ids[:n], b.starts, b.tri_in)))
    tm = {}
    final = run(_eroding_impact(dtype, cuda, T), verbose=False,
                write_output=False, device=cuda, timings=tm)
    assert torch.equal(final.element_flag, s.element_flag)
    before = [m.n_element] + alive[:-1]
    after_deletion = sum(a < b for a, b in zip(alive[:-1], before[:-1]))
    assert tm["contact_rebuilds"] == after_deletion > 0
    slots = sum(p.tri_nodes.shape[1] for p in m.pairs)
    assert tm["contact_listed_max"] == max(listed) / slots


def test_step_stage_wrappers_refuse(cuda):
    """On the card kernels I, E and A raise on a dtype they do not take,
    and on inputs of the wrong device: no wrapper falls back to its plain
    version."""
    from types import SimpleNamespace

    from hakai_tpu_torch.ops.broad_cuda import broad
    from hakai_tpu_torch.ops.contact import contact_kinematics
    from hakai_tpu_torch.ops.contact_cuda import pair_constants
    from hakai_tpu_torch.ops.erosion_cuda import erosion_walk
    from hakai_tpu_torch.ops.integrate_cuda import central_difference
    m = _amp_bar("float32", cuda)
    s = init_state(m)
    half = dataclasses.replace(m, coord=m.coord.half())
    with pytest.raises(TypeError):
        central_difference(half, s)
    with pytest.raises(ValueError):
        central_difference(dataclasses.replace(m, diag_M=m.diag_M.cpu()), s)
    eq = torch.zeros((8, 64), dtype=torch.float16, device=cuda)
    em = SimpleNamespace(mat_id=torch.zeros(64, dtype=torch.int32,
                                            device=cuda))
    flag = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        erosion_walk(em, eq, eq.clone(), flag)
    mi, si = _impact("float64", cuda, 0)
    kin = contact_kinematics(mi, mi.coord + si.disp, si.velo)
    p, c = mi.pairs[0], pair_constants(mi, mi.pairs[0])
    with pytest.raises(TypeError):
        broad(p, kin.half(), mi.ckin_slices[0], si.element_flag, c)
    with pytest.raises(ValueError):
        broad(p, kin, mi.ckin_slices[0], si.element_flag.cpu(), c)


# ---- the host loop's counters and spans around captured graphs ----

def test_run_counts_captures_and_replays(cuda, monkeypatch):
    """``run()`` on the card, twice with one model: each run captures
    each graph length once (its model is its own), replays ``chunks x
    (q + (r > 0))`` times, and counts in ``capture_s`` at least its
    ``Captured`` records' capture and instantiation seconds.  Under the
    profiler every ``cudaGraphLaunch`` lies in a ``hakai.graph.replay``
    span and every ``cudaGraphInstantiate`` in a ``hakai.graph.capture``,
    and no ``hakai.*`` span starts while a stream is captured."""
    from torch.profiler import ProfilerActivity, profile

    from hakai_tpu_torch import run
    from hakai_tpu_torch.solver.graph import GRAPH_STEPS as K, ChunkGraphs
    made, capture = [], ChunkGraphs._capture

    def recording(self, model, length):
        made.append((length, capture(self, model, length)))
        return made[-1][1]
    monkeypatch.setattr(ChunkGraphs, "_capture", recording)
    n = 2 * K + 5
    m = lower(bar_model(8, 8, 32, d_time=5e-8,
                        end_time=(3 * n + 0.5) * 5e-8),
              SolverConfig(dtype="float32", energy_check=True,
                           energy_abort_rel=0.1, output_num=3),
              device="cpu")
    assert m.coord_e is not None and m.time_num == 3 * n
    for _ in range(2):
        made.clear()
        tm = {}
        run(m, verbose=False, write_output=False, device=cuda, timings=tm)
        assert sorted(length for length, _ in made) == [5, K]
        assert (tm["captures"], tm["replays"], tm["chunks"]) == (2, 9, 3)
        assert tm["capture_s"] >= sum(c.capture_s + c.instantiate_s
                                      for _, c in made)
        assert (tm["host_syncs"], tm["ahead"]) == (2 + 3, 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        run(m, verbose=False, write_output=False, device=cuda)
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in p.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA]

    def within(prefix, holder):
        held = [(a, b) for n_, a, b in host if n_ == holder]
        evs = [(a, b) for n_, a, b in host if n_.startswith(prefix)]
        return len(evs), [e for e in evs
                          if not any(c <= e[0] and e[1] <= d
                                     for c, d in held)]
    launches, stray = within("cudaGraphLaunch", "hakai.graph.replay")
    assert launches == 9 and stray == []
    made_, stray = within("cudaGraphInstantiate", "hakai.graph.capture")
    assert made_ == 2 and stray == []
    begins = sorted(a for n_, a, _ in host
                    if n_.startswith("cudaStreamBeginCapture"))
    ends = sorted(b for n_, _, b in host
                  if n_.startswith("cudaStreamEndCapture"))
    assert len(begins) == len(ends) == 2
    assert [n_ for n_, a, _ in host if n_.startswith("hakai.") and any(
        s < a < e for s, e in zip(begins, ends))] == []


def test_run_reads_one_chunk_behind(cuda, monkeypatch, tmp_path):
    """``run()`` on the card with captured graphs and a metrics stream (a
    small mixed bar on the generic step, as ``bar131k_mixed_xla``): every
    chunk but the first is queued before the previous chunk's values are
    read, one read a chunk, and every record (but its wall seconds)
    equals ``step_metrics`` read on that chunk's end state after the run,
    as is the final state the last chunk's."""
    import json

    from hakai_tpu_torch import run
    from hakai_tpu_torch.solver import explicit
    from hakai_tpu_torch.utils.metrics import step_metrics
    from hakai_tpu_torch.solver.graph import GRAPH_STEPS as K
    n = K + 5
    m = lower(bar_model(8, 8, 32, d_time=5e-8,
                        end_time=(4 * n + 0.5) * 5e-8),
              SolverConfig(dtype="mixed", gather_mode="xla",
                           energy_check=True, energy_abort_rel=0.1,
                           check_nan=True, output_num=4,
                           metrics_path=str(tmp_path / "m.jsonl")),
              device="cpu")
    assert m.coord_e is None and m.time_num == 4 * n
    ends, chunk = [], explicit.run_chunk

    def keeping(model, state, steps, comm=None):
        ends.append(chunk(model, state, steps, comm))
        return ends[-1]
    monkeypatch.setattr(explicit, "run_chunk", keeping)
    tm = {}
    final = run(m, verbose=False, write_output=False, device=cuda,
                timings=tm)
    assert (tm["chunks"], tm["ahead"], tm["host_syncs"]) == (4, 3, 2 + 4)
    assert tm["replays"] == 8
    recs = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    mc = m.to(cuda)
    for r, s in zip(recs, ends, strict=True):
        want = {k: float(v) for k, v in step_metrics(mc, s).items()}
        assert {k: v for k, v in r.items()
                if k not in ("step", "time", "wall_s")} == want
        assert r["step"] == int(s.t)
    assert torch.equal(final.disp, ends[-1].disp)
    assert torch.equal(final.stress, ends[-1].stress)
