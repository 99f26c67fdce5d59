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

from hakai_tpu_torch import SolverConfig, init_state, lower, run_chunk
from hakai_tpu_torch.ops.assemble_cuda import (assemble_internal_force,
                                               blocked_assemble,
                                               blocked_assemble_plain,
                                               plan_assemble)
from hakai_tpu_torch.ops.element import (assemble_internal_force_plain,
                                         element_core_packed_plain,
                                         element_core_plain,
                                         gather_element_nodes, triax_stress)
from hakai_tpu_torch.ops.element_cuda import (element_core_packed,
                                              element_update)
from hakai_tpu_torch.pre.synthetic import bar_model

pytestmark = pytest.mark.cuda

# normwise kernel-vs-plain tolerance: same formulas, other association order
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the triaxiality mean/vm: a quotient with cancelling deviatoric
# differences, 10x the element bound
TRIAX_TOL = {torch.float32: 1e-4, torch.float64: 1e-11}


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
    before = element_core_packed.launches
    Pk, qk = element_core_packed(m, *args)
    Pp, qp = element_core_packed_plain(m, *args)
    assert element_core_packed.launches == before + 1
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
    before = (blocked_assemble.launches, assemble_internal_force.launches)
    assert torch.equal(assemble_internal_force(grouped, qe, m.dtype), got)
    assert (blocked_assemble.launches, assemble_internal_force.launches) \
        == (before[0] + 1, before[1])


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
    launch counted by entry."""
    m = lower(bar_model(8, 8, 32), SolverConfig(dtype=dtype, elem_pad=4096,
                                                gather_mode="xla"),
              device=cuda)
    assert m.coord_e is None and m.E == 4096
    u = _update_inputs(m, 4)
    before = dict(element_update.launches_by)
    out = element_update(m, *u, want_triax=want_triax)
    pos_e, du = gather_element_nodes(m, u[0], u[1])
    ref = element_core_plain(m, pos_e, du, *u[2:])
    res = out[0] if want_triax else out
    key = str(m.edtype).split(".")[1] + "+triax" * want_triax
    assert element_update.launches_by[key] == before[key] + 1
    for name in ("Qe", "stress", "strain", "eq_ps", "yield_s"):
        a, b = getattr(res, name), getattr(ref, name)
        assert a.dtype == b.dtype == m.edtype and a.shape == b.shape, name
        assert _rel(a, b) <= TOL[m.edtype], name
    assert not res.Qe[..., ~u[-1]].any()
    if want_triax:
        assert _rel(out[1], triax_stress(ref.stress)) <= TRIAX_TOL[m.edtype]


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
    before = dict(element_core_packed.launches_by)
    Pk, qk, tk = element_core_packed(m, *args, want_triax=True)
    Pp, qp, tp = element_core_packed_plain(m, *args, want_triax=True)
    variant = "mixed" if dtype == "mixed" else dtype
    assert (element_core_packed.launches_by[variant + "+triax"]
            == before[variant + "+triax"] + 1)
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
    (n=12: the cube nodes' pair splits both of its launches, 14 and 2
    ways) with forces within the element bounds, every node's and every
    triangle's accepted pairs equal to the plain version's (the deck has
    no ties), bitwise repeatable and unchanged by counting; the scatter
    within the assembly's bounds."""
    from hakai_tpu_torch.ops.contact import (broad_phase, contact_activity,
                                             contact_kinematics)
    from hakai_tpu_torch.ops.contact_cuda import (narrow_phase,
                                                  narrow_phase_plain,
                                                  narrow_splits,
                                                  pair_constants,
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
    accepts, split_both = 0, False
    for i, p in enumerate(m.pairs):
        ksl, c = m.ckin_slices[i], pair_constants(m, p)
        split_both |= min(narrow_splits(p.n_chunks, p.nb, p.tri_chunks),
                          narrow_splits(p.tri_chunks, p.tb, p.n_chunks)) > 1
        bp = broad_phase(p, kin, ksl, acts[i], c)
        off_i, off_t = m.fs_offsets[i]
        before = narrow_phase.launches
        per_node, per_tri = narrow_phase(p, kin, ksl, bp, c, force,
                                         (off_i, off_t), count=True)
        assert narrow_phase.launches == before + 1
        fi, ft, info = narrow_phase_plain(p, kin, ksl, bp, c, record=True)
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
    assert accepts > 0 and split_both == (n == 12)
    g = scatter_forces(m, force, m.dtype)
    assert g.dtype == m.dtype
    assert _rel(g, scatter_forces_plain(m, force, m.dtype)) <= \
        (1e-6 if edt == torch.float32 else 1e-14)
    assert torch.equal(g, scatter_forces(m, force, m.dtype))
    assert torch.equal(gather_cols(kin, m.ckin_idx[:100]),
                       gather_cols_plain(kin, m.ckin_idx[:100]))


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
    before = stream_add1.launches
    got = stream_add1(x, layout, TE=2048)
    torch.cuda.synchronize()
    assert torch.equal(got, stream_add1_plain(x))
    assert stream_add1.launches == before + 1


@pytest.mark.parametrize("E,TE", [(5003, 2048), (4096, 1000), (6, 4)])
def test_stream_kernel_ragged_strided(cuda, E, TE):
    """The strided layout's ragged last tile and rows that are no multiple
    of 4 floats (the scalar path) are written exactly, nothing past them."""
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
