"""The port's plain element update (hakai_tpu_torch.ops.element) against the
JAX package: the fused-gather MXU Pallas kernel in interpret mode (f32) and
the fused-XLA element math (f64).

Inputs are made with numpy from a seed and handed to both packages.  The
random state engages both return-map branches (yield around the trial
stress, eq_ps across the hardening table), a dead element and padding
lanes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.ops import element as jel
from hakai_tpu.pre.synthetic import bar_model
from hakai_tpu.solver.explicit import _interleave_nodal, pack_gauss_state
from hakai_tpu_torch import _build
from hakai_tpu_torch.core.lowering import lower
from hakai_tpu_torch.ops import element as tel
from hakai_tpu_torch.ops.element_cuda import element_core_packed
from test_torch_cuda import port_fast_model


def _state(rng, E, N, dtype):
    """(disp, dprev, stress, strain, eq_ps, yield) in ``dtype``."""
    disp = rng.normal(scale=1e-3, size=(3, N))
    dprev = disp + rng.normal(scale=2e-4, size=(3, N))
    return [a.astype(dtype) for a in (
        disp, dprev, rng.normal(scale=300.0, size=(6, 8, E)),
        rng.normal(scale=1e-3, size=(6, E)), rng.uniform(0.0, 0.3, (8, E)),
        755.0 + rng.uniform(0.0, 300.0, (8, E)))]


def _packed(stress, strain, eq, ys):
    E = eq.shape[1]
    return np.concatenate([stress.reshape(48, E), strain,
                           np.zeros((2, E), stress.dtype), eq, ys])


def test_plain_matches_fused_mxu_kernel(monkeypatch):
    """f32, 8x8x32 bar (2048 elements, renumbered, window plans on): the
    plain twin against element_core_packed_mxu with the fused in-kernel
    gather (GatherPhysPlan), run in Pallas interpret mode, with the
    triaxiality output of fracture decks (want_triax) on.  Tolerance: the
    one test_element.py holds the MXU kernel to against the XLA math
    (rtol=3e-5, atol=3e-4): both reassociate the constant contractions."""
    from hakai_tpu.ops.element_pallas import element_core_packed_mxu
    monkeypatch.setenv("HAKAI_PALLAS_FORCE", "1")
    bar = bar_model(8, 8, 32, d_time=1e-8, end_time=1.0)
    cfg = SolverConfig(dtype="float32")
    jm, tm = jax_lower(bar, cfg), lower(bar, cfg, device="cpu")
    assert jm.plan_gphys is not None and jm.plan_gphys.ok
    E, N = tm.E, tm.N
    disp, dprev, stress, strain, eq, ys = _state(
        np.random.default_rng(11), E, N, np.float32)
    flag = np.ones(E, bool)
    flag[3] = False
    P = _packed(stress, strain, eq, ys)

    js = jax_init_state(jm).replace(
        stress=jnp.asarray(stress), strain=jnp.asarray(strain),
        eq_ps=jnp.asarray(eq), yield_s=jnp.asarray(ys))
    P_ref, qe_ref, tri_ref = element_core_packed_mxu(
        jm, jm.coord_e.reshape(24, E), None, pack_gauss_state(js, E),
        jnp.asarray(flag), want_triax=True, gplan=jm.plan_gphys,
        disp_il=_interleave_nodal(jnp.asarray(disp), jnp.float32),
        dprev_il=_interleave_nodal(jnp.asarray(dprev), jnp.float32))
    P_ref, qe_ref = np.asarray(P_ref), np.asarray(qe_ref)
    tri_ref = np.asarray(tri_ref)
    np.testing.assert_array_equal(np.asarray(pack_gauss_state(js, E)), P)

    P_new, qe, tri = tel.element_core_packed_plain(
        tm, torch.from_numpy(P), torch.from_numpy(flag),
        torch.from_numpy(disp), torch.from_numpy(dprev), want_triax=True)
    P_new, qe, tri = P_new.numpy(), qe.numpy(), tri.numpy()
    plastic = (P_ref[56:64] != eq).mean()
    assert 0.05 < plastic < 0.95, plastic
    tol = dict(rtol=3e-5, atol=3e-4)
    np.testing.assert_allclose(qe, qe_ref, **tol)
    np.testing.assert_allclose(P_new, P_ref, **tol)
    assert tri.shape == tri_ref.shape == (8, E)
    np.testing.assert_allclose(tri, tri_ref, **tol)
    assert not P_new[54:56].any()
    assert not qe[:, 3].any()


def test_plain_matches_xla_element_math_f64():
    """f64 with 256 padding lanes and a dead element: the plain twin
    against hakai_tpu.ops.element._element_math on the same node-0-centred
    pos/du.  The sums run in another order (einsum against unrolled FMAs),
    so agreement is to roundoff: 1e-12 of each output's scale."""
    bar = bar_model(4, 4, 16, d_time=1e-8, end_time=1.0)
    cfg = SolverConfig(dtype="float64", elem_pad=512)
    jm, tm = jax_lower(bar, cfg), port_fast_model(bar, cfg)
    E, N = tm.E, tm.N
    assert E == 512 and tm.n_element == 256
    disp, dprev, stress, strain, eq, ys = _state(
        np.random.default_rng(5), E, N, np.float64)
    flag = np.asarray(tm.elem_exists).copy()
    flag[7] = False
    for x in (stress, strain):                # padding lanes start at zero
        x[..., tm.n_element:] = 0.0
    elem = np.asarray(jm.elem)
    d = disp[:, elem]
    pos = tm.coord_e.numpy() + (d - d[:, 0:1])
    du = d - dprev[:, elem]

    ref = jel._element_math(
        jm.pl_tables, jm.mat_id, jm.G_e, jm.lam_e, jm.has_plastic_e,
        jnp.asarray(jel._PUS), jnp.asarray(pos), jnp.asarray(du),
        [jnp.asarray(stress[c]) for c in range(6)],
        [jnp.asarray(strain[c]) for c in range(6)], jnp.asarray(eq),
        jnp.asarray(ys), jnp.asarray(flag), pre_centered=True)
    qe_ref = np.asarray(jel._stack_qe(ref[0])).reshape(24, E)
    P_ref = _packed(np.stack([np.asarray(s) for s in ref[1]]),
                    np.stack([np.asarray(s) for s in ref[2]]),
                    np.asarray(ref[3]), np.asarray(ref[4]))

    P_new, qe = tel.element_core_packed_plain(
        tm, torch.from_numpy(_packed(stress, strain, eq, ys)),
        torch.from_numpy(flag), torch.from_numpy(disp),
        torch.from_numpy(dprev))
    P_new, qe = P_new.numpy(), qe.numpy()
    assert 0.05 < (P_ref[56:64] != eq).mean() < 0.95
    for name, a, b in (("stress", P_new[:48], P_ref[:48]),
                       ("strain", P_new[48:56], P_ref[48:56]),
                       ("eq_ps", P_new[56:64], P_ref[56:64]),
                       ("yield", P_new[64:72], P_ref[64:72]),
                       ("qe", qe, qe_ref)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)
    # padding lanes stay exactly zero; dead lanes carry no force
    assert not P_new[:56, tm.n_element:].any()
    assert not qe[:, tm.n_element:].any() and not qe[:, 7].any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hardening_slope_matches_jax(dtype):
    """Bitwise: the segment count uses a strict '>' against each table
    strain, so values exactly on a breakpoint are included."""
    tables = bar_model().materials[0].plastic
    pl = (tuple((float(s), float(e)) for s, e in tables),
          ((500.0, 0.0),))                    # a one-row material: H = 0
    eqs = np.concatenate([tables[:, 1], tables[:, 1] + 1e-6,
                          np.random.default_rng(3).uniform(0, 5, 48)])
    eq = np.resize(eqs, (8, 16)).astype(dtype)
    mat = np.arange(16) % 2
    ref = np.asarray(jel._hardening_slope_tab(pl, jnp.asarray(mat),
                                              jnp.asarray(eq)))
    got = tel.hardening_slope(pl, torch.from_numpy(mat),
                              torch.from_numpy(eq)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[:, 1::2].any()


def test_triax_matches_jax():
    s = np.random.default_rng(9).normal(scale=100.0, size=(6, 8, 32))
    s[:, 0, 0] = 0.0                          # vm == 0 -> triax 0
    ref = np.asarray(jel.triax_components([jnp.asarray(x) for x in s]))
    got = tel.triax_components([torch.from_numpy(x) for x in s]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0)
    assert got[0, 0] == 0.0


def test_wrapper_runs_plain_version_on_cpu():
    m = port_fast_model(bar_model(4, 4, 16), SolverConfig(dtype="float32"))
    disp, dprev, stress, strain, eq, ys = _state(
        np.random.default_rng(2), m.E, m.N, np.float32)
    args = (torch.from_numpy(_packed(stress, strain, eq, ys)),
            m.elem_exists, torch.from_numpy(disp), torch.from_numpy(dprev))
    before = _build.LAUNCHES.copy()
    P1, q1 = element_core_packed(m, *args)
    P2, q2 = tel.element_core_packed_plain(m, *args)
    assert _build.LAUNCHES == before                # no kernel launched
    assert torch.equal(P1, P2) and torch.equal(q1, q2)
    with pytest.raises(ValueError, match="no element kernel"):
        element_core_packed(m.to("meta"), *(a.to("meta") for a in args))
