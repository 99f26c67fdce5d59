"""The generic step path of the port against the JAX package on the CPU:
the unpacked element update (the plain version of the port's kernel for
TPU kernel #3) against ``element_core_pallas`` in interpret mode and
against the XLA math, and ``run_chunk`` on decks where both packages'
own lowerings build no ``coord_e`` and take the generic ``step()``."""
import dataclasses

import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig as JConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.pre import synthetic as jsyn
from hakai_tpu.solver.explicit import run_chunk as jax_run_chunk
from hakai_tpu_torch import SolverConfig, init_state, lower, run_chunk
from hakai_tpu_torch.ops.element_cuda import element_update
from hakai_tpu_torch.pre import synthetic as tsyn
from hakai_tpu_torch.solver import explicit as texplicit
from hakai_tpu_torch.solver.explicit import pack_gauss_state
from test_torch_slice import STATE, _compare

FIELDS = ("Qe", "stress", "strain", "eq_ps", "yield_s")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _both(build, dtype, **kw):
    """(JAX model, port model) of one deck, each from its own package's
    builder and lowering, in ``dtype``."""
    return (jax_lower(build(jsyn), JConfig(dtype=dtype, **kw)),
            lower(build(tsyn), SolverConfig(dtype=dtype, **kw),
                  device="cpu"))


def _update_inputs(tm, seed, invert=False):
    """Seeded element-update inputs: nodal positions and increments, a
    Gauss-point state that engages both return-map branches (stress ~300
    MPa, yield in [755, 1055), eq_ps across the hardening table), one dead
    element; padding lanes come from the mesh.  With ``invert`` one top
    node is pushed through its elements, so some Jacobians turn
    negative."""
    rng = np.random.default_rng(seed)
    E, N = tm.E, tm.N
    disp = rng.normal(scale=1e-3, size=(3, N))
    if invert:
        disp[2, tm.n_node - 1] = -2.0
    d_disp = rng.normal(scale=2e-4, size=(3, N))
    flag = tm.elem_exists.numpy().copy()
    flag[5] = False
    return dict(
        position=tm.coord.numpy() + disp, d_disp=d_disp,
        stress=rng.normal(scale=300.0, size=(6, 8, E)),
        strain=rng.normal(scale=1e-3, size=(6, E)),
        eq_ps=rng.uniform(0.0, 0.3, (8, E)),
        yield_s=755.0 + rng.uniform(0.0, 300.0, (8, E)), flag=flag)


def _run_both(jm, tm, a):
    """JAX ``element_update`` and the port's on the same inputs, in each
    model's element dtype (positions formed in float64, then cast)."""
    import jax.numpy as jnp

    from hakai_tpu.ops.element import element_update as jax_element_update
    edt = np.dtype(str(tm.edtype).split(".")[1])
    args = [a[k].astype(edt) for k in ("position", "d_disp", "stress",
                                       "strain", "eq_ps", "yield_s")]
    ref = jax_element_update(jm, *map(jnp.asarray, args),
                             jnp.asarray(a["flag"]))
    got, triax = element_update(tm, *map(torch.from_numpy, args),
                                torch.from_numpy(a["flag"]), want_triax=True)
    return ref, got, triax


def test_plain_update_matches_kernel3(monkeypatch):
    """TPU kernel #3 (``element_core_pallas``, interpret mode) against the
    port's plain element update, f32: ``bar_model(4, 4, 60)`` with
    ``gather_mode="xla"`` and ``elem_pad=1024``, one 1,024-element tile
    of which 64 lanes are padding.  The JAX package reaches the kernel
    through its own ``element_update`` (XLA gather, then
    ``element_core``).  Tolerance rtol 3e-5, atol 3e-4: the bound
    tests/test_element.py holds its Pallas kernels to against the XLA
    math."""
    from hakai_tpu.ops.element import pallas_core_ok
    from hakai_tpu.ops.element import triax_stress as jax_triax_stress
    monkeypatch.setenv("HAKAI_PALLAS_FORCE", "1")
    jm, tm = _both(lambda s: s.bar_model(4, 4, 60, d_time=5e-8,
                                         end_time=1e-4), "float32",
                   gather_mode="xla", elem_pad=1024)
    assert tm.E == jm.E == 1024 and tm.n_element == 960
    assert tm.coord_e is None and jm.coord_e is None
    assert pallas_core_ok(jm, jm.E, np.float32)
    a = _update_inputs(tm, 41)
    ref, got, triax = _run_both(jm, tm, a)
    tol = dict(rtol=3e-5, atol=3e-4)
    for name in FIELDS:
        g = getattr(got, name).numpy()
        assert g.dtype == np.float32, name
        np.testing.assert_allclose(g, np.asarray(getattr(ref, name)),
                                   err_msg=name, **tol)
    np.testing.assert_allclose(triax.numpy(),
                               np.asarray(jax_triax_stress(ref.stress)),
                               **tol)
    plastic = (np.asarray(ref.eq_ps) != a["eq_ps"].astype(np.float32))
    assert 0.05 < plastic.mean() < 0.95, plastic.mean()
    dead = ~a["flag"]
    assert dead.sum() == 65 and not got.Qe.numpy()[:, :, dead].any()
    assert int(got.neg_jacobian) == int(ref.neg_jacobian) == 0


def test_plain_update_matches_xla_f64(tmp_path):
    """The same update in f64 against the JAX XLA math (``_element_math``
    via ``element_core``), normwise within 1e-12 of each field's scale;
    with a metrics stream configured both count the negative Jacobians
    of an inverted corner."""
    jm, tm = _both(lambda s: s.bar_model(4, 4, 60, d_time=5e-8,
                                         end_time=1e-4), "float64",
                   metrics_path=str(tmp_path / "m.jsonl"))
    a = _update_inputs(tm, 43, invert=True)
    ref, got, triax = _run_both(jm, tm, a)
    for name in FIELDS:
        assert _rel(getattr(got, name).numpy(),
                    getattr(ref, name)) <= 1e-12, name
    assert int(got.neg_jacobian) == int(ref.neg_jacobian) > 0


def test_run_chunk_f64_generic():
    """100 plastic steps in f64 with the energy balance, each package on
    its own lowering of the 4x4x16 bar (both take the generic step):
    within 1e-10 of each field's scale."""
    jm, tm = _both(lambda s: s.bar_model(4, 4, 16, d_time=5e-8,
                                         end_time=1e-4), "float64",
                   energy_check=True)
    assert jm.coord_e is None and tm.coord_e is None
    js = jax_run_chunk(jm, jax_init_state(jm), 100)
    ts = run_chunk(tm, init_state(tm), 100)
    assert float(np.asarray(js.eq_ps).max()) > 0.01
    _compare(js, ts, {"*": 1e-10})


def test_erosion_repair_f64():
    """The repaired divergence: on a ductile bar below 2,048 elements
    (end_time 4e-5: the first elements erode near step 130) both
    packages' own lower() + run_chunk take the generic step, which reports
    a dead element's triaxiality from its trial stress.  300 steps in
    chunks of 50, f64: equal flags and every state field within 1e-10 of
    its scale, the dead elements' triaxiality included (the packed loop
    would report 0 there)."""
    jm, tm = _both(lambda s: s.bar_model(4, 4, 16, d_time=5e-8,
                                         end_time=4e-5, ductile=True),
                   "float64", energy_check=True)
    js, ts = jax_init_state(jm), init_state(tm)
    for c in range(6):
        js, ts = jax_run_chunk(jm, js, 50), run_chunk(tm, ts, 50)
        np.testing.assert_array_equal(ts.element_flag.numpy(),
                                      np.asarray(js.element_flag))
        _compare(js, ts, {"*": 1e-10})
    dead = ~ts.element_flag.numpy()[:tm.n_element]
    assert dead.any()
    jt = np.asarray(js.triax)[:, :tm.n_element][:, dead]
    tt = ts.triax.numpy()[:, :tm.n_element][:, dead]
    assert np.abs(jt).max() > 0.1
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-10 * np.abs(jt).max())
    assert not ts.stress.numpy()[..., :tm.n_element][..., dead].any()


def test_mixed_ductile_erosion_generic():
    """The ductile 4x4x16 bar in mixed precision to step 600 in chunks of
    50, each package on its own lowering (generic step: positions cast to
    f32 before the gather and the centring).  Deletion flags equal after
    every chunk; each field within 10x the f32 envelope (JAX mixed vs JAX
    f64, floored at f32's unit roundoff); the dead elements' triaxiality
    within 1e-4 of its scale."""
    build = (lambda s: s.bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4,
                                   ductile=True))
    jm, tm = _both(build, "mixed", energy_check=True)
    j64 = jax_lower(build(jsyn), JConfig(dtype="float64", energy_check=True))
    js, js64, ts = jax_init_state(jm), jax_init_state(j64), init_state(tm)
    for c in range(1, 13):
        js, js64 = jax_run_chunk(jm, js, 50), jax_run_chunk(j64, js64, 50)
        ts = run_chunk(tm, ts, 50)
        np.testing.assert_array_equal(ts.element_flag.numpy(),
                                      np.asarray(js.element_flag),
                                      err_msg=f"step {50 * c}")
        for name in STATE:
            env = max(_rel(getattr(js, name), getattr(js64, name)),
                      2.0 ** -23)
            err = _rel(getattr(ts, name).numpy(), getattr(js, name))
            assert err <= 10 * env, (50 * c, name, err, env)
    dead = ~ts.element_flag.numpy()[:tm.n_element]
    assert dead.any()
    jt = np.asarray(js.triax)[:, :tm.n_element][:, dead]
    np.testing.assert_allclose(ts.triax.numpy()[:, :tm.n_element][:, dead],
                               jt, rtol=0, atol=1e-4 * np.abs(jt).max())
    assert ts.stress.dtype == torch.float32 and ts.disp.dtype == torch.float64


def test_self_contact_generic_f64():
    """The self-contact plates, each package on its own lowering (32
    elements: both take the generic step), 300 f64 steps in chunks of 50:
    disp, stress and eq_ps within 1e-9 normwise, and contact fires."""
    jm, tm = _both(lambda s: s.self_contact_model(), "float64",
                   energy_check=True)
    assert len(tm.pairs) == 1 and tm.pairs[0].is_self
    js, ts = jax_init_state(jm), init_state(tm)
    fired = False
    for _ in range(6):
        js, ts = jax_run_chunk(jm, js, 50), run_chunk(tm, ts, 50)
        for name in ("disp", "stress", "eq_ps", "contact_force"):
            assert _rel(getattr(ts, name).numpy(), getattr(js, name)) < 1e-9
        fired |= bool(ts.contact_force.abs().max() > 0)
    assert fired


def test_gather_mode_xla_bar_generic():
    """The 8x8x32 bar (2,048 elements) lowered with ``gather_mode="xla"``:
    neither lowering pads, renumbers or forms ``coord_e``, so both take the
    generic step; 60 plastic f64 steps within 1e-10 of each field's
    scale."""
    jm, tm = _both(lambda s: s.bar_model(8, 8, 32, d_time=5e-8,
                                         end_time=1e-4), "float64",
                   gather_mode="xla")
    assert tm.E == jm.E == 2048 and tm.node_new2old is None
    assert tm.coord_e is None and jm.coord_e is None
    js = jax_run_chunk(jm, jax_init_state(jm), 60)
    ts = run_chunk(tm, init_state(tm), 60)
    assert float(np.asarray(js.eq_ps).max()) > 0
    _compare(js, ts, {"*": 1e-10})


@pytest.mark.parametrize("shape,gather_mode", [
    ((8, 8, 31), "auto"), ((8, 8, 32), "auto"), ((4, 4, 128), "auto"),
    ((8, 8, 32), "xla"), ((4, 4, 127), "auto")])
def test_dispatch_rule(monkeypatch, shape, gather_mode):
    """``coord_e`` is None in the port's lowering exactly when it is in the
    JAX lowering (a mesh of 2,048 elements and 2,048 nodes, unless
    ``gather_mode="xla"``), equal to it where both form it, and
    ``run_chunk`` takes the generic step exactly then."""
    jm, tm = _both(lambda s: s.bar_model(*shape), "float32",
                   gather_mode=gather_mode)
    assert (tm.coord_e is None) == (jm.coord_e is None)
    assert (tm.coord_e is None) == (gather_mode == "xla"
                                    or tm.n_element < 2048)
    if tm.coord_e is not None:
        assert torch.equal(tm.coord_e, torch.from_numpy(
            np.array(jm.coord_e)))
    calls = []

    def counted(m, s, comm=None, carry=None):
        calls.append(int(s.t))
        return step(m, s, comm, carry)
    step = texplicit.step
    monkeypatch.setattr(texplicit, "step", counted)
    run_chunk(tm, init_state(tm), 2)
    assert len(calls) == (2 if tm.coord_e is None else 0)


@pytest.mark.parametrize("shape", [(4, 4, 16), (8, 8, 32)])
def test_element_kernel_xla_runs(shape):
    """``element_kernel="xla"`` reaches the same kernels as ``"auto"`` on
    both loops (generic below 2,048 elements, packed at 2,048): bitwise
    equal states after 30 steps, f32."""
    out = []
    for ek in ("auto", "xla"):
        m = lower(tsyn.bar_model(*shape, d_time=5e-8, end_time=1e-4),
                  SolverConfig(dtype="float32", element_kernel=ek),
                  device="cpu")
        out.append(run_chunk(m, init_state(m), 30))
    assert (m.coord_e is None) == (shape == (4, 4, 16))
    for f in dataclasses.fields(out[0]):
        assert torch.equal(getattr(out[0], f.name),
                           getattr(out[1], f.name)), f.name
    assert torch.equal(pack_gauss_state(out[0]), pack_gauss_state(out[1]))
