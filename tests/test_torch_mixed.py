"""Mixed precision (float64 nodal state, float32 element math) in the port
against the JAX package: the plain element twin against the TPU kernels of
the mixed path in Pallas interpret mode, and the ductile bar's chunk loop
with fracture."""
import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.pre.synthetic import bar_model
from hakai_tpu.solver.explicit import run_chunk as jax_run_chunk
from hakai_tpu_torch import run_chunk
from hakai_tpu_torch.core.lowering import lower
from hakai_tpu_torch.ops.element_cuda import packed_element_step
from test_torch_slice import carried, jax_fast_model, port_fast_model

STATE = ("disp", "disp_pre", "velo", "Q", "stress", "strain", "eq_ps",
         "yield_s", "triax", "work")


@pytest.mark.parametrize("element_kernel", ["auto", "pallas"])
def test_plain_twin_matches_mixed_kernels(element_kernel):
    """bar_model(4, 4, 64, ductile=True) in mixed (1,024 elements, one
    tile).  The seeded float64 disp/dprev reach the JAX kernel through its
    own glue (packed_element_step: pos24/du24 formed in float64 and cast),
    which runs the MXU kernel's plain call with the triaxiality output
    ("auto", kernel #2) or the VPU packed kernel, whose triaxiality the
    epilogue forms afterwards ("pallas", kernel #4), in interpret mode, then
    the fracture epilogue.  The port's packed_element_step takes the nodal
    arrays.  Tolerance rtol=3e-5, atol=3e-4: the bound test_element.py
    holds the MXU kernel to against the XLA math."""
    import jax.numpy as jnp

    from hakai_tpu.ops.element_pallas import \
        packed_element_step as jax_packed_element_step
    bar = bar_model(4, 4, 64, d_time=5e-8, end_time=1e-4, ductile=True)
    cfg = SolverConfig(dtype="mixed", element_kernel=element_kernel)
    jm = jax_fast_model(bar, cfg)
    tm = port_fast_model(bar, cfg)
    E, N = tm.E, tm.N
    assert E == 1024 and jm.fracture_enabled and tm.fracture_enabled
    rng = np.random.default_rng(23)
    disp = rng.normal(scale=1e-3, size=(3, N))
    dprev = disp + rng.normal(scale=2e-4, size=(3, N))
    P = np.concatenate([rng.normal(scale=300.0, size=(48, E)),
                        rng.normal(scale=1e-3, size=(6, E)), np.zeros((2, E)),
                        rng.uniform(0.0, 1.2, (8, E)),
                        755.0 + rng.uniform(0.0, 300.0, (8, E))]
                       ).astype(np.float32)
    flag = np.ones(E, bool)
    flag[[3, 700]] = False
    elem = np.asarray(jm.elem)

    P_ref, qe_ref, tri_ref, flag_ref = (np.asarray(x) for x in
                                        jax_packed_element_step(
        jm, jm.coord_e, jnp.asarray(disp[:, elem]),
        jnp.asarray(dprev[:, elem]), jnp.asarray(P), jnp.asarray(flag)))
    P_new, qe, tri, flag_new = (x.numpy() for x in packed_element_step(
        tm, torch.from_numpy(P), torch.from_numpy(flag),
        torch.from_numpy(disp), torch.from_numpy(dprev)))
    assert P_new.dtype == qe.dtype == tri.dtype == np.float32
    plastic = (P_ref[56:64] != P[56:64]).mean()
    assert 0.05 < plastic < 0.95, plastic
    tol = dict(rtol=3e-5, atol=3e-4)
    np.testing.assert_allclose(qe, qe_ref, **tol)
    np.testing.assert_allclose(P_new, P_ref, **tol)
    np.testing.assert_allclose(tri, tri_ref, **tol)
    np.testing.assert_array_equal(flag_new, flag_ref)
    assert 0 < (flag & ~flag_new).sum() < flag.sum()   # some erode
    assert not tri[:, ~flag].any() and not qe[:, ~flag].any()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_ductile_bar_mixed_matches_jax():
    """The ductile 4x4x16 bar (d_time=5e-8) for 600 steps in chunks of 50
    through the port's run_chunk (CPU) and the JAX run_chunk (CPU, its
    packed chunk loop), from the same carried model and state.

    Deletion flags must be equal after every chunk, and the first
    deletions fall between steps 400 and 500.  The state must stay within
    the float32 envelope: at every chunk, each field's normwise distance
    port-vs-JAX is at most 10x the distance between the JAX mixed run and
    the JAX float64 run at that chunk (floored at float32's unit roundoff).
    Measured on this bar to step 600: port-vs-JAX is 0.3-1.3x that
    envelope (e.g. stress 1.4e-6 vs 1.2e-6, triax 1.1e-5 vs 8.4e-6)."""
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4, ductile=True)
    jm = jax_fast_model(bar, SolverConfig(dtype="mixed", energy_check=True))
    j64 = jax_fast_model(bar, SolverConfig(dtype="float64",
                                           energy_check=True))
    js, js64 = jax_init_state(jm), jax_init_state(j64)
    tm, ts = carried(jm, js)
    assert tm.dtype == torch.float64 and tm.edtype == torch.float32
    first = None
    for c in range(1, 13):
        js = jax_run_chunk(jm, js, 50)
        js64 = jax_run_chunk(j64, js64, 50)
        ts = run_chunk(tm, ts, 50)
        flag = ts.element_flag.numpy()
        np.testing.assert_array_equal(flag, np.asarray(js.element_flag),
                                      err_msg=f"step {50 * c}")
        if first is None and not flag[:tm.n_element].all():
            first = 50 * c
        for name in STATE:
            env = max(_rel(getattr(js, name), getattr(js64, name)),
                      2.0 ** -23)
            err = _rel(getattr(ts, name).numpy(), getattr(js, name))
            assert err <= 10 * env, (50 * c, name, err, env)
    assert first is not None and 400 < first <= 500, first
    # tests/test_mixed_precision.py's dtypes
    assert ts.disp.dtype == ts.Q.dtype == torch.float64
    assert ts.stress.dtype == torch.float32
    assert int(ts.t) == 600
