"""The whole slice: the port's run_chunk against the JAX package's, with the
JAX model and initial state carried across by the port's converters
(model_from_numpy, state_from_numpy)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.pre.synthetic import bar_model
from hakai_tpu.solver.explicit import run_chunk as jax_run_chunk
from hakai_tpu_torch import init_state, lower, run_chunk
from hakai_tpu_torch.core.lowering import model_from_numpy
from hakai_tpu_torch.core.state import SimState, state_from_numpy
from hakai_tpu_torch.solver.explicit import pack_gauss_state
from test_torch_cuda import port_fast_model

STATE = ("disp", "disp_pre", "velo", "Q", "stress", "strain", "eq_ps",
         "yield_s", "triax", "work")

# The port's CPU tests step meshes of a few hundred elements, where
# PyTorch's intra-op threads cost more in synchronization than they save
# (about 3x per step on an 8-core machine, far more when test processes
# share the cores): one thread per process.
torch.set_num_threads(1)


def _numpy_fields(obj):
    """(fields, static) of a JAX dataclass: arrays as NumPy, static
    metadata as is (gather plans and other objects left out)."""
    fields, static = {}, {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.metadata.get("static"):
            static[f.name] = v
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            fields[f.name] = np.asarray(v)
    return fields, static


def jax_model_numpy(jm):
    """(fields, static) of a JAX LoweredModel as NumPy arrays / values;
    its contact pairs as one mapping each under fields["pairs"]."""
    fields, static = _numpy_fields(jm)
    fields["pairs"] = [{**b, **a} for a, b in map(_numpy_fields, jm.pairs)]
    return fields, static


def jax_fast_model(bar, cfg):
    """The JAX lowering of ``bar`` with ``coord_e`` formed as that lowering
    forms it on meshes of 2,048 elements and more (f64 difference, then
    the element dtype).  With it the JAX ``run_chunk`` takes its packed
    chunk loop (``step_fast``: deferred erosion zeroing, triaxiality masked
    by the pre-erosion flag) also on a mesh too small for window plans;
    without it the JAX package takes its generic ``step()``, which reports
    a dead element's triaxiality from its trial stress instead of 0.  The
    port's twin is ``port_fast_model``: the two hold the packed loops
    against each other on small meshes."""
    jm = jax_lower(bar, cfg)
    coord, elem = np.asarray(jm.coord, np.float64), np.asarray(jm.elem)
    return dataclasses.replace(jm, coord_e=jnp.asarray(
        coord[:, elem] - coord[:, elem[0]][:, None, :], jm.edtype))


def carried(jm, js, device="cpu"):
    """The port's model and state built from the JAX ones."""
    tm = model_from_numpy(*jax_model_numpy(jm), device)
    ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                           for f in dataclasses.fields(SimState)},
                          tm.dtype, device, tm.edtype)
    return tm, ts


def _compare(js, ts, rel):
    """max|port - jax| <= rel[name] * max|jax| for each state field."""
    for name in STATE:
        ref = np.asarray(getattr(js, name), np.float64)
        got = getattr(ts, name).numpy().astype(np.float64)
        assert got.shape == ref.shape, name
        scale = max(np.abs(ref).max(), 1e-300)
        err = np.abs(got - ref).max() / scale
        assert err <= rel.get(name, rel["*"]), (name, err)


def test_run_chunk_matches_jax_f64():
    """100 plastic steps in f64 with the energy balance on, from the JAX
    model carried across: no window plans at this size, so neither model
    has ``coord_e`` and both take the generic step.  Same math, other
    summation orders: near roundoff."""
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4)
    cfg = SolverConfig(dtype="float64", energy_check=True)
    jm = jax_lower(bar, cfg)
    js0 = jax_init_state(jm)
    tm, ts0 = carried(jm, js0)
    assert jm.coord_e is None and tm.coord_e is None
    js = jax_run_chunk(jm, js0, 100)
    ts = run_chunk(tm, ts0, 100)
    assert float(np.asarray(js.eq_ps).max()) > 0.01     # plasticity engaged
    assert int(ts.t) == 100
    _compare(js, ts, {"*": 1e-10})


def test_run_chunk_matches_jax_fused_mxu_f32(monkeypatch):
    """f32, 8x8x32 bar: the JAX run takes the main path of bench.py (fused
    MXU Pallas kernel with the in-kernel gather, interpret mode here).
    Both run f32 with other contraction orders; over 3 steps the parting
    stays within a few hundred ulps of each field's scale."""
    monkeypatch.setenv("HAKAI_PALLAS_FORCE", "1")
    bar = bar_model(8, 8, 32, d_time=5e-8, end_time=1e-4)
    cfg = SolverConfig(dtype="float32")
    jm = jax_lower(bar, cfg)
    assert jm.plan_gphys is not None
    js0 = jax_init_state(jm)
    tm, ts0 = carried(jm, js0)
    js = jax_run_chunk(jm, js0, 3)
    ts = run_chunk(tm, ts0, 3)
    _compare(js, ts, {"*": 2e-5, "triax": 1e-4})


def test_converters_match_port_lowering():
    bar = bar_model(8, 8, 32, d_time=1e-8, end_time=1.0)
    cfg = SolverConfig(dtype="float32")
    jm = jax_lower(bar, cfg)
    tm, ts = carried(jm, jax_init_state(jm))
    pm = lower(bar, cfg, device="cpu")
    for f in dataclasses.fields(pm):
        a, b = getattr(tm, f.name), getattr(pm, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    ps = init_state(pm)
    for f in dataclasses.fields(ps):
        a, b = getattr(ts, f.name), getattr(ps, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_determinism_bitwise():
    m = lower(bar_model(8, 8, 32, d_time=5e-8, end_time=1e-4),
              SolverConfig(dtype="float32"), device="cpu")
    a = run_chunk(m, init_state(m), 20)
    b = run_chunk(m, init_state(m), 20)
    for name in STATE:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("split", [(10, 0), (4, 6)])
def test_chunks_compose(split):
    """On the packed loop, run_chunk(k1) then run_chunk(k2) equals
    run_chunk(k1 + k2) bitwise (the chunk-exit zeroing and triax are pure
    functions of the state)."""
    m = port_fast_model(bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4),
                        SolverConfig(dtype="float32"))
    whole = run_chunk(m, init_state(m), sum(split))
    parts = run_chunk(m, run_chunk(m, init_state(m), split[0]), split[1])
    P1, P2 = pack_gauss_state(whole), pack_gauss_state(parts)
    assert torch.equal(P1, P2)
    for name in ("disp", "velo", "Q", "triax"):
        assert torch.equal(getattr(whole, name), getattr(parts, name)), name
