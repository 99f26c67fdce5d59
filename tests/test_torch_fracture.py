"""Ductile fracture in float64: the port's chunk loop against the JAX
package's on the ductile bar, deletion by deletion."""
import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.pre.synthetic import bar_model
from hakai_tpu.solver.explicit import run_chunk as jax_run_chunk
from hakai_tpu_torch import init_state, lower, run_chunk
from hakai_tpu_torch.solver.explicit import pack_gauss_state
from test_torch_slice import (STATE, _compare, carried, jax_fast_model,
                              port_fast_model)


def test_ductile_bar_f64_matches_jax():
    """The ductile 4x4x16 bar (d_time=5e-8) for 600 steps in chunks of 50:
    deletion flags exactly equal after every chunk, and every state field
    within 1e-10 of its scale (the f64 bound of the fracture-free slice;
    measured here: at most 5e-12, for triax after the deletions)."""
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4, ductile=True)
    jm = jax_fast_model(bar, SolverConfig(dtype="float64",
                                          energy_check=True))
    js = jax_init_state(jm)
    tm, ts = carried(jm, js)
    for c in range(1, 13):
        js = jax_run_chunk(jm, js, 50)
        ts = run_chunk(tm, ts, 50)
        np.testing.assert_array_equal(ts.element_flag.numpy(),
                                      np.asarray(js.element_flag),
                                      err_msg=f"step {50 * c}")
        _compare(js, ts, {"*": 1e-10})
    alive = int(ts.element_flag.sum())
    assert 0 < alive < tm.n_element                   # some elements died
    dead = ~ts.element_flag
    assert not ts.stress[..., dead].any() and not ts.strain[:, dead].any()


@pytest.mark.parametrize("split", [(450, 100), (480, 40)])
def test_fracture_chunks_compose(split):
    """Across the first deletions, on the packed loop, run_chunk(k1) then
    run_chunk(k2) equals run_chunk(k1 + k2) bitwise: a dead element's stale
    stress only feeds values that its flag masks, so zeroing it at a chunk
    exit changes nothing that lives on."""
    m = port_fast_model(bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4,
                                  ductile=True), SolverConfig(dtype="mixed"))
    whole = run_chunk(m, init_state(m), sum(split))
    parts = run_chunk(m, run_chunk(m, init_state(m), split[0]), split[1])
    assert not whole.element_flag[:m.n_element].all()
    assert torch.equal(pack_gauss_state(whole), pack_gauss_state(parts))
    for name in STATE + ("element_flag",):
        assert torch.equal(getattr(whole, name), getattr(parts, name)), name
