"""The port's plain internal-force assembly against the JAX package's
assemble_internal_force and against a direct scatter (np.add.at)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.ops.element import assemble_internal_force as jax_assemble
from hakai_tpu.pre.synthetic import bar_model
from hakai_tpu_torch import _build
from hakai_tpu_torch.core.lowering import lower
from hakai_tpu_torch.ops.assemble_cuda import assemble_internal_force
from hakai_tpu_torch.ops.element import assemble_internal_force_plain


def _qe(E, n_element, dtype, seed=4):
    qe = np.random.default_rng(seed).normal(scale=100.0, size=(3, 8, E))
    qe[..., n_element:] = 0.0                # padding elements: no force
    return qe.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_matches_jax(dtype):
    """Both sum each node's incident entries in the incidence table's
    order; the tolerance allows another summation order in the reduction
    over V <= 8 terms (a few ulps of the largest term)."""
    bar = bar_model(4, 4, 16)
    cfg = SolverConfig(dtype=dtype, elem_pad=64)
    jm, tm = jax_lower(bar, cfg), lower(bar, cfg, device="cpu")
    qe = _qe(tm.E, tm.n_element, np.dtype(dtype))
    ref = np.asarray(jax_assemble(jm, jnp.asarray(qe)))
    got = assemble_internal_force_plain(
        tm, torch.from_numpy(qe.reshape(24, tm.E))).numpy()
    assert got.dtype == ref.dtype and got.shape == (3, tm.N)
    eps = np.finfo(np.dtype(dtype)).eps
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=8 * eps * np.abs(qe).max())


def test_plain_matches_scatter():
    """f64: the gather-sum equals the scatter-add it replaces."""
    tm = lower(bar_model(8, 8, 32), SolverConfig(dtype="float64"),
               device="cpu")
    qe = _qe(tm.E, tm.n_element, np.float64, seed=8)
    elem = tm.elem.numpy()
    ref = np.zeros((3, tm.N))
    for b in range(3):
        np.add.at(ref[b], elem[:, :tm.n_element].reshape(-1),
                  qe[b, :, :tm.n_element].reshape(-1))
    got = assemble_internal_force_plain(
        tm, torch.from_numpy(qe.reshape(24, tm.E))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())
    assert not got[:, tm.n_node:].any()


def test_wrapper_runs_plain_version_on_cpu():
    tm = lower(bar_model(4, 4, 16), SolverConfig(dtype="float32"),
               device="cpu")
    qe = torch.from_numpy(_qe(tm.E, tm.n_element, np.float32)
                          .reshape(24, tm.E))
    before = _build.LAUNCHES.copy()
    Q = assemble_internal_force(tm, qe)
    assert _build.LAUNCHES == before                # no kernel launched
    assert torch.equal(Q, assemble_internal_force_plain(tm, qe))
    with pytest.raises(ValueError, match="no assembly kernel"):
        assemble_internal_force(tm.to("meta"), qe.to("meta"))
