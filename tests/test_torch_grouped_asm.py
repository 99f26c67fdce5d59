"""TPU kernels #9/#10 (``blocked_assemble``, the grouped
gather-and-accumulate) on the CPU: the port's plan and plain version
against the JAX package's ``plan_assemble`` + ``blocked_assemble`` (its XLA
fallback off the TPU, as its own tests run it), the node-block-major
grouping of an incidence table against the port's assembly, and a model
carrying a grouped ``plan_asm`` stepped by both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.ops.gather_pallas import blocked_assemble as jax_blocked
from hakai_tpu.ops.gather_pallas import plan_assemble as jax_plan
from hakai_tpu.pre.synthetic import bar_model
from hakai_tpu.solver.explicit import run_chunk as jax_run_chunk
from hakai_tpu_torch import lower, run_chunk
from hakai_tpu_torch.ops.assemble_cuda import (assemble_internal_force,
                                               blocked_assemble,
                                               blocked_assemble_plain,
                                               plan_assemble)
from hakai_tpu_torch.ops.element import assemble_internal_force_plain
from test_torch_cuda import node_block_grouping
from test_torch_slice import carried

# relative to the output's scale: a sum of vl <= 4 terms in another
# association order (XLA's reduction against l = 0..vl-1)
TOL = {"float32": 1e-6, "float64": 1e-14}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_blocked_assemble_matches_jax(dtype):
    """Seeded random indices, a third of them masked, into a (3, 8192)
    source; 3 output tiles of vl = 4 tiles each, the last one ragged."""
    rng = np.random.default_rng(9)
    S, vl, r_tile = 8192, 4, 2048
    n = 3 * vl * r_tile - 700
    idx = rng.integers(0, S, n)
    mask = rng.random(n) > 1 / 3
    src = rng.normal(scale=100.0, size=(3, S)).astype(dtype)
    ref = np.asarray(jax_blocked(jnp.asarray(src),
                                 jax_plan(idx, mask, S, vl, r_tile)))
    plan = plan_assemble(idx, mask, S, vl, r_tile)
    assert plan.r_pad == 3 * vl * r_tile and plan.idx.dtype == torch.int32
    got = blocked_assemble(torch.from_numpy(src), plan)
    assert got.dtype == torch.from_numpy(src).dtype
    assert got.shape == ref.shape == (3, 3 * r_tile)
    assert _rel(got, ref) <= TOL[dtype]
    assert torch.equal(got, blocked_assemble_plain(torch.from_numpy(src),
                                                   plan))


def test_plan_refuses_what_it_cannot_group():
    with pytest.raises(ValueError, match="group"):
        plan_assemble(np.zeros(3 * 128, int), np.ones(3 * 128, bool), 64,
                      vl=2, r_tile=128)
    with pytest.raises(ValueError, match="outside"):
        plan_assemble(np.array([0, 64]), np.ones(2, bool), 64, vl=1)


def test_node_block_grouping_is_the_assembly():
    """The node-block-major grouping of a bar's incidence table gives,
    bit for bit in f64, the Q of the port's assembly; a model carrying the
    plan assembles through it."""
    tm = lower(bar_model(4, 4, 16), SolverConfig(dtype="float64"),
               device="cpu")
    V = tm.inc_idx.shape[0]
    qe = torch.from_numpy(np.random.default_rng(3).normal(
        scale=100.0, size=(24, tm.E)))
    idx, mask = node_block_grouping(tm.inc_idx.numpy(), tm.inc_mask.numpy(),
                                    128)
    plan = plan_assemble(idx, mask, 8 * tm.E, vl=V, r_tile=128)
    ref = assemble_internal_force_plain(tm, qe)
    got = blocked_assemble(qe.reshape(3, 8 * tm.E), plan)[:, :tm.N]
    assert torch.equal(got, ref)
    grouped = dataclasses.replace(tm, plan_asm=plan)
    assert torch.equal(assemble_internal_force(grouped, qe), ref)
    assert torch.equal(grouped.to("cpu").plan_asm.idx, plan.idx)


def test_grouped_plan_run_matches_jax():
    """50 generic f64 steps of the ductile 4x4x16 bar with a grouped
    ``plan_asm`` in both packages (JAX: ``plan_assemble``, vl = V, through
    its ``blocked_assemble``): disp within 1e-10 of its scale, and the
    port's run bitwise equal to its run without the plan."""
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=4e-5, ductile=True)
    jm = jax_lower(bar, SolverConfig(dtype="float64"))
    tm, ts = carried(jm, jax_init_state(jm))
    assert jm.coord_e is None and jm.plan_asm is None
    V = tm.inc_idx.shape[0]
    idx, mask = node_block_grouping(np.asarray(jm.inc_idx),
                                    np.asarray(jm.inc_mask), 2048)
    jg = dataclasses.replace(jm, plan_asm=jax_plan(idx, mask, 8 * jm.E, V))
    tg = dataclasses.replace(tm, plan_asm=plan_assemble(idx, mask,
                                                        8 * tm.E, V))
    js = jax_run_chunk(jg, jax_init_state(jg), 50)
    got = run_chunk(tg, ts, 50)
    ref = np.asarray(js.disp)
    assert np.abs(got.disp.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    assert torch.equal(got.disp, run_chunk(tm, ts, 50).disp)
