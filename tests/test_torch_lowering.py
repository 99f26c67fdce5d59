"""The port's NumPy lowering (hakai_tpu_torch.core.lowering) against the
JAX lowering (hakai_tpu.core.lowering), field by field.

Both lower the same synthetic bar; every array the port keeps must equal
the JAX one exactly (same numbering, padding, dtype rounding).
"""
import dataclasses

import numpy as np
import pytest
import torch

from hakai_tpu.config import SolverConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.pre.synthetic import bar_model, impact_model
from hakai_tpu_torch import run, run_chunk
from hakai_tpu_torch.core.lowering import lower
from hakai_tpu_torch.core.state import init_state

FIELDS = ("coord", "elem", "elem_exists", "node_exists", "diag_M",
          "inc_idx", "inc_mask", "mat_id", "G_e", "lam_e", "has_plastic_e",
          "yield0_e", "bcd_mask", "bcd_value", "bcd_amp", "amp_time",
          "amp_value", "amp_n", "velo0", "vol_e")
STATIC = ("n_node", "n_element", "N", "E", "dt", "end_time", "time_num",
          "mass_scaling", "element_min_size", "element_max_size", "cfl_dt",
          "pl_tables")


@pytest.mark.parametrize("shape,dtype,renumber,renumbered", [
    ((4, 4, 16), "float64", "auto", False),   # small: deck order
    ((8, 8, 32), "float32", "auto", True),    # >= 2048 elements and nodes
    ((8, 8, 32), "float32", "off", False),
])
def test_lowering_matches_jax(shape, dtype, renumber, renumbered):
    bar = bar_model(*shape, d_time=1e-8, end_time=1.0)
    cfg = SolverConfig(dtype=dtype, renumber=renumber)
    ref = jax_lower(bar, cfg)
    got = lower(bar, cfg, device="cpu")
    assert (got.node_new2old is not None) == renumbered
    for name in STATIC:
        assert getattr(got, name) == getattr(ref, name), name
    for name in FIELDS:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.shape == b.shape, name
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert (got.node_new2old is None) == (ref.node_new2old is None)
    if ref.node_new2old is not None:
        np.testing.assert_array_equal(got.node_new2old.numpy(),
                                      np.asarray(ref.node_new2old))
        np.testing.assert_array_equal(got.elem_new2old.numpy(),
                                      np.asarray(ref.elem_new2old))
    # built only with window plans, in both lowerings
    assert (got.coord_e is None) == (ref.coord_e is None) == (shape[0] == 4)
    if ref.coord_e is not None:
        np.testing.assert_array_equal(got.coord_e.numpy(),
                                      np.asarray(ref.coord_e))
        assert got.coord_e[:, 0].abs().max().item() == 0.0


def test_hardening_tables_from_pl_tables():
    got = lower(bar_model(4, 4, 16), SolverConfig(dtype="float64"),
                device="cpu")
    tab = np.asarray(got.pl_tables[0])
    n = len(tab)
    assert got.hard_n.tolist() == [n]
    np.testing.assert_array_equal(got.hard_strain[0, :n].numpy(), tab[:, 1])
    slope = np.diff(tab[:, 0]) / np.diff(tab[:, 1])
    np.testing.assert_allclose(got.hard_slope[0, :n - 1].numpy(), slope,
                               rtol=1e-15)


def test_to_moves_every_tensor():
    got = lower(bar_model(4, 4, 16), SolverConfig(dtype="float32"),
                device="cpu")
    moved = got.to("meta")
    for f in dataclasses.fields(moved):
        v = getattr(moved, f.name)
        if isinstance(v, torch.Tensor):
            assert v.device.type == "meta", f.name
    assert moved.N == got.N and moved.pl_tables == got.pl_tables
    state = init_state(got).to("meta")
    assert all(getattr(state, f.name).device.type == "meta"
               for f in dataclasses.fields(state))


@pytest.mark.parametrize("shape", [(4, 4, 16), (8, 8, 32)])
def test_mixed_ductile_lowering_matches_jax(shape):
    """Mixed precision with a ductile table: the float64/float32 split of
    every field, the static ductile tables and the fracture flag equal the
    JAX lowering's; at 8x8x32 (window plans on) coord_e too."""
    bar = bar_model(*shape, d_time=5e-8, end_time=1e-4, ductile=True)
    cfg = SolverConfig(dtype="mixed")
    ref = jax_lower(bar, cfg)
    got = lower(bar, cfg, device="cpu")
    assert got.dtype == torch.float64 and got.edtype == torch.float32
    assert got.fracture_enabled and ref.fracture_enabled
    assert got.du_tables == ref.du_tables == (((1.0, 0.0), (0.3, 0.3)),)
    for name in STATIC:
        assert getattr(got, name) == getattr(ref, name), name
    for name in FIELDS:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert (got.coord_e is None) == (ref.coord_e is None) == (shape[0] == 4)
    if ref.coord_e is not None:
        np.testing.assert_array_equal(got.coord_e.numpy(),
                                      np.asarray(ref.coord_e))
        assert got.coord_e.dtype == torch.float32
    assert got.dt_t.dtype == torch.float64
    state = init_state(got)
    assert state.disp.dtype == state.Q.dtype == state.work.dtype \
        == torch.float64
    assert state.stress.dtype == state.yield_s.dtype == torch.float32


@pytest.mark.parametrize("case", ["halo", "fracture", "mixed"])
def test_unported_features_raise(case, tmp_path, monkeypatch):
    """The node-sharded halo decomposition refuses what the JAX package
    refuses, before any rank starts: a padded node count that the shard
    count does not divide (a contact deck), and a shard-major checkpoint of
    another partition geometry (a fracture deck).  ``run(devices=2,
    halo=2)`` takes the halo path, as in the JAX package (a mixed deck)."""
    from hakai_tpu_torch.parallel import halo as thalo
    if case == "halo":
        m = lower(impact_model(n=2), SolverConfig(), device="cpu")
        assert m.N % 7
        with pytest.raises(ValueError, match="not divisible by 7"):
            run(m, halo=7, device="cpu", write_output=False)
    elif case == "fracture":
        m = lower(bar_model(ductile=True), SolverConfig(), device="cpu")
        hm = thalo.partition(m, 2)
        path = str(tmp_path / "ckpt.npz")
        thalo.save_halo_checkpoint(path, hm, thalo.init_halo_state(hm))
        with pytest.raises(ValueError, match="does not match the current "
                                             "partition"):
            run(m, halo=4, resume_halo=path, device="cpu",
                write_output=False)
    else:
        m = lower(bar_model(d_time=5e-8),
                  SolverConfig(dtype="mixed", element_kernel="xla"),
                  device="cpu")
        run_chunk(m, init_state(m), 1)
        calls = []

        def run_halo(*args):
            calls.append(args)
            return init_state(m), {}
        monkeypatch.setattr(thalo, "run_halo", run_halo)
        run(m, devices=2, halo=2, device="cpu", write_output=False)
        assert len(calls) == 1 and calls[0][2] == 2
