"""The port's contact lowering against the JAX lowering, pair by pair and
field by field (bitwise), and its two flat contact tables against their
definition."""
import dataclasses

import numpy as np
import pytest

from hakai_tpu.config import SolverConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.io.inp import parse_inp_lines
from hakai_tpu.pre import synthetic as jsyn
from hakai_tpu_torch.core.lowering import lower
from hakai_tpu_torch.io import model as tmodel
from hakai_tpu_torch.pre import synthetic as tsyn
from test_oracle_diff import _cp_deck_lines

ARRAYS = ("tri_nodes", "tri_elem", "tri_init", "tri_twin", "cand_nodes",
          "cand_init", "cand_twin", "jnode_nodes", "jnode_init",
          "jnode_twin", "tri_enodes", "cand_mass")
STATIC = ("i_instance", "j_instance", "is_self", "young", "tri_capacity",
          "node_capacity", "jnode_capacity", "static_activity")


def to_port_model(obj):
    """A JAX-package model object copied into the port's dataclasses."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(tmodel, type(obj).__name__)
        return cls(**{f.name: to_port_model(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [to_port_model(x) for x in obj]
    return obj


DECKS = {
    "impact-f64": (lambda s: s.impact_model(n=3), "float64"),
    "impact-mixed": (lambda s: s.impact_model(n=3), "mixed"),
    # 2,304 elements: renumbered, as the full-width deck is
    "impact-renumbered": (lambda s: s.impact_model(n=12), "mixed"),
    "self-contact": (lambda s: s.self_contact_model(n=3), "float64"),
    "contact-pair": (None, "float64"),
}


def _lowered(name):
    build, dtype = DECKS[name]
    cfg = SolverConfig(dtype=dtype)
    if build is None:                      # the *Contact Pair deck
        jmodel = parse_inp_lines(_cp_deck_lines())
        assert len(jmodel.cps) == 1
        tmodel_ = to_port_model(jmodel)
    else:
        jmodel, tmodel_ = build(jsyn), build(tsyn)
    return jax_lower(jmodel, cfg), lower(tmodel_, cfg, device="cpu")


@pytest.mark.parametrize("name", sorted(DECKS))
def test_contact_pairs_match_jax(name):
    ref, got = _lowered(name)
    assert got.contact_flag == ref.contact_flag > 0
    assert len(got.pairs) == len(ref.pairs) > 0
    for rp, gp in zip(ref.pairs, got.pairs):
        for f in STATIC:
            assert getattr(gp, f) == getattr(rp, f), f
        for f in ARRAYS:
            a, b = getattr(rp, f), getattr(gp, f)
            if a is None:
                assert b is None, f
                continue
            assert b.is_contiguous(), f      # the kernels index densely
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b, a, err_msg=f)
    if name.startswith("impact-"):
        assert got.pairs[0].cand_mass.dtype == got.edtype
        assert (got.node_new2old is not None) == (name == "impact-renumbered")


@pytest.mark.parametrize("name", ["impact-f64", "self-contact"])
def test_contact_tables(name):
    """ckin_idx is every pair's (tri_nodes[0], [1], [2], cand_nodes,
    jnode_nodes) concatenated, with its slices; node n's force-table row
    lists its candidate slots (pair order) and then the triangles it is a
    vertex of, in (pair, vertex, triangle) order."""
    _, m = _lowered(name)
    segs, k = [], 0
    for p, sl in zip(m.pairs, m.ckin_slices):
        for s, (a, b) in zip((*p.tri_nodes, p.cand_nodes, p.jnode_nodes), sl):
            assert (a, b) == (k, k + len(s))
            segs.append(s.numpy())
            k = b
    np.testing.assert_array_equal(m.ckin_idx.numpy(), np.concatenate(segs))
    ptr, mid, col = m.fs_ptr.numpy(), m.fs_mid.numpy(), m.fs_col.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(col) and m.fs_width == sum(
        p.Cp + p.Tp for p in m.pairs)
    for n in range(m.N):
        plus, minus = [], []
        for p, (off_i, off_t) in zip(m.pairs, m.fs_offsets):
            plus += [off_i + j for j in
                     np.nonzero(p.cand_nodes.numpy() == n)[0]]
            tn = p.tri_nodes.numpy()
            minus += [off_t + t for v in range(3)
                      for t in np.nonzero(tn[v] == n)[0]]
        assert col[ptr[n]:mid[n]].tolist() == plus, n
        assert col[mid[n]:ptr[n + 1]].tolist() == minus, n
