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
from hakai_tpu_torch.core.lowering import _scatter_blocks, lower
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


def _decode(m):
    """(column, position in fs_col) of every word of fs_sorted."""
    w = m.fs_sorted.numpy().view(np.uint32).astype(np.int64)
    ptr = m.fs_ptr.numpy().astype(np.int64)
    block = np.repeat(np.arange(m.N) // m.fs_nb, np.diff(ptr))
    return w >> m.fs_bits, ptr[block * m.fs_nb] + (w & ((1 << m.fs_bits)
                                                        - 1)), block


@pytest.mark.parametrize("dtype", ["float32", "float64", "mixed"])
@pytest.mark.parametrize("deck", ["impact", "self-contact"])
def test_scatter_blocks_table(deck, dtype):
    """Kernel S's copy of the force table against the CSR: per block of
    fs_nb nodes, the block's entries sorted by column (ties in table
    order), each word's place giving back fs_col; at most fs_emax entries
    a block; and the sum the kernel forms from it (each gathered value at
    its place, then each node's places in table order) bitwise
    scatter_forces_plain's."""
    import torch

    from hakai_tpu_torch.ops.contact_cuda import scatter_forces_plain
    build = {"impact": lambda s: s.impact_model(n=4),
             "self-contact": lambda s: s.self_contact_model(n=3)}[deck]
    m = lower(build(tsyn), SolverConfig(dtype=dtype), device="cpu")
    col, pos, block = _decode(m)
    nnz = m.fs_col.shape[0]
    assert m.fs_sorted.dtype == torch.int32 and m.fs_sorted.shape == (nnz,)
    assert m.fs_nb == 32 and m.fs_width <= 1 << (32 - m.fs_bits)
    np.testing.assert_array_equal(np.sort(pos), np.arange(nnz))
    np.testing.assert_array_equal(m.fs_col.numpy()[pos], col)
    np.testing.assert_array_equal(np.lexsort((pos, col, block)),
                                  np.arange(nnz))
    ptr = m.fs_ptr.numpy()
    starts = ptr[np.minimum(np.arange(0, m.N + m.fs_nb, m.fs_nb), m.N)]
    assert m.fs_emax == np.diff(starts).max() < 1 << m.fs_bits
    force = torch.as_tensor(np.random.default_rng(3).normal(
        size=(3, m.fs_width))).to(m.edtype)
    placed = torch.empty((3, nnz), dtype=m.edtype)
    placed[:, torch.as_tensor(pos)] = force[:, torch.as_tensor(col)]
    in_order = dataclasses.replace(m, fs_col=torch.arange(nnz,
                                                          dtype=torch.int32))
    assert torch.equal(scatter_forces_plain(in_order, placed, m.dtype),
                       scatter_forces_plain(m, force, m.dtype))


@pytest.mark.parametrize("width,nb,bits", [(1 << 20, 32, 7), (1 << 29, 2, 3),
                                           (1 << 30, 1, 2)])
def test_scatter_blocks_fit_a_word(width, nb, bits):
    """Blocks of 32 nodes are halved until a place and a column fit one
    32-bit word: rows of 3 entries over 2^20, 2^29 and 2^30 columns; past
    that the lowering refuses the table."""
    ptr = np.arange(0, 3 * 40 + 1, 3)
    col = (np.arange(120) * 7919) % width
    words, got_nb, got_bits, emax = _scatter_blocks(ptr, col, width)
    assert (got_nb, got_bits, emax) == (nb, bits, 3 * nb)
    w = words.view(np.uint32).astype(np.int64)
    block = np.repeat(np.arange(40) // nb, 3)
    np.testing.assert_array_equal(
        col[ptr[block * nb] + (w & ((1 << bits) - 1))], w >> bits)
    with pytest.raises(ValueError, match="exceed kernel S"):
        _scatter_blocks(ptr, col, 1 << 31)
