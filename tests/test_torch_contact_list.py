"""The list of active triangles that a chunk carries beside its activity
masks (``ops/activity.py``), on the CPU: the plain version of kernel A's
list against ``torch.nonzero``, the listed gather's plain version
against the whole gather on the entries the step's kernels read, and
``run()``'s counters of the lists (``contact_rebuilds``,
``contact_listed_max``): the rebuilds that followed a deletion, whatever
the chunking, and 0 on the paths that keep the dense sweep (a
fracture-free deck, element-sharded and halo ranks).  The kernels are
held to these plain versions on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from hakai_tpu_torch import SolverConfig, init_state, lower, run
from hakai_tpu_torch.ops.activity import chunk_carry
from hakai_tpu_torch.ops.broad_cuda import active_list_plain, pair_activity
from hakai_tpu_torch.ops.contact import contact_forces_pv, contact_kinematics
from hakai_tpu_torch.ops.gather_cuda import gather_cols_plain
from hakai_tpu_torch.pre import synthetic as tsyn
from hakai_tpu_torch.solver import explicit


def eroding_impact(n=3, end_time=1.2e-6, erosion=True):
    """impact_model off the slab's grid lines with a ductile table that
    erodes the cube's foot within a few dozen steps (or, without
    ``erosion``, no ductile table: a fracture-free deck)."""
    m = tsyn.offset_instance(tsyn.impact_model(n=n, v0=8.0e4, d_time=2e-8,
                                               end_time=end_time), 1, 0.013,
                             0.017)
    for mt in m.materials:
        if erosion:
            mt.ductile = np.array([[0.02, 0.0, 30.0], [0.01, 0.3, 30.0]])
        else:
            mt.ductile, mt.fracture_flag = np.zeros((0, 3)), 0
    return m


def _mask(case, F2, tb, rng):
    a = rng.random(F2) < 0.3
    if case == "empty chunk":
        a[tb:2 * tb] = False
    elif case == "full chunk":
        a[:tb] = True
    elif case == "none":
        a[:] = False
    elif case == "all":
        a[:] = True
    return torch.from_numpy(a)


@pytest.mark.parametrize("case,F2,tb", [
    ("empty chunk", 1000, 128), ("full chunk", 1000, 128),
    ("ragged", 1001, 128), ("ragged", 7, 512), ("one chunk", 324, 324),
    ("none", 600, 128), ("all", 600, 128)])
def test_active_list_plain_matches_nonzero(case, F2, tb):
    """The ids of the active triangles in increasing order, and per chunk
    of ``tb`` ids (the last one ragged) the start of its run: chunk c's
    ids are the active ids in [c tb, (c + 1) tb)."""
    a = _mask(case, F2, tb, np.random.default_rng(F2 + tb))
    ids, starts = active_list_plain(a, tb)
    tc = -(-F2 // tb)
    assert ids.dtype == starts.dtype == torch.int32
    assert torch.equal(ids, torch.nonzero(a).reshape(-1).int())
    assert starts.shape == (tc + 1,) and int(starts[0]) == 0
    assert int(starts[-1]) == int(a.sum())
    for c in range(tc):
        run_ = ids[starts[c]:starts[c + 1]]
        assert torch.equal(run_, torch.nonzero(a[c * tb:(c + 1) * tb])
                           .reshape(-1).int() + c * tb)


def test_listed_gather_holds_what_the_kernels_read():
    """A step of an eroding impact with its carry: the listed gather's
    plain version equals the whole gather on every entry a kernel reads
    (the nodes, all six rows of candidates and of q0, the position rows of
    j-side nodes, q1 and q2 of listed triangles) and is NaN on the rest;
    the step's contact force equals a step without a carry."""
    m = lower(eroding_impact(), SolverConfig(dtype="float64"), device="cpu")
    s = explicit.eager_chunk(m, init_state(m), 45)
    flag = s.element_flag
    assert int(flag.sum()) < m.n_element
    carry = chunk_carry(m)
    pos, vel = (m.coord + s.disp), s.velo
    got = contact_forces_pv(m, pos, vel, flag, carry=carry)
    assert torch.equal(got, contact_forces_pv(m, pos, vel, flag))
    kin = contact_kinematics(m, pos, vel, carry)
    whole = gather_cols_plain(torch.cat([pos, vel]), m.ckin_idx)
    read = torch.zeros_like(whole, dtype=torch.bool)
    for p, c, sl in zip(m.pairs, carry.pairs, m.ckin_slices):
        (a0, _), (a1, _), (a2, _), (cs, ce), (js, je) = sl
        ids = torch.nonzero(pair_activity(p, flag)[0]).reshape(-1)
        assert torch.equal(c.ids[:int(c.starts[-1])], ids.int())
        assert 0 < len(ids) < p.tri_nodes.shape[1]
        read[:, a0 + ids] = True
        read[:3, a1 + ids] = True
        read[:3, a2 + ids] = True
        read[:, cs:ce] = True
        read[:3, js:je] = True
    assert torch.equal(kin[read], whole[read])
    assert kin[~read].isnan().all()


def _alive_by_step(monkeypatch, model, **kw):
    """run() of ``model`` in chunks of one step: (timings, alive count
    after each step, the life mask each step started from)."""
    flags, chunk = [], explicit.run_chunk

    def recording(m, state, n, comm=None):
        assert n == 1
        flags.append(state.element_flag.clone())
        return chunk(m, state, n, comm)
    monkeypatch.setattr(explicit, "run_chunk", recording)
    tm = {}
    final = run(model, verbose=False, write_output=False, device="cpu",
                timings=tm, **kw)
    alive = [int(f.sum()) for f in flags[1:]] + [
        int(final.element_flag.sum())]
    return tm, alive, flags


def test_run_counts_list_rebuilds(monkeypatch):
    """An eroding impact through run() on one device, a chunk a step:
    ``contact_rebuilds`` is the number of steps that followed a deletion
    (each chunk's first step rebuilds the lists too, uncounted), and
    ``contact_listed_max`` the largest share of the pairs' slots active at
    a step; in chunks of a dozen steps the same counts."""
    deck = eroding_impact()
    m = lower(deck, SolverConfig(dtype="float64", output_num=10 ** 6),
              device="cpu")
    tm, alive, flags = _alive_by_step(monkeypatch, m)
    assert tm["chunks"] == m.time_num == len(alive)
    before = [m.n_element] + alive[:-1]
    after_deletion = sum(a < b for a, b in zip(alive[:-1], before[:-1]))
    assert tm["contact_rebuilds"] == after_deletion > 0
    slots = sum(p.tri_nodes.shape[1] for p in m.pairs)
    listed = max(sum(int(pair_activity(p, f)[0].sum()) for p in m.pairs)
                 for f in flags)
    assert 0 < tm["contact_listed_max"] == listed / slots <= 1
    monkeypatch.undo()
    tm12 = {}
    m12 = lower(deck, SolverConfig(dtype="float64",
                                   output_num=m.time_num // 12),
                device="cpu")
    run(m12, verbose=False, write_output=False, device="cpu", timings=tm12)
    assert tm12["chunks"] < tm["chunks"]
    assert (tm12["contact_rebuilds"], tm12["contact_listed_max"]) == \
        (tm["contact_rebuilds"], tm["contact_listed_max"])


@pytest.mark.parametrize("path", ["fracture-free", "ranks", "halo"])
def test_dense_paths_count_no_list(path):
    """The paths that keep the dense sweep report no list: a fracture-free
    deck (every pair's activity static, no carry), element-sharded and
    halo ranks (the masks recomputed every step, no carry)."""
    deck = eroding_impact(end_time=4e-7, erosion=path != "fracture-free")
    m = lower(deck, SolverConfig(dtype="float64", output_num=4, elem_pad=8),
              device="cpu")
    assert all(p.static_activity for p in m.pairs) == (path ==
                                                       "fracture-free")
    kw = {"fracture-free": {}, "ranks": dict(devices=2),
          "halo": dict(halo=2)}[path]
    tm = {}
    run(m, verbose=False, write_output=False, device="cpu", timings=tm, **kw)
    assert tm["chunks"] == 4
    assert (tm["contact_rebuilds"], tm["contact_listed_max"]) == (0, 0.0)
