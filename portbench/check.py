"""The comparison that decides ``correct``: the program's outputs, read in
deck order, against the plain reference's, as numbers each with a limit.

Every number is a gap that grows with the fault: a percentile or the
largest of the per-entry gaps over a scale of the field, taken over all
entries or over the few that contact and erosion touch, or a count of
entries that differ.  ``correct`` holds when each number is at or under
its limit (the cell's ``limits``); a number that is not finite fails.
"""
from __future__ import annotations

import math

import numpy as np

from .reference.decks import PLASTIC
from .reference.solver import node_fields

# the frame's point fields, in file order, and the group each is judged in
FRAME_SCALARS = ("Vx", "Vy", "Vz", "E11", "E22", "E33", "E12", "E23", "E13",
                 "EQ_PSTRAIN", "S11", "S22", "S33", "S12", "S23", "S13",
                 "MISES_STRESS", "TRIAX_STRESS")

# the least count of deletions that ``erosion_differ`` divides by: one
# element that crosses its fracture strain a step apart on the two sides,
# in a chunk that deletes one or two, reads 0.1, not 1 or more
EROSION_FLOOR = 10


def quantiles(err, scale: float, name: str) -> dict:
    """``<name>_q90``: the 90th percentile of the per-entry gaps ``err``
    (>= 0) over ``scale``.  A gap that a few entries alone carry (a
    contact or erosion threshold that the two sides cross a step apart,
    and what it stirs nearby) leaves it where it is; one that every entry
    carries moves it.  A state that holds NaN reads NaN, which fails."""
    q90 = float(np.quantile(err, 0.9)) if err.size else 0.0
    return {f"{name}_q90": _ratio(q90, scale)}


def _ratio(gap: float, scale: float) -> float:
    """``gap`` over ``scale``: infinite for a gap with no scale, and not a
    number where either is not finite (a state that holds NaN)."""
    if not (math.isfinite(gap) and math.isfinite(scale)):
        return math.nan
    if scale > 0:
        return gap / scale
    return math.inf if gap > 0 else 0.0


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a)))) if np.size(a) else 0.0


def _np(x):
    return x.detach().cpu().numpy()


def chunk(start: dict, end: dict, ref: dict, elem) -> dict:
    """Numbers of one chunk of the program: its end state ``end`` against
    the reference's ``ref``, both reached from ``start`` (deck-order
    arrays, ``program.deck_order``; the reference's initial state for the
    first chunk); ``elem`` is the deck's element table, (E, 8) node ids.
    Displacement, stress and plastic strain are compared as
    what the chunk added to ``start``, velocity as it ends; stress over
    the Gauss points alive on both sides against at least a thousandth of
    the yield stress, plastic strain over those that flowed on either
    side.

    The few entries that contact and erosion touch are judged on their
    own, since a percentile over all entries cannot see them:
    ``erosion_differ``, the elements that one side deleted in the chunk
    and the other did not, over those the reference deleted (at least
    :data:`EROSION_FLOOR`); ``contact_force_q90`` and ``contact_disp_q90``, over the nodes
    that carry a contact force at the chunk's end on either side; and
    ``local_disp_max``, the largest displacement gap over those nodes and
    the nodes of the elements deleted on either side.  ``del_ref``,
    ``del_prog`` and ``contact_nodes`` are the sizes of those sets, for
    the readings; no limit holds them."""
    r = {k: _np(v) for k, v in ref.items() if k != "step"}
    both = end["alive"] & r["alive"]
    du_p, du_r = end["disp"] - start["disp"], r["disp"] - start["disp"]
    du_gap = np.linalg.norm(du_p - du_r, axis=1)
    du_ref = np.linalg.norm(du_r, axis=1)
    out = quantiles(du_gap, _rms(du_ref), "disp")
    out.update(quantiles(np.linalg.norm(end["velo"] - r["velo"], axis=1),
                         _rms(np.linalg.norm(r["velo"], axis=1)), "velo"))
    ds_p = end["stress"][both] - start["stress"][both]
    ds_r = r["stress"][both] - start["stress"][both]
    out.update(quantiles(np.linalg.norm(ds_p - ds_r, axis=-1).ravel(),
                         max(_rms(np.linalg.norm(r["stress"][both], axis=-1)),
                             1e-3 * PLASTIC[0, 0]), "stress"))
    de_p = end["eq_ps"] - start["eq_ps"]
    de_r = r["eq_ps"] - start["eq_ps"]
    flow = (de_p > 0) | (de_r > 0)
    out.update(quantiles(np.abs(de_p - de_r)[flow], _rms(de_r[flow]),
                         "eq_ps"))
    # erosion: the chunk's deletions on each side
    dead_p = start["alive"] & ~end["alive"]
    dead_r = start["alive"] & ~r["alive"]
    differ = int((dead_p ^ dead_r).sum())
    out.update(erosion_differ=differ / max(int(dead_r.sum()),
                                           EROSION_FLOOR),
               del_ref=int(dead_r.sum()), del_prog=int(dead_p.sum()))
    # contact: the nodes that carry a force at the chunk's end
    f_p, f_r = end["contact"], r["contact"]
    touch = (np.abs(f_p).sum(axis=1) > 0) | (np.abs(f_r).sum(axis=1) > 0)
    f_ref = np.linalg.norm(f_r[touch], axis=1)
    out.update(quantiles(np.linalg.norm(f_p - f_r, axis=1)[touch],
                         _rms(f_ref), "contact_force"))
    out.update(quantiles(du_gap[touch], _rms(du_ref[touch]),
                         "contact_disp"))
    local = touch.copy()
    local[np.asarray(elem)[dead_p | dead_r].reshape(-1)] = True
    scale = _rms(du_ref[local])
    top = float(du_gap[local].max()) if local.any() else 0.0
    out.update(local_disp_max=_ratio(top, scale),
               contact_nodes=int(touch.sum()))
    return out


def read_vtk(path: str) -> dict:
    """A legacy-VTK frame as arrays: POINTS (n, 3), CELLS (c, 9),
    DISPLACEMENT (n, 3) and each scalar (n,), keyed by name."""
    with open(path) as f:
        text = f.read()
    # (header, header lines, values a row), in file order
    sections = ([("POINTS", 1, 3), ("CELLS", 1, 9), ("CELL_TYPES", 1, 1),
                 ("POINT_DATA", 1, 0), ("VECTORS DISPLACEMENT", 1, 3)]
                + [(f"SCALARS {s}", 2, 1) for s in FRAME_SCALARS])
    starts = []
    pos = 0
    for head, _, _ in sections:
        pos = text.index(head, pos)
        starts.append(pos)
    starts.append(len(text))
    out = {}
    for k, (head, lines, width) in enumerate(sections):
        a = starts[k]
        for _ in range(lines):
            a = text.index("\n", a) + 1
        if width:
            vals = np.fromstring(text[a:starts[k + 1]], sep=" ")
            out[head.split()[-1]] = vals.reshape(-1, width)
    for k, head in enumerate(("POINTS", "CELLS")):
        count = int(text[starts[k]:starts[k + 1]].split(maxsplit=2)[1])
        if out[head].shape[0] != count:
            raise ValueError(f"{path}: {head} holds {out[head].shape[0]} "
                             f"rows, its header says {count}")
    return {k: (v[:, 0] if v.shape[1] == 1 else v) for k, v in out.items()}


def frame(path: str, ref, s: dict) -> dict:
    """Numbers of one frame file against the reference state ``s`` of the
    same step: its cells against the reference's live elements, its
    DISPLACEMENT and node stresses against the reference's node
    fields."""
    v = read_vtk(path)
    nf = {k: _np(x) for k, x in node_fields(ref, s).items()}
    cells_ref = ref.deck.elem[:, _np(s["alive"])].T
    cells = v["CELLS"][:, 1:].astype(np.int64)
    same = (cells.shape == cells_ref.shape
            and bool((cells == cells_ref).all()))
    stress = np.stack([v[k] for k in ("S11", "S22", "S33", "S12", "S23",
                                      "S13")], axis=1)
    disp = _np(s["disp"])
    return dict(
        frame_cells_differ=0 if same else max(
            1, abs(len(cells) - len(cells_ref))),
        **quantiles(np.linalg.norm(v["DISPLACEMENT"] - disp, axis=1),
                    _rms(np.linalg.norm(disp, axis=1)), "frame_disp"),
        **quantiles(np.linalg.norm(stress - nf["stress"], axis=1),
                    max(_rms(np.linalg.norm(nf["stress"], axis=1)),
                        1e-3 * PLASTIC[0, 0]), "frame_stress"))


def frame_vs_state(path: str, state: dict) -> dict:
    """``frame_state_differ``: the values of a frame's DISPLACEMENT and
    Vx, Vy, Vz that are not the program's own state at that step (deck
    order, ``program.deck_order``) printed as ``%1.6e``: each within half
    a unit of its seventh digit, or flushed to zero below 1e-16."""
    v = read_vtk(path)
    got = np.concatenate([v["DISPLACEMENT"],
                          np.stack([v["Vx"], v["Vy"], v["Vz"]], 1)], 1)
    want = np.concatenate([state["disp"], state["velo"]], 1)
    want = np.where(np.abs(want) < 1e-16, 0.0, want)
    off = np.abs(got - want) > 5.0000001e-7 * np.abs(want)
    return {"frame_state_differ": int(off.sum())
            + abs(got.shape[0] - want.shape[0])}


def worst(rows) -> dict:
    """Each number's largest value over ``rows`` (dicts of numbers); NaN
    where any row reads NaN."""
    out: dict = {}
    for row in rows:
        for k, x in row.items():
            had = out.get(k, 0)
            out[k] = had if had != had else x if x != x else max(had, x)
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """Each number finite and at or under its limit; a number without a
    limit fails."""
    return all(k in limits and math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())
