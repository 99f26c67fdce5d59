"""Faults of the timed path, planted under the program for the check's
tests and for ``control.py --fault``: each replaces functions of
``hakai_tpu_torch.solver.explicit`` by broken ones, which every chunk,
captured graphs included, then runs.  No run of the benchmark plants one.
"""
from __future__ import annotations

import contextlib


def _unchanged(orig):
    """A chunk that returns its state as it found it."""
    def run_chunk(model, state, n, comm=None):
        return state
    return run_chunk


def _half_elements(orig):
    """The assembly with the second half of the elements' forces left
    out."""
    def assemble(model, qe24, comm):
        import torch
        keep = torch.arange(qe24.shape[1], device=qe24.device) \
            < model.n_element // 2
        return orig(model, torch.where(keep, qe24, 0.0), comm)
    return assemble


def _altered(orig):
    """The host loop with one node of its final state moved by a fiftieth
    of an element edge."""
    def run_loop(*args, **kw):
        s = orig(*args, **kw)
        disp = s.disp.clone()
        disp[2, 0] += 0.05
        return s.replace(disp=disp)
    return run_loop


def _altered_frame(orig):
    """The frame writer with one node's displacement moved by a fiftieth
    of an element edge in the file."""
    def write(index, out_dir, coord, elem, flag, disp, velo, nd, n, e):
        disp = disp.copy()
        disp[2, 0] += 0.05
        return orig(index, out_dir, coord, elem, flag, disp, velo, nd, n, e)
    return write


def _no_erosion(orig):
    """The packed step with the erosion walk's deletions dropped: every
    element keeps the life flag it had."""
    def packed_element_step(model, P, flag, *args, **kw):
        P_new, qe, triax, _ = orig(model, P, flag, *args, **kw)
        return P_new, qe, triax, flag.clone()
    return packed_element_step


def _no_erosion_generic(orig):
    """The generic step's erosion with its deletions dropped."""
    def erode(model, stress, strain, eq_ps, triax, element_flag, carry=None):
        er = orig(model, stress, strain, eq_ps, triax, element_flag, carry)
        return er._replace(element_flag=element_flag.clone(),
                           deleted_now=er.deleted_now & False)
    return erode


def _half_contact(orig):
    """The contact force halved where it is produced."""
    def contact_forces(*args, **kw):
        return 0.5 * orig(*args, **kw)
    return contact_forces


# fault: the functions of ``explicit`` it replaces, each with its maker
FAULTS = {"unchanged": [("run_chunk", _unchanged)],
          "half_elements": [("_assemble", _half_elements)],
          "altered": [("run_loop", _altered)],
          "altered_frame": [("write_vtk", _altered_frame)],
          "no_erosion": [("packed_element_step", _no_erosion),
                         ("erode", _no_erosion_generic)],
          "half_contact": [("contact_forces", _half_contact)]}


@contextlib.contextmanager
def planted(name: str):
    """Within the block the fault ``name`` replaces its functions."""
    from hakai_tpu_torch.solver import explicit
    origs = [(attr, getattr(explicit, attr)) for attr, _ in FAULTS[name]]
    for (attr, orig), (_, make) in zip(origs, FAULTS[name]):
        setattr(explicit, attr, make(orig))
    try:
        yield
    finally:
        for attr, orig in origs:
            setattr(explicit, attr, orig)
