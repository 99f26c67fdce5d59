"""The benchmark's only contact with the program under test,
``hakai_tpu_torch``: a deck handed over through the port's public
``Model`` types, its lowering, whole simulations through ``run()``, and
the program's outputs read back in deck order for the check."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from .reference.decks import DENSITY, DUCTILE, PLASTIC, POISSON, YOUNG, Deck


def port_model(deck: Deck):
    """The deck as the port's parsed-deck :class:`Model` (1-based ids), as
    ``hakai_tpu_torch.pre.synthetic`` builds its own decks."""
    from hakai_tpu_torch.io.model import (BC, IC, Amplitude, Instance,
                                          Material, Model, Part)
    mt = Material(name="steel", density=DENSITY, young=YOUNG,
                  poisson=POISSON)
    mt.plastic = PLASTIC.copy()
    mt.Hd = np.diff(PLASTIC[:, 0]) / np.diff(PLASTIC[:, 1])
    if deck.ductile:
        mt.ductile = DUCTILE.copy()
        mt.fracture_flag = 1
    parts, insts = [], []
    for k, ins in enumerate(deck.instances):
        nodes = slice(ins.node_offset, ins.node_offset + ins.n_node)
        els = slice(ins.elem_offset, ins.elem_offset + ins.n_elem)
        parts.append(Part(name=f"part{k + 1}", n_node=ins.n_node,
                          coordmat=deck.coord[:, nodes].copy(),
                          n_element=ins.n_elem,
                          elementmat=deck.elem[:, els] - ins.node_offset + 1,
                          material_name="steel", material_id=1))
        insts.append(Instance(name=ins.name, part_name=f"part{k + 1}",
                              part_id=k + 1, material_id=1,
                              node_offset=ins.node_offset,
                              element_offset=ins.elem_offset,
                              n_node=ins.n_node, n_element=ins.n_elem))
    m = Model(parts=parts, instances=insts, materials=[mt],
              n_node=deck.n_node, coordmat=deck.coord.copy(),
              n_element=deck.n_elem, elementmat=deck.elem + 1,
              element_material=np.ones(deck.n_elem, np.int64),
              element_instance=np.concatenate([
                  np.full(i.n_elem, k + 1, np.int64)
                  for k, i in enumerate(deck.instances)]),
              d_time=deck.d_time, end_time=deck.end_time,
              contact_flag=deck.contact_flag)
    held = deck.fixed_nodes + 1
    enc = BC()
    enc.dof.append(np.concatenate([held * 3 - 2, held * 3 - 1, held * 3]))
    enc.value = [0.0]
    m.bcs.append(enc)
    if len(deck.pulled_nodes):
        amp = Amplitude(name="ramp", time=np.array([0.0, deck.ramp_end]),
                        value=np.array([0.0, 1.0]))
        m.amplitudes.append(amp)
        pull = BC(amp_name="ramp", amplitude=amp)
        pull.dof.append((deck.pulled_nodes + 1) * 3)
        pull.value.append(deck.pull)
        m.bcs.append(pull)
    if len(deck.ic_nodes):
        m.ics.append(IC(type="VELOCITY", dof=[(deck.ic_nodes + 1) * 3],
                        value=[deck.ic_vz]))
    return m


def lower(deck: Deck, solver: dict, out_dir: str, device: str):
    """The program's lowered model of ``deck`` with the configuration's
    solver settings (``SolverConfig`` fields)."""
    from hakai_tpu_torch import SolverConfig
    from hakai_tpu_torch import lower as port_lower
    cfg = SolverConfig(**solver, out_dir=out_dir)
    return port_lower(port_model(deck), cfg, device=device)


def first_chunk(model):
    """The model cut to its first chunk (one chunk of the same length and
    no more), for the warm-up simulation."""
    cfg = model.config
    d_out = max(model.time_num // cfg.output_num, 1)
    return dataclasses.replace(
        model, time_num=min(d_out, model.time_num),
        end_time=min(d_out, model.time_num) * model.dt,
        config=dataclasses.replace(cfg, output_num=1))


def simulate(model, write_output: bool, timings: dict):
    """One whole simulation from the initial state, as the CLI runs a
    deck: ``hakai_tpu_torch.run()``."""
    from hakai_tpu_torch import run
    return run(model, verbose=False, write_output=write_output,
               timings=timings, device=model.device)


def fingerprint(state) -> list:
    """Sums of the final state's fields, in float64, to hold the window's
    simulations against each other."""
    import torch
    return torch.stack([
        x.double().sum() for x in (state.disp, state.velo, state.stress,
                                   state.eq_ps, state.contact_force,
                                   state.element_flag)]).tolist()


# the state's fields the check reads, copied to the host at a chunk's ends
FIELDS = ("t", "disp", "disp_pre", "velo", "Q", "stress", "strain", "eq_ps",
          "yield_s", "element_flag", "contact_force")


def host_copy(state) -> dict:
    """The state's :data:`FIELDS` copied to the host."""
    return {f: getattr(state, f).to("cpu") for f in FIELDS}


def differ(a: dict, b: dict) -> int:
    """How many of two host copies' fields differ in any bit."""
    import torch
    return sum(not torch.equal(a[f], b[f]) for f in FIELDS)


@contextlib.contextmanager
def recorded_chunks(wanted):
    """Within the block, every chunk that ``hakai_tpu_torch.run()`` drives
    is counted from 0, and for each index in ``wanted`` the state it
    starts from and the state it returns are copied to the host:
    ``{(index, "start" | "end"): {field: CPU tensor}}``, read in deck order
    by :func:`deck_order`.  The chunk itself (``run_chunk``: its captured
    graphs and kernels) runs as it does outside the block."""
    from hakai_tpu_torch.solver import explicit
    chunk, seen, rec = explicit.run_chunk, [0], {}

    def recording(model, state, n, comm=None):
        j = seen[0]
        seen[0] += 1
        if j in wanted:
            rec[j, "start"] = host_copy(state)
        out = chunk(model, state, n, comm)
        if j in wanted:
            rec[j, "end"] = host_copy(out)
        return out

    explicit.run_chunk = recording
    try:
        yield rec
    finally:
        explicit.run_chunk = chunk


def deck_order(model, state: dict) -> dict:
    """A state's fields (a :data:`FIELDS` mapping of tensors) in deck order
    as NumPy arrays: nodal fields (n, 3), stress (E, 8, 6), strain (E, 6),
    eq_ps and yield_s (E, 8), alive (E,), step."""
    def np_(x):
        x = x.detach().cpu()
        return x.double().numpy() if x.is_floating_point() else x.numpy()
    n, E = model.n_node, model.n_element
    n2o = (np.arange(n) if model.node_new2old is None
           else np_(model.node_new2old))
    e2o = (np.arange(E) if model.elem_new2old is None
           else np_(model.elem_new2old))

    def nodes(x):                                   # (3, N) -> (n, 3)
        out = np.zeros((n, 3))
        out[n2o] = np_(x)[:, :n].T
        return out

    def elems(x):                                   # (..., E) -> (E, ...)
        a = np_(x)[..., :E]
        out = np.zeros((E,) + a.shape[:-1], a.dtype)
        out[e2o] = np.moveaxis(a, -1, 0)
        return out

    stress = elems(state["stress"].reshape(48, -1)).reshape(E, 6, 8)
    return dict(step=int(state["t"]), disp=nodes(state["disp"]),
                disp_pre=nodes(state["disp_pre"]), velo=nodes(state["velo"]),
                Q=nodes(state["Q"]), stress=stress.transpose(0, 2, 1),
                strain=elems(state["strain"]), eq_ps=elems(state["eq_ps"]),
                yield_s=elems(state["yield_s"]),
                alive=elems(state["element_flag"]).astype(bool),
                contact=nodes(state["contact_force"]))
