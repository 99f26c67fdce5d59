"""The benchmark's decks on the CPU: each configuration's deck at a fixed
seed as it was built before generators were found by name, and HAKAI's
contact mode carried from the deck to the program and refused by the
plain reference where it asks for a self pair.

    python -m pytest portbench/tests -q
"""
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import program  # noqa: E402
from portbench.reference import decks, solver  # noqa: E402

SEED = 4294967311
# sha256 of each configuration's deck at SEED (digest() below) and the
# port's contact_flag of it, as the harness built them when its two
# generators were a fixed table and port_model set the flag from a bool
PINNED = {
    "bar131k_mixed": (
        "31101d8f749e00c30069f3b2f183f6a7cf7c4ce6cedcf83900a25cb58315be43", 0),
    "impact120k_mixed": (
        "ed66236dc9d8e4e2fadf3174571611576155e13636fda395ecdcddec641c114d", 1),
    "bar131k_mixed_xla": (
        "31101d8f749e00c30069f3b2f183f6a7cf7c4ce6cedcf83900a25cb58315be43", 0),
}


def digest(deck: decks.Deck) -> str:
    """sha256 of the deck's arrays, instances and scalars."""
    h = hashlib.sha256()
    for a in (deck.coord, deck.elem, deck.fixed_nodes, deck.pulled_nodes,
              deck.ic_nodes):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
    h.update(repr([(i.name, i.node_offset, i.n_node, i.elem_offset, i.n_elem)
                   for i in deck.instances]).encode())
    h.update(repr((deck.ductile, deck.d_time, deck.end_time, deck.pull,
                   deck.ramp_end, deck.ic_vz, bool(deck.contact))).encode())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_configuration_decks_are_unchanged(name):
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                      name + ".json")))
    deck = decks.build(cfg["deck"], SEED, cfg["jitter"])
    assert (digest(deck), program.port_model(deck).contact_flag) == \
        PINNED[name]


def _flagged(generator: str, flag: int) -> decks.Deck:
    make, small = decks.generator(generator)
    return dataclasses.replace(make(**small), contact_flag=flag)


@pytest.mark.parametrize("generator,flag", [("bar", 2), ("bar", 1),
                                            ("impact", 2)])
def test_a_self_pair_is_the_ports_and_refused_by_the_reference(
        generator, flag, tmp_path):
    """A deck that puts an instance against itself (contact_flag 2, or
    one instance with contact): the port lowers a self pair, and the
    default reference raises, naming the pair, rather than form none."""
    deck = _flagged(generator, flag)
    assert program.port_model(deck).contact_flag == flag
    lm = program.lower(deck, {"dtype": "float64"}, str(tmp_path), "cpu")
    assert any(p.is_self for p in lm.pairs)
    with pytest.raises(ValueError, match=r"self pair \(0, 0\)"):
        solver.Reference(deck, "cpu")


def test_the_reference_forms_every_pair_of_the_port(tmp_path):
    """All-exterior contact between two instances: as many directional
    pairs in the reference as in the port, none of them a self pair."""
    deck = _flagged("impact", 1)
    lm = program.lower(deck, {"dtype": "float64"}, str(tmp_path), "cpu")
    assert not any(p.is_self for p in lm.pairs)
    assert len(solver.Reference(deck, "cpu").pairs) == len(lm.pairs) == 2
