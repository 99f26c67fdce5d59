"""The harness's files found by name: a metric's reader, a deck generator
or a plain reference that a configuration names is a file of its own
under ``portbench/``, loaded from the checkout that runs it, so that a
later cell comes in as new files and no file of the harness is edited.

A file loaded so imports the harness by its full name
(``from portbench.reference.decks import Deck``): the checkout's root is
on ``sys.path`` in every run and test.
"""
from __future__ import annotations

import importlib.util
import os


def module(root: str, folder: str, name: str):
    """``<root>/portbench/<folder>/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name}",
        os.path.join(root, "portbench", folder, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
