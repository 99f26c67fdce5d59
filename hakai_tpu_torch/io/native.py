"""Number parsing for the ``.inp`` reader, the port's own copy of
``hakai_tpu/io/native.py:parse_numbers``.

The JAX package parses with a C++ helper (``native/hakai_native.cpp``,
``strtod``) when it can build one and falls back to a regular expression.
The port keeps the fallback alone: it needs no compiler and gives the same
correctly rounded doubles, and it reads the 23 MB of a 131,072-element
deck in about 1.3 s.
"""
from __future__ import annotations

import re

import numpy as np

_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eEdD][-+]?\d+)?")


def parse_numbers(text: str, expect: int | None = None) -> np.ndarray:
    """All float literals in ``text`` as a 1-D float64 array (``expect``,
    the helper's buffer size hint, is accepted and unused)."""
    return np.array([float(t) for t in _NUMBER.findall(text)])
