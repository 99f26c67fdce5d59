"""The host-IO helper's bindings, the port's own copy of
``hakai_tpu/io/native.py``: the ``.inp`` reader's number parser and the
VTK writer's number formatters.

Each goes through the port's C++ helper (``csrc/host_io.cpp``, built at
first use by :func:`hakai_tpu_torch._build.host_library`), as the JAX
package's go through ``native/hakai_native.cpp``: ``strtod`` tried at every
character that can start a float literal, ``snprintf("%1.6e")`` and
``"%d"``.  So the port reads the same doubles from a deck and writes the
same frame bytes as the JAX package with its helper, whatever the text
holds (a Fortran ``1.0d3`` reads as 1 and 3 in both, ``-inf`` and ``0x10``
read as C reads them, a negative NaN prints ``-nan``).  There is no
fallback: if the helper cannot be built, the callers raise.

Beside each function is a plain Python twin that follows the helper, not
the JAX package's fallback; the tests hold each against its helper.
"""
from __future__ import annotations

import ctypes
import math
import re

import numpy as np

from .. import _build

# strtod's grammar where the scan tries it (C locale): a decimal or hex
# literal with an optional sign, or a signed inf/infinity/nan (an unsigned
# one starts at a letter, where the scan never tries).  Alternatives are
# ordered so that the regex takes what strtod takes: a hex literal before
# the decimal "0" it starts with, "infinity" before "inf", "nan(...)"
# before "nan".
_STRTOD = re.compile(
    r"[+-]?(?:0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)"
    r"(?:[pP][+-]?[0-9]+)?"
    r"|(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?)"
    r"|[+-](?:[iI][nN][fF](?:[iI][nN][iI][tT][yY])?"
    r"|[nN][aA][nN](?:\([0-9A-Za-z_]*\))?)")


def _strtod(tok: str) -> float:
    """The double that strtod returns for a literal of :data:`_STRTOD`."""
    body = tok.lstrip("+-")
    sign = -1.0 if tok[0] == "-" else 1.0
    low = body[:2].lower()
    if low == "in":
        return sign * math.inf
    if low == "na":
        return math.copysign(math.nan, sign)
    if low == "0x":
        try:
            return float.fromhex(tok)
        except OverflowError:
            return sign * math.inf
    return float(tok)


def parse_numbers(text: str, expect: int | None = None) -> np.ndarray:
    """All float literals in ``text`` as a 1-D float64 array, through the
    helper; ``expect`` sizes its first buffer (grown 4x until it fits)."""
    lib = _build.host_library()
    raw = text.encode()
    cap = max(expect, 1) if expect is not None else max(len(raw) // 2, 16)
    while True:
        out = np.empty(cap, np.float64)
        n = lib.hk_parse_numbers(
            raw, len(raw),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap)
        if n >= 0:
            return out[:n]
        cap *= 4


def parse_numbers_plain(text: str) -> np.ndarray:
    """:func:`parse_numbers` in Python: the same scan and grammar."""
    return np.array([_strtod(m.group()) for m in _STRTOD.finditer(text)],
                    np.float64)


def _rows(a: np.ndarray, dtype) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype)
    return a[:, None] if a.ndim == 1 else a


def _format(fn, a: np.ndarray, ctype, width: int) -> str:
    cap = a.size * width + 16
    out = ctypes.create_string_buffer(cap)
    n = fn(a.ctypes.data_as(ctypes.POINTER(ctype)), a.shape[0], a.shape[1],
           out, cap)
    if n < 0:
        raise RuntimeError("format buffer overflow")
    return out.raw[:n].decode()


def format_e_rows(a: np.ndarray) -> str:
    """Rows of ``a`` (1-D: one value a row) as ``%1.6e`` values joined by
    single spaces, one line each, through the helper."""
    return _format(_build.host_library().hk_format_e,
                   _rows(a, np.float64), ctypes.c_double, 16)


def format_i_rows(a: np.ndarray) -> str:
    """Rows of ``a`` cast to int32 as ``%d`` values, as
    :func:`format_e_rows`."""
    return _format(_build.host_library().hk_format_i, _rows(a, np.int32),
                   ctypes.c_int32, 13)


def _join_rows(vals: list[str], cols: int) -> str:
    line = " ".join(["%s"] * cols) + "\n"
    return (line * (len(vals) // max(cols, 1))) % tuple(vals)


def format_e_rows_plain(a: np.ndarray) -> str:
    """:func:`format_e_rows` in Python: C prints a NaN whose sign bit is
    set as ``-nan``, Python's ``%`` as ``nan``."""
    a = _rows(a, np.float64)
    vals = ["%1.6e" % v for v in a.ravel().tolist()]
    for i in np.flatnonzero(np.isnan(a) & np.signbit(a)):
        vals[i] = "-nan"
    return _join_rows(vals, a.shape[1])


def format_i_rows_plain(a: np.ndarray) -> str:
    """:func:`format_i_rows` in Python."""
    a = _rows(a, np.int32)
    return _join_rows(["%d" % v for v in a.ravel().tolist()], a.shape[1])
