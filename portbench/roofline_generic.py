"""The yardstick of the generic step's element-kernel roofline share: the
operations and bytes of one launch of the unpacked entry
(``hk_element_update_*``, the generic ``step()``'s), with the triaxiality
output and the negative-Jacobian count, at E elements and N nodes.  The
peaks and the operations an element are ``portbench/roofline.py``'s (the
unpacked entry runs the packed one's math; the count adds a compare and a
ballot a Gauss point).

A bound counts each input byte read once and each output byte written
once, as ``roofline.element_bytes`` does: the least time the card could
take is the larger of bytes over the HBM rate and operations over the
peak rate.
"""
from __future__ import annotations

from portbench.roofline import ELEMENT_FLOP, HBM_BPS, PEAK_FLOPS

# bytes of an element value a config dtype: the generic step hands the
# kernel positions and increments in the element dtype, mixed included
ELEMENT_WIDTH = {"float32": 4, "float64": 8, "mixed": 4}
# the kernel's element type (the C++ name in its instantiated name)
CXX_TYPE = {"float32": "float", "float64": "double", "mixed": "float"}


def generic_element_bytes(E: int, N: int, dtype: str) -> int:
    """Bytes one unpacked element step reads and writes: elem (8 int32),
    the Gauss state in (stress 48, strain 6, eq_ps 8, yield 8), G and lam
    (element type), mat_id (int32), has_plastic and flag (bool) an
    element, the position and the increment (3 + 3) a node; out the Gauss
    state (70), qe (24) and triax (8) an element, and the count (int32)."""
    eb = ELEMENT_WIDTH[dtype]
    per_elem = 8 * 4 + (70 + 2) * eb + 4 + 1 + 1 + (70 + 24 + 8) * eb
    return E * per_elem + N * 6 * eb + 4


def generic_element_bound_s(E: int, N: int, dtype: str) -> float:
    """The least seconds an unpacked element step can take."""
    return max(generic_element_bytes(E, N, dtype) / HBM_BPS,
               ELEMENT_FLOP * E / PEAK_FLOPS[dtype])


def is_generic_entry(dtype: str):
    """Whether a device operation's name is the unpacked entry's kernel
    with the triaxiality output in ``dtype``: the instantiation
    ``element_kernel<T, T, true, true, ...>`` (GENERIC, TRIAX), with or
    without the count's template argument after them."""
    t = CXX_TYPE[dtype]
    head = f"element_kernel<{t}, {t}, true, true"
    return lambda name: head + "," in name or head + ">" in name
