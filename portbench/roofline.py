"""The yardstick of the kernels' roofline shares: the H100's peaks and the
element kernel's operations and bytes, frozen from ``chip_smoke.py``
(``HBM_BPS``, ``PEAK_FLOPS``, ``ELEMENT_FLOP``, and the bytes that
``check_element`` counts as ``moved``) as of the port's PR 16.

A bound counts each input byte read once and each output byte written
once: the least time the card could take is the larger of bytes over the
HBM rate and operations over the peak rate.
"""
from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense, outside the tensor cores)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "mixed": 67e12}
# element-kernel operations per element, counted from csrc/element.cu (an
# FMA counts 2): per Gauss-point thread J and Gdu 270, det/inverse 55,
# g 45, B-bar and trial 60, return map 45, strain and sums 30, force
# moments 100, Qe fold 144, triaxiality 20 -> ~770, x 8 threads
ELEMENT_FLOP = 6200
# bytes of (nodal, element) values a config dtype
WIDTHS = {"float32": (4, 4), "float64": (8, 8), "mixed": (8, 4)}


def element_bytes(E: int, N: int, dtype: str, triax: bool) -> int:
    """Bytes one packed element step reads and writes at E elements and N
    nodes: elem (8 int32), coord_e (24), P (72), G, lam (element type),
    mat_id (int32), has_plastic and flag (bool) an element, the new and
    previous disp (3 + 3 nodal) a node; out P (72), qe (24) and, on
    fracture decks, triax (8) an element."""
    nb, eb = WIDTHS[dtype]
    per_elem = 8 * 4 + (24 + 72 + 2) * eb + 4 + 1 + 1 \
        + (72 + 24 + (8 if triax else 0)) * eb
    return E * per_elem + N * 6 * nb


def element_bound_s(E: int, N: int, dtype: str, triax: bool) -> float:
    """The least seconds a packed element step can take."""
    return max(element_bytes(E, N, dtype, triax) / HBM_BPS,
               ELEMENT_FLOP * E / PEAK_FLOPS[dtype])
