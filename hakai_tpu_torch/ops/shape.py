"""Hex8 shape-function gradient tables.

Reference: ``cal_Pusai_hexa`` (HAKAI-v0.0.2/Julia/HAKAI_j.jl:1895-1943).
Returns the parent-space gradients dN_i/dxi_a at the 8 Gauss points of the
2x2x2 rule as a single constant array ``(8 integ, 3 axis, 8 node)``.
"""
from __future__ import annotations

import numpy as np

# node parent coordinates (HAKAI_j.jl:1900-1907)
_DELTA = np.array([
    [-1.0, -1.0, -1.0],
    [ 1.0, -1.0, -1.0],
    [ 1.0,  1.0, -1.0],
    [-1.0,  1.0, -1.0],
    [-1.0, -1.0,  1.0],
    [ 1.0, -1.0,  1.0],
    [ 1.0,  1.0,  1.0],
    [-1.0,  1.0,  1.0],
])

# Gauss point parent coordinates (HAKAI_j.jl:1911-1920)
_G = 1.0 / np.sqrt(3.0)
_GC = np.array([
    [-_G, -_G, -_G],
    [-_G, -_G,  _G],
    [-_G,  _G, -_G],
    [-_G,  _G,  _G],
    [ _G, -_G, -_G],
    [ _G, -_G,  _G],
    [ _G,  _G, -_G],
    [ _G,  _G,  _G],
])


def pusai_hexa(integ_num: int = 8) -> np.ndarray:
    """Parent-space shape gradients, shape ``(integ_num, 3, 8)`` float64."""
    if integ_num == 8:
        gc = _GC
    elif integ_num == 1:
        gc = np.zeros((1, 3))
    else:
        raise ValueError(f"unsupported integ_num={integ_num}")
    out = np.zeros((integ_num, 3, 8))
    for k in range(integ_num):
        gzai, eta, tueta = gc[k]
        for i in range(8):
            d1, d2, d3 = _DELTA[i]
            out[k, 0, i] = 0.125 * d1 * (1.0 + eta * d2) * (1.0 + tueta * d3)
            out[k, 1, i] = 0.125 * d2 * (1.0 + gzai * d1) * (1.0 + tueta * d3)
            out[k, 2, i] = 0.125 * d3 * (1.0 + gzai * d1) * (1.0 + eta * d2)
    return out
