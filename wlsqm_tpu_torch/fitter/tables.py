"""Monomial exponent tables driving the WLSQM engine and kernel.

PyTorch port of :mod:`wlsqm_tpu.fitter.tables` (values copied, not
imported).  A basis row for an offset ``d`` is
``c[j] = prod(d ** EXP[j]) / prod(EXP[j]!)``: the ``1/m!`` factors are baked
in so the solved DOFs directly equal the derivative values of the surrogate
at xi (reference: wlsqm/fitter/defs.pyx:53-57, wlsqm/fitter/impl.pyx:119-157).

Tables are small NumPy constants; the engine converts them to tensors on use.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial

import numpy as np

# 1D: F, X, X2, X3, X4  (reference: wlsqm/fitter/defs.pyx:90-96)
EXP1 = np.array([[0], [1], [2], [3], [4]], dtype=np.int32)

# 2D (reference: wlsqm/fitter/defs.pyx:107-121)
EXP2 = np.array(
    [
        [0, 0],                                      # F
        [1, 0], [0, 1],                              # X Y
        [2, 0], [1, 1], [0, 2],                      # X2 XY Y2
        [3, 0], [2, 1], [1, 2], [0, 3],              # X3 X2Y XY2 Y3
        [4, 0], [3, 1], [2, 2], [1, 3], [0, 4],      # X4 X3Y X2Y2 XY3 Y4
    ],
    dtype=np.int32,
)

# 3D (reference: wlsqm/fitter/defs.pyx:137-171); note the irregular 3rd/4th
# order sub-orderings — they are part of the API contract.
EXP3 = np.array(
    [
        [0, 0, 0],                                               # F
        [1, 0, 0], [0, 1, 0], [0, 0, 1],                         # X Y Z
        [2, 0, 0], [1, 1, 0], [0, 2, 0],                         # X2 XY Y2
        [0, 1, 1], [0, 0, 2], [1, 0, 1],                         # YZ Z2 XZ
        [3, 0, 0], [2, 1, 0], [1, 2, 0], [0, 3, 0],              # X3 X2Y XY2 Y3
        [0, 2, 1], [0, 1, 2], [0, 0, 3], [1, 0, 2],              # Y2Z YZ2 Z3 XZ2
        [2, 0, 1], [1, 1, 1],                                    # X2Z XYZ
        [4, 0, 0], [3, 1, 0], [2, 2, 0], [1, 3, 0], [0, 4, 0],   # X4 X3Y X2Y2 XY3 Y4
        [0, 3, 1], [0, 2, 2], [0, 1, 3], [0, 0, 4], [1, 0, 3],   # Y3Z Y2Z2 YZ3 Z4 XZ3
        [2, 0, 2], [3, 0, 1], [2, 1, 1], [1, 2, 1], [1, 1, 2],   # X2Z2 X3Z X2YZ XY2Z XYZ2
    ],
    dtype=np.int32,
)

EXPONENTS = {1: EXP1, 2: EXP2, 3: EXP3}


def _inv_fact(exp: np.ndarray) -> np.ndarray:
    out = np.empty(exp.shape[0], dtype=np.float64)
    for j in range(exp.shape[0]):
        f = 1
        for e in exp[j]:
            f *= factorial(int(e))
        out[j] = 1.0 / f
    return out


# 1/prod(e!) normalization, so DOFs read as derivative values.
INV_FACT = {d: _inv_fact(EXPONENTS[d]) for d in (1, 2, 3)}

# total polynomial degree of each DOF's monomial
DEGREE = {d: EXPONENTS[d].sum(axis=1).astype(np.int32) for d in (1, 2, 3)}

# map tuple(exponents) -> DOF index, per dimension
_EXP_INDEX = {
    d: {tuple(int(e) for e in row): j for j, row in enumerate(EXPONENTS[d])}
    for d in (1, 2, 3)
}


@lru_cache(maxsize=None)
def diff_projection(dimension: int, diff: int) -> np.ndarray:
    """Projection matrix P with ``eval_diff(x) = c_baked(x) @ (P @ fi)``.

    ``P[t, s] = 1`` iff DOF ``s``'s monomial exponent equals DOF ``t``'s
    exponent plus the derivative multi-index of ``diff``.  Because
    ``∂^m (d**e/e!) = d**(e-m)/(e-m)!``, applying P to the (baked)
    coefficient vector gives the baked coefficients of the ``diff``-th
    derivative of the surrogate (reference: wlsqm/fitter/interp.pyx:316-932).

    Returns a (SIZE, SIZE) float64 0/1 matrix.
    """
    exp = EXPONENTS[dimension]
    n = exp.shape[0]
    if not (0 <= diff < n):
        raise ValueError(
            "diff must be a valid DOF index for dimension %d (0..%d); got %d"
            % (dimension, n - 1, diff))
    d = exp[diff]
    P = np.zeros((n, n), dtype=np.float64)
    for s in range(n):
        rem = exp[s] - d
        if (rem >= 0).all():
            t = _EXP_INDEX[dimension].get(tuple(int(e) for e in rem))
            if t is not None:
                P[t, s] = 1.0
    return P


@lru_cache(maxsize=None)
def derivative_order(dimension: int, diff: int) -> int:
    """Total derivative order of the DOF index ``diff`` (0 for F)."""
    return int(DEGREE[dimension][diff])
