"""Constants layer: DOF numbering, knowns bitmasks, algorithm / weighting ids.

PyTorch port of :mod:`wlsqm_tpu.fitter.defs` (reference:
wlsqm/fitter/defs.pyx:69-279).  The values are copied, not imported, so
this package never loads JAX.  The DOF orderings are part of the public API
contract: DOFs are grouped in increasing order of number of
differentiations, so an order-k fit's coefficient vector is a prefix of the
order-4 layout (reference: wlsqm/fitter/defs.pyx:79-87).
"""

from __future__ import annotations

# Algorithms for the solve step (reference: wlsqm/fitter/defs.pyx:69-71).
ALGO_BASIC = 1      # fit once
ALGO_ITERATIVE = 2  # fit with iterative refinement to mitigate roundoff

# Weighting methods (reference: wlsqm/fitter/defs.pyx:74-75).
WEIGHT_UNIFORM = 1
WEIGHT_CENTER = 2

# -----------------------------------------------------------------------------
# 1D DOF indices (reference: wlsqm/fitter/defs.pyx:90-103)
# -----------------------------------------------------------------------------
i1_F = 0
i1_X = 1
i1_X2 = 2
i1_X3 = 3
i1_X4 = 4

i1_0th_end = 1
i1_1st_end = 2
i1_2nd_end = 3
i1_3rd_end = 4
i1_4th_end = 5

SIZE1 = i1_4th_end

# -----------------------------------------------------------------------------
# 2D DOF indices (reference: wlsqm/fitter/defs.pyx:107-133)
# -----------------------------------------------------------------------------
i2_F = 0

i2_X = 1
i2_Y = 2

i2_X2 = 3
i2_XY = 4
i2_Y2 = 5

i2_X3 = 6
i2_X2Y = 7
i2_XY2 = 8
i2_Y3 = 9

i2_X4 = 10
i2_X3Y = 11
i2_X2Y2 = 12
i2_XY3 = 13
i2_Y4 = 14

i2_0th_end = 1
i2_1st_end = 3
i2_2nd_end = 6
i2_3rd_end = 10
i2_4th_end = 15

SIZE2 = i2_4th_end

# -----------------------------------------------------------------------------
# 3D DOF indices (reference: wlsqm/fitter/defs.pyx:137-183)
# -----------------------------------------------------------------------------
i3_F = 0

i3_X = 1
i3_Y = 2
i3_Z = 3

i3_X2 = 4
i3_XY = 5
i3_Y2 = 6
i3_YZ = 7
i3_Z2 = 8
i3_XZ = 9

i3_X3 = 10
i3_X2Y = 11
i3_XY2 = 12
i3_Y3 = 13
i3_Y2Z = 14
i3_YZ2 = 15
i3_Z3 = 16
i3_XZ2 = 17
i3_X2Z = 18
i3_XYZ = 19

i3_X4 = 20
i3_X3Y = 21
i3_X2Y2 = 22
i3_XY3 = 23
i3_Y4 = 24
i3_Y3Z = 25
i3_Y2Z2 = 26
i3_YZ3 = 27
i3_Z4 = 28
i3_XZ3 = 29
i3_X2Z2 = 30
i3_X3Z = 31
i3_X2YZ = 32
i3_XY2Z = 33
i3_XYZ2 = 34

i3_0th_end = 1
i3_1st_end = 4
i3_2nd_end = 10
i3_3rd_end = 20
i3_4th_end = 35

SIZE3 = i3_4th_end

# -----------------------------------------------------------------------------
# Knowns bitmasks (reference: wlsqm/fitter/defs.pyx:211-279)
#
# "Known" means "known at the point xi" (the reference point of the model);
# known DOFs are eliminated algebraically from the equation system.
# -----------------------------------------------------------------------------

# 1D
b1_F = 1 << i1_F
b1_X = 1 << i1_X
b1_X2 = 1 << i1_X2
b1_X3 = 1 << i1_X3
b1_X4 = 1 << i1_X4

# 2D
b2_F = 1 << i2_F
b2_X = 1 << i2_X
b2_Y = 1 << i2_Y
b2_X2 = 1 << i2_X2
b2_XY = 1 << i2_XY
b2_Y2 = 1 << i2_Y2
b2_X3 = 1 << i2_X3
b2_X2Y = 1 << i2_X2Y
b2_XY2 = 1 << i2_XY2
b2_Y3 = 1 << i2_Y3
b2_X4 = 1 << i2_X4
b2_X3Y = 1 << i2_X3Y
b2_X2Y2 = 1 << i2_X2Y2
b2_XY3 = 1 << i2_XY3
b2_Y4 = 1 << i2_Y4

# 3D
b3_F = 1 << i3_F
b3_X = 1 << i3_X
b3_Y = 1 << i3_Y
b3_Z = 1 << i3_Z
b3_X2 = 1 << i3_X2
b3_XY = 1 << i3_XY
b3_Y2 = 1 << i3_Y2
b3_YZ = 1 << i3_YZ
b3_Z2 = 1 << i3_Z2
b3_XZ = 1 << i3_XZ
b3_X3 = 1 << i3_X3
b3_X2Y = 1 << i3_X2Y
b3_XY2 = 1 << i3_XY2
b3_Y3 = 1 << i3_Y3
b3_Y2Z = 1 << i3_Y2Z
b3_YZ2 = 1 << i3_YZ2
b3_Z3 = 1 << i3_Z3
b3_XZ2 = 1 << i3_XZ2
b3_X2Z = 1 << i3_X2Z
b3_XYZ = 1 << i3_XYZ
b3_X4 = 1 << i3_X4
b3_X3Y = 1 << i3_X3Y
b3_X2Y2 = 1 << i3_X2Y2
b3_XY3 = 1 << i3_XY3
b3_Y4 = 1 << i3_Y4
b3_Y3Z = 1 << i3_Y3Z
b3_Y2Z2 = 1 << i3_Y2Z2
b3_YZ3 = 1 << i3_YZ3
b3_Z4 = 1 << i3_Z4
b3_XZ3 = 1 << i3_XZ3
b3_X2Z2 = 1 << i3_X2Z2
b3_X3Z = 1 << i3_X3Z
b3_X2YZ = 1 << i3_X2YZ
b3_XY2Z = 1 << i3_XY2Z
b3_XYZ2 = 1 << i3_XYZ2

# one-past-end DOF counts per (dimension, order); dimension in {1,2,3}, order in 0..4
_DOF_COUNTS = {
    1: (i1_0th_end, i1_1st_end, i1_2nd_end, i1_3rd_end, i1_4th_end),
    2: (i2_0th_end, i2_1st_end, i2_2nd_end, i2_3rd_end, i2_4th_end),
    3: (i3_0th_end, i3_1st_end, i3_2nd_end, i3_3rd_end, i3_4th_end),
}

MAX_ORDER = 4


def number_of_dofs(dimension: int, order: int) -> int:
    """Number of DOFs in the original (unreduced) system.

    (reference: wlsqm/fitter/infra.pyx:67-112)
    """
    if dimension not in (1, 2, 3):
        raise ValueError("dimension must be 1, 2 or 3; got %s" % (dimension,))
    if order not in (0, 1, 2, 3, 4):
        raise ValueError("order must be 0, 1, 2, 3 or 4; got %s" % (order,))
    return _DOF_COUNTS[dimension][order]


def number_of_reduced_dofs(n: int, mask: int) -> int:
    """DOF count of the reduced system after knowns elimination.

    (reference: wlsqm/fitter/infra.pyx:119-121)
    """
    return n - int(mask).bit_count()


# star-import surface: every public constant and helper, minus the
# ``from __future__`` artifact
__all__ = [_n for _n in dir() if not _n.startswith("_")
           and _n != "annotations"]
