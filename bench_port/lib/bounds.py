"""The least time a kernel launch could take: a frozen yardstick.

A copy of ``chip_smoke.py``'s ``_bound``, ``_moment_flops``,
``_rows_flops`` and their helpers, with the two tables they read from the
port (the 2D/3D DOF exponents and the size of the moment lattice) worked
out here instead, so that nothing in the port can move the bound.  Bytes:
each input read once and each output written once.  Operations: the FP64
operations the fit needs for the launch's inputs, counted from the kernels'
loops (a multiply-add is 2), each neighbour's basis row built once.

Peaks: the H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TFLOP/s FP64 (the
tensor-core rate; the thread bodies cannot reach it, so an operation-bound
share reads low, never high).
"""

from __future__ import annotations

import itertools

HBM_BYTES_S = 3.35e12
FP64_FLOP_S = 67e12

#: DOF exponents in the package's DOF order (python-wlsqm's defs.pyx)
EXPONENTS = {
    1: [(0,), (1,), (2,), (3,), (4,)],
    2: [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2), (3, 0), (2, 1), (1, 2), (0, 3),
        (4, 0), (3, 1), (2, 2), (1, 3), (0, 4)],
}
_DOFS = {1: (1, 2, 3, 4, 5), 2: (1, 3, 6, 10, 15)}


def number_of_dofs(dim: int, order: int) -> int:
    return _DOFS[dim][order]


def moment_count(dim: int, maxdeg: int) -> int:
    """Multi-indices of total degree <= maxdeg in ``dim`` variables."""
    return sum(1 for e in itertools.product(range(maxdeg + 1), repeat=dim)
               if sum(e) <= maxdeg)


def _nnz(dim, order):
    rows = EXPONENTS[dim][:number_of_dofs(dim, order)]
    return sum(max(sum(1 for v in row if v > 0) - 1, 0) for row in rows)


def _row_flops(dim, order, center):
    ladder = dim * min(max(order - 1, 0), 3)
    return 2 * dim + ladder + _nnz(dim, order) + ((2 * dim + 5) if center else 0)


def _chol_flops(NO):
    flops = 0
    for j in range(NO):
        flops += 2 * j + 2 + sum(2 * j + 1 for _ in range(j + 1, NO))
    return flops


def rows_flops(dim, order, center, n, cases, refine, do_sens):
    """FP64 operations of the rows body over ``cases`` cases of ``n`` valid
    neighbours each, basic algorithm, no knowns."""
    NO = number_of_dofs(dim, order)
    NT = NO * (NO + 1) // 2
    solve = 2 * NO * NO
    sweep = 3 * NO + n * (4 * NO + 1) + solve + NO
    total = n * (_row_flops(dim, order, center) + (1 if center else 0))
    total += n * (3 * NO + 2 * NT)
    total += 2 * NO + 2 * NT + _chol_flops(NO) + NO + solve
    total += refine * sweep + NO
    if do_sens:
        total += n * (2 * NO + solve + refine * sweep)
    return float(total) * cases


def moment_flops(order, center, n, cases, refine, dim=2):
    """FP64 operations of the moment body over ``cases`` cases of ``n`` valid
    neighbours each, basic algorithm, no knowns (1D and 2D)."""
    NO = number_of_dofs(dim, order)
    NM = moment_count(dim, 2 * order)
    NT = NO * (NO + 1) // 2
    solve = 2 * NO * NO
    sums = (NM + NO) * (1 if dim == 1 else 2)
    per_k = 2 * dim + ((2 * dim - 1 + 6) if center else 0) + (2 * dim * order + order + 1) + sums
    total = (n * (4 * dim - 1) if center else 0) + n * per_k
    sweep = NO + 2 * NO * NO + 2 * NO + solve + NO
    total += 2 * NO + 2 * NT + _chol_flops(NO) + NO + solve
    total += refine * sweep + NO
    return float(total) * cases


def bound(nbytes: int, flops: float) -> dict:
    """The least time for the work: bytes over the HBM rate, or FP64
    operations over the FP64 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP64_FLOP_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "flops": flops}


def moment_launch(B, K, dim, order, center, refine):
    """K1 (``csrc/fit_moment.cu``) on B full cases: reads xk, fk, nk, xi,
    writes fi."""
    nbytes = B * K * dim * 8 + B * K * 8 + B * 4 + B * dim * 8 + B * number_of_dofs(dim, order) * 8
    return bound(nbytes, moment_flops(order, center, K, B, refine, dim))


def rows_launch(B, K, dim, order, center, refine, do_sens):
    """K2 (``csrc/fit_rows.cu``) on B full cases: reads xk, fk, nk, xi and the
    per-case scale, writes fi and, with sens, sens."""
    NO = number_of_dofs(dim, order)
    nbytes = (B * K * dim * 8 + B * K * 8 + B * 4 + B * dim * 8 + B * 8 + B * NO * 8
              + (B * K * NO * 8 if do_sens else 0))
    return bound(nbytes, rows_flops(dim, order, center, K, B, refine, do_sens))


def gather_launch(n, rows, row_bytes, index_bytes=4):
    """K4 (``csrc/gather.cu``): reads the index array and u, writes the
    gathered rows."""
    return bound(rows * index_bytes + rows * row_bytes + n * row_bytes, 0.0)
