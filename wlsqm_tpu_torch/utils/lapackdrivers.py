"""Batched dense linear-algebra drivers (compatibility surface), on the host.

Port of :mod:`wlsqm_tpu.utils.lapackdrivers`, the rebuild of the
reference's LAPACK wrapper layer (reference: wlsqm/utils/lapackdrivers.pyx)
with the same public names and in-place semantics:

* naming scheme: ``*s`` = multi-RHS, ``m*`` = multi-LHS (a batch of
  matrices), ``*p`` = parallel, ``*factor*``/``*factored*`` = split
  factorization (reference: wlsqm/utils/lapackdrivers.pxd:5-27);
* preconditioner family: ``rescale_{columns,rows,twopass,dgeequ,ruiz2001,
  scalgm}`` with the ``ScalingAlgo`` IntEnum + ``do_rescale`` dispatcher;
* everything real float64; matrices Fortran-contiguous; results written in
  place into the caller's NumPy arrays, exactly like the LAPACK originals,
  with LAPACK-format pivots (``dgetrf`` / ``dsytrf``).

Their contract is the caller's host arrays, written in place, so they
compute on the host with SciPy's LAPACK (the routines the reference binds:
dgesv/dgetrf/dgetrs/dsysv/dsytrf/dsytrs/dgtsv/dgesvd/dgeequ), as the JAX
package does on purpose; a round trip to the card would only add copies.
They are not on the card's path: the fitting engine's batched linear
algebra is :mod:`wlsqm_tpu_torch.ops.solve`.  The code is the JAX package's,
which imports nothing of JAX, kept as this package's own copy so that
the two make the same SciPy calls.

The batched ``m*`` families process the whole (n, n, nbatch) stack
vectorized — solves via the ``np.linalg.solve`` gufunc (one C loop over the
stack), the general factor/factored pair via a NumPy-vectorized
right-looking LU whose Python-level work is O(n) steps over the entire
batch — the host counterpart of the reference's OpenMP ``prange`` over
per-matrix LAPACK calls (reference: wlsqm/utils/lapackdrivers.pyx:1088-1354,
1551-1723).  The ``*p`` variants are aliases of their serial counterparts.

Factored-pair representation: ``mgeneralfactor``/``mgeneralfactored`` use
batched LU with pivots byte-compatible with LAPACK ``dgetrf``/``dgetrs`` —
the pair interoperates with the single-matrix ``generalfactor(ed)``.  The
batched *symmetric* factor family runs LAPACK ``dsytrf``/``dsytrs`` per
slice (the reference's own per-matrix shape, reference:
wlsqm/utils/lapackdrivers.pyx:1196-1354), so its (A, ipiv) pairs carry
genuine Bunch–Kaufman format and interchange freely with the
single-matrix ``symmetricfactor(ed)``.

The scaling algorithms are vectorized NumPy ports of the reference's
published iterations (Ruiz 2001; Chiang–Chandler SCALGM 2008).
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import scipy.linalg
import scipy.linalg.lapack as _lapack

__all__ = [
    "ScalingAlgo", "do_rescale",
    "distribute_items",
    "copygeneral", "copysymmu", "symmetrize", "msymmetrize", "msymmetrizep",
    "rescale_columns", "rescale_rows", "rescale_twopass", "rescale_dgeequ",
    "rescale_ruiz2001", "rescale_scalgm", "init_scaling", "apply_scaling",
    "tridiag",
    "symmetric2x2", "symmetric", "symmetricfactor", "symmetricfactored",
    "symmetrics", "symmetricsp",
    "msymmetric", "msymmetricp", "msymmetricfactor", "msymmetricfactored",
    "msymmetricfactorp", "msymmetricfactoredp",
    "general2x2", "general", "generalfactor", "generalfactored",
    "generals", "generalsp",
    "mgeneral", "mgeneralp", "mgeneralfactor", "mgeneralfactored",
    "mgeneralfactorp", "mgeneralfactoredp",
    "svd",
]

_EPS = 1e-15        # scaling-iteration convergence (reference epsilon)
_MAX_ITERS = 100    # scaling-iteration cap


# -----------------------------------------------------------------------------
# Work distribution helper (reference: wlsqm/utils/lapackdrivers.pyx:101-132)
# -----------------------------------------------------------------------------

def distribute_items(nitems, ntasks):
    """Distribute items 0..nitems-1 over ntasks tasks with near-equal loads.

    Returns (blocksizes, baseidxs), each of shape (ntasks,), dtype int32.
    Kept for API compatibility; the batch axis replaces the task split.
    """
    blocksizes = np.zeros(ntasks, dtype=np.int32)
    base, rem = divmod(nitems, ntasks)
    neff = ntasks if base > 0 else rem
    blocksizes[:neff] = base
    blocksizes[:rem] += 1
    baseidxs = np.zeros(ntasks, dtype=np.int32)
    np.cumsum(blocksizes[:-1], out=baseidxs[1:])
    return blocksizes, baseidxs


# -----------------------------------------------------------------------------
# Matrix handling helpers (reference: wlsqm/utils/lapackdrivers.pyx:139-256)
# -----------------------------------------------------------------------------

def copygeneral(O, I):
    """Copy a general matrix: O[:] = I."""
    np.copyto(np.asarray(O), np.asarray(I))


def copysymmu(O, I):
    """Copy the upper triangle of symmetric I into O (both triangles of O)."""
    I = np.asarray(I)
    U = np.triu(I)
    np.copyto(np.asarray(O), U + np.triu(I, 1).T)


def symmetrize(A):
    """Symmetrize in place from the upper triangle: A = sym(triu(A))."""
    A = np.asarray(A)
    U = np.triu(A)
    A[:] = U + np.triu(A, 1).T


def msymmetrize(A):
    """Batched symmetrize; A has shape (n, n, nbatch) like the reference.

    One vectorized copy of the strict upper triangle into the lower — no
    per-matrix loop (reference OpenMP site:
    wlsqm/utils/lapackdrivers.pyx:236-256).
    """
    A = np.asarray(A)
    iu, ju = np.triu_indices(A.shape[0], k=1)
    A[ju, iu, :] = A[iu, ju, :]


def msymmetrizep(A, ntasks):
    """Parallel batched symmetrize (alias of :func:`msymmetrize`)."""
    msymmetrize(A)


# -----------------------------------------------------------------------------
# Preconditioning (scaling) algorithms
# -----------------------------------------------------------------------------

class ScalingAlgo(IntEnum):
    """Matrix scaling algorithms for do_rescale()
    (reference: wlsqm/utils/lapackdrivers.pyx:305-317)."""

    ALGO_COLS_EUCL = 1
    ALGO_ROWS_EUCL = 2
    ALGO_TWOPASS = 3
    ALGO_RUIZ2001 = 4
    ALGO_SCALGM = 5
    ALGO_DGEEQU = 6


def init_scaling(nrows, ncols):
    """Fresh identity scaling vectors (multiplicative convention)."""
    return np.ones(nrows), np.ones(ncols)


def apply_scaling(A, row_scale, col_scale):
    """Scale A in place: A[j,m] *= row_scale[j] * col_scale[m]."""
    A = np.asarray(A)
    A *= np.asarray(row_scale)[:, None]
    A *= np.asarray(col_scale)[None, :]


def _cols_eucl(A, rs, cs):
    cs /= np.linalg.norm(A * (cs[None, :] * rs[:, None]), axis=0)
    return 1


def _rows_eucl(A, rs, cs):
    rs /= np.linalg.norm(A * (rs[:, None] * cs[None, :]), axis=1)
    return 1


def _twopass(A, rs, cs):
    _cols_eucl(A, rs, cs)
    _rows_eucl(A, rs, cs)
    return 1


def _ruiz2001(A, rs, cs):
    """Ruiz (2001) iterative l∞ equilibration
    (reference: wlsqm/utils/lapackdrivers.pyx:553-623)."""
    absA = np.abs(A)
    nrows, ncols = A.shape
    dr_prev = np.ones(nrows)
    dc_prev = np.ones(ncols)
    for k in range(_MAX_ITERS):
        ratio = absA / (dr_prev[:, None] * dc_prev[None, :])
        dr = np.sqrt(ratio.max(axis=1))
        dc = np.sqrt(ratio.max(axis=0))
        dr[dr == 0] = 1.0
        dc[dc == 0] = 1.0
        dr_prev *= dr
        dc_prev *= dc
        rs /= dr
        cs /= dc
        if (np.abs(1.0 - dr * dr).max() < _EPS
                and np.abs(1.0 - dc * dc).max() < _EPS):
            break
    return 1


def _smallest_nonzero(x, axis):
    """Smallest nonzero magnitude along axis (0 if the slice is all zero)."""
    masked = np.where(x > 0, x, np.inf)
    out = masked.min(axis=axis)
    return np.where(np.isfinite(out), out, 0.0)


def _scalgm(A, rs, cs):
    """SCALGM up/down geometric-mean scaling (Chiang & Chandler 2008;
    reference: wlsqm/utils/lapackdrivers.pyx:645-847)."""
    absA = np.abs(A)

    def scaled(r, c):
        return absA * (r[:, None] * c[None, :])

    mode = 1
    for _k in range(_MAX_ITERS):
        if mode == 1:
            # scale up rows then cols; and cols then rows; geometric-mean both
            S = scaled(rs, cs)
            dr1 = 1.0 / _smallest_nonzero(S, axis=1)
            dc1 = 1.0 / _smallest_nonzero(S * dr1[:, None], axis=0)
            dc2 = 1.0 / _smallest_nonzero(S, axis=0)
            dr2 = 1.0 / _smallest_nonzero(S * dc2[None, :], axis=1)
            rs *= np.sqrt(dr1 * dr2)
            cs *= np.sqrt(dc1 * dc2)
        # scale down by the largest magnitudes, both orders, geometric mean
        S = scaled(rs, cs)
        dr1 = 1.0 / S.max(axis=1)
        dc1 = 1.0 / (S * dr1[:, None]).max(axis=0)
        dc2 = 1.0 / S.max(axis=0)
        dr2 = 1.0 / (S * dc2[None, :]).max(axis=1)
        rs *= np.sqrt(dr1 * dr2)
        cs *= np.sqrt(dc1 * dc2)

        S = scaled(rs, cs)
        if np.abs(1.0 - S.max(axis=1)).max() < _EPS \
                and np.abs(1.0 - S.max(axis=0)).max() < _EPS:
            if mode == 1:
                mode = 2   # keep iterating only the scale-down steps
            else:
                break
    return 1


def _dgeequ(A, rs, cs):
    r, c, _rowcnd, _colcnd, _amax, info = _lapack.dgeequ(A)
    if info != 0:
        return 0
    rs *= r
    cs *= c
    return 1


_SCALERS = {
    ScalingAlgo.ALGO_COLS_EUCL: _cols_eucl,
    ScalingAlgo.ALGO_ROWS_EUCL: _rows_eucl,
    ScalingAlgo.ALGO_TWOPASS: _twopass,
    ScalingAlgo.ALGO_RUIZ2001: _ruiz2001,
    ScalingAlgo.ALGO_SCALGM: _scalgm,
    ScalingAlgo.ALGO_DGEEQU: _dgeequ,
}


def do_rescale(A, algo):
    """Scale A in place with the chosen algorithm; return (row_scale, col_scale).

    The returned factors follow the multiplicative convention: scale the RHS
    as ``b * row_scale`` and un-scale the solution as ``x * col_scale``
    (reference: wlsqm/utils/lapackdrivers.pyx:319-385).
    Raises LinAlgError if the scaler reports failure (e.g. DGEEQU on a
    singular row/column), ValueError for an unknown algorithm id.
    """
    A = np.asarray(A)
    try:
        scaler = _SCALERS[ScalingAlgo(algo)]
    except ValueError:
        raise ValueError("Unknown algorithm identifier, got %s" % (algo,))
    rs, cs = init_scaling(*A.shape)
    ok = scaler(A, rs, cs)
    if not ok:
        raise np.linalg.LinAlgError(
            "Matrix scaling failed (e.g. singular row or column).")
    apply_scaling(A, rs, cs)
    return rs, cs


def rescale_columns(A):
    """Column euclidean-norm scaling (dispatches via do_rescale)."""
    return do_rescale(A, ScalingAlgo.ALGO_COLS_EUCL)


def rescale_rows(A):
    """Row euclidean-norm scaling."""
    return do_rescale(A, ScalingAlgo.ALGO_ROWS_EUCL)


def rescale_twopass(A):
    """Columns then rows, one pass each."""
    return do_rescale(A, ScalingAlgo.ALGO_TWOPASS)


def rescale_dgeequ(A):
    """LAPACK DGEEQU equilibration; raises LinAlgError on singular input."""
    return do_rescale(A, ScalingAlgo.ALGO_DGEEQU)


def rescale_ruiz2001(A):
    """Ruiz (2001) symmetric l∞ equilibration (preserves symmetry)."""
    return do_rescale(A, ScalingAlgo.ALGO_RUIZ2001)


def rescale_scalgm(A):
    """Chiang–Chandler SCALGM geometric-mean scaling."""
    return do_rescale(A, ScalingAlgo.ALGO_SCALGM)


# -----------------------------------------------------------------------------
# Tridiagonal solver (reference: wlsqm/utils/lapackdrivers.pyx:854-877, dgtsv)
# -----------------------------------------------------------------------------

def tridiag(a, b, c, x):
    """Solve a tridiagonal system in place via LAPACK DGTSV.

    Array convention matches the reference's pointer pass-through
    (reference: wlsqm/utils/lapackdrivers.pyx:854-877): the first n-1
    entries of ``a`` are the sub-diagonal and the first n-1 entries of ``c``
    the super-diagonal (the last entry of each is unused).
    b: diagonal; x: RHS in / solution out.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    c = np.asarray(c)
    x = np.asarray(x)
    _du2, _d, _du, xs, info = _lapack.dgtsv(a[:-1], b, c[:-1], x.reshape(-1, 1))
    if info != 0:
        raise np.linalg.LinAlgError("dgtsv failed with info=%d" % info)
    x[:] = xs[:, 0]
    return 0


# -----------------------------------------------------------------------------
# Symmetric solver family (reference: wlsqm/utils/lapackdrivers.pyx:884-1354)
# -----------------------------------------------------------------------------

def symmetric2x2(A, b):
    """Analytic 2x2 symmetric solve, in place into b."""
    A = np.asarray(A)
    b = np.asarray(b)
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[0, 1]
    b0 = (A[1, 1] * b[0] - A[0, 1] * b[1]) / det
    b1 = (A[0, 0] * b[1] - A[0, 1] * b[0]) / det
    b[0], b[1] = b0, b1


def symmetric(A, b):
    """Solve a symmetric system (dsysv); A destroyed, b overwritten."""
    symmetrics(A, np.asarray(b).reshape(-1, 1))


def symmetricfactor(A):
    """Bunch–Kaufman factor A in place (dsytrf); returns the pivot array."""
    A = np.asarray(A)
    ldlt, ipiv, info = _lapack.dsytrf(A, lower=0, overwrite_a=0)
    if info != 0:
        raise np.linalg.LinAlgError("dsytrf failed with info=%d" % info)
    A[:] = ldlt
    return np.asarray(ipiv, dtype=np.int32)


def symmetricfactored(A, ipiv, b):
    """Back-substitute with a dsytrf-factored A (dsytrs); b overwritten.

    ``(A, ipiv)`` may come from :func:`symmetricfactor` or be one slice of
    a :func:`msymmetricfactor` stack — both carry dsytrf format, exactly
    like the reference (wlsqm/utils/lapackdrivers.pyx:1196-1354).
    """
    A = np.asarray(A)
    b = np.asarray(b)
    x, info = _lapack.dsytrs(A, np.asarray(ipiv), b.reshape(-1, 1), lower=0)
    if info != 0:
        raise np.linalg.LinAlgError("dsytrs failed with info=%d" % info)
    b[:] = x.ravel()


def symmetrics(A, b):
    """Symmetric solve with multiple RHS; b (n, nrhs) overwritten."""
    A = np.asarray(A)
    b = np.asarray(b)
    ldlt, ipiv, x, info = _lapack.dsysv(A, b, lower=0)
    if info != 0:
        raise np.linalg.LinAlgError("dsysv failed with info=%d" % info)
    A[:] = ldlt
    b[:] = x
    return 0


def symmetricsp(A, b, ntasks):
    """Multi-RHS symmetric solve; ntasks kept for API compatibility."""
    return symmetrics(A, b)


def _batched_lu_factor(A):
    """Vectorized batched LU with partial pivoting, dgetrf layout.

    A (nbatch, n, n) -> (lu, piv): unit-lower + upper factors packed like
    LAPACK ``dgetrf``, ``piv`` 0-based row-swap indices compatible with
    SciPy's ``lu_solve``/raw ``dgetrs`` wrappers.  Runs O(n) vectorized
    NumPy steps over the whole stack (the per-matrix work is C-level), in
    contrast to per-slice Python loops over LAPACK calls.
    """
    A = np.ascontiguousarray(A, dtype=np.float64).copy()
    nb, n, _ = A.shape
    piv = np.empty((nb, n), np.int32)
    bidx = np.arange(nb)
    for k in range(n):
        p = k + np.abs(A[:, k:, k]).argmax(axis=1)
        piv[:, k] = p
        rk = A[bidx, k, :].copy()
        A[bidx, k, :] = A[bidx, p, :]
        A[bidx, p, :] = rk
        pivval = A[:, k, k]
        safe = np.where(pivval != 0.0, pivval, 1.0)
        inv = np.where(pivval != 0.0, 1.0 / safe, 0.0)
        A[:, k + 1:, k] *= inv[:, None]
        A[:, k + 1:, k + 1:] -= A[:, k + 1:, k:k + 1] * A[:, k:k + 1, k + 1:]
    return A, piv


def _batched_lu_solve(lu, piv, b):
    """Back-substitute a :func:`_batched_lu_factor` stack; b (nbatch, n, m)."""
    lu = np.ascontiguousarray(lu, dtype=np.float64)
    piv = np.asarray(piv)
    x = np.ascontiguousarray(b, dtype=np.float64).copy()
    nb, n, _ = lu.shape
    bidx = np.arange(nb)
    for k in range(n):                      # apply the recorded row swaps
        p = piv[:, k]
        tmp = x[bidx, k, :].copy()
        x[bidx, k, :] = x[bidx, p, :]
        x[bidx, p, :] = tmp
    for k in range(n):                      # forward solve (unit lower)
        x[:, k + 1:, :] -= lu[:, k + 1:, k:k + 1] * x[:, k:k + 1, :]
    for k in range(n - 1, -1, -1):          # backward solve (upper)
        x[:, k, :] /= lu[:, k, k:k + 1]
        x[:, :k, :] -= lu[:, :k, k:k + 1] * x[:, k:k + 1, :]
    return x


def _sym_from_upper_stack(A):
    """(n, n, nbatch) -> (nbatch, n, n) symmetrized from the upper triangle.

    The symmetric families read only the upper triangle, like DSYSV
    (reference: wlsqm/utils/lapackdrivers.pyx:884-900).
    """
    S = np.moveaxis(np.asarray(A), 2, 0)
    U = np.triu(S)
    return U + np.swapaxes(np.triu(S, 1), -1, -2)


def msymmetric(A, b):
    """Batched symmetric solve: A (n,n,nbatch), b (n,nbatch), in place.

    The whole stack runs as one vectorized batched-LAPACK solve (reads the
    upper triangles, like DSYSV); A is destroyed (overwritten by the
    symmetrized matrices).  Reference OpenMP analogue:
    wlsqm/utils/lapackdrivers.pyx:1088-1186.
    """
    A_np = np.asarray(A)
    b_np = np.asarray(b)
    S = _sym_from_upper_stack(A_np)
    x = np.linalg.solve(S, np.ascontiguousarray(b_np.T)[..., None])
    b_np[:] = x[..., 0].T
    A_np[:] = np.moveaxis(S, 0, 2)  # mirror the "A destroyed" contract


def msymmetricp(A, b, ntasks):
    msymmetric(A, b)


def msymmetricfactor(A, ipiv):
    """Batched Bunch–Kaufman factor of a symmetric stack; fills A and ipiv.

    A (n, n, nbatch), ipiv (n, nbatch), both in place.  Each slice is
    factored by LAPACK ``dsytrf`` (upper storage), so the stack carries
    genuine dsytrf format: any single slice ``(A[:, :, i], ipiv[:, i])``
    back-substitutes through the scalar :func:`symmetricfactored` too —
    the same interchange contract as the reference
    (wlsqm/utils/lapackdrivers.pyx:1196-1305).  n is tiny here (≤ 35), so
    the per-slice LAPACK calls are microseconds each, mirroring the
    reference's per-matrix OpenMP loop.
    """
    A_np = np.asarray(A)
    ipiv_np = np.asarray(ipiv)
    nb = A_np.shape[2]
    for i in range(nb):
        Ai = np.asfortranarray(A_np[:, :, i])
        ldlt, piv, info = _lapack.dsytrf(Ai, lower=0, overwrite_a=1)
        if info != 0:
            raise np.linalg.LinAlgError(
                "dsytrf failed with info=%d on batch slice %d" % (info, i))
        A_np[:, :, i] = ldlt
        ipiv_np[:, i] = piv


def msymmetricfactored(A, ipiv, b):
    """Batched back-substitution with an msymmetricfactor()-factored stack.

    b (n, nbatch) overwritten; per-slice LAPACK ``dsytrs``.  The stack is
    dsytrf-format, so dsytrf pivots from the single-matrix
    :func:`symmetricfactor` are equally valid input (reference contract,
    wlsqm/utils/lapackdrivers.pyx:1310-1354).
    """
    A_np = np.asarray(A)
    ipiv_np = np.asarray(ipiv)
    b_np = np.asarray(b)
    nb = A_np.shape[2]
    for i in range(nb):
        x, info = _lapack.dsytrs(
            np.asfortranarray(A_np[:, :, i]),
            np.ascontiguousarray(ipiv_np[:, i]),
            b_np[:, i].reshape(-1, 1), lower=0)
        if info != 0:
            raise np.linalg.LinAlgError(
                "dsytrs failed with info=%d on batch slice %d" % (info, i))
        b_np[:, i] = x.ravel()


def msymmetricfactorp(A, ipiv, ntasks):
    msymmetricfactor(A, ipiv)


def msymmetricfactoredp(A, ipiv, b, ntasks):
    msymmetricfactored(A, ipiv, b)


# -----------------------------------------------------------------------------
# General solver family (reference: wlsqm/utils/lapackdrivers.pyx:1361-1723)
# -----------------------------------------------------------------------------

def general2x2(A, b):
    """Analytic 2x2 general solve, in place into b."""
    A = np.asarray(A)
    b = np.asarray(b)
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    b0 = (A[1, 1] * b[0] - A[0, 1] * b[1]) / det
    b1 = (A[0, 0] * b[1] - A[1, 0] * b[0]) / det
    b[0], b[1] = b0, b1


def general(A, b):
    """Solve a general system (dgesv); A destroyed, b overwritten."""
    generals(A, np.asarray(b).reshape(-1, 1))


def generalfactor(A):
    """LU-factor A in place (dgetrf); returns the pivot array (int32)."""
    A = np.asarray(A)
    lu, ipiv, info = _lapack.dgetrf(A, overwrite_a=0)
    if info < 0:
        raise np.linalg.LinAlgError("dgetrf failed with info=%d" % info)
    A[:] = lu
    return np.asarray(ipiv, dtype=np.int32)


def generalfactored(A, ipiv, b):
    """Back-substitute with a dgetrf-factored A (dgetrs); b overwritten."""
    A = np.asarray(A)
    b = np.asarray(b)
    x, info = _lapack.dgetrs(A, np.asarray(ipiv), b)
    if info != 0:
        raise np.linalg.LinAlgError("dgetrs failed with info=%d" % info)
    b[:] = x


def generals(A, b):
    """General solve with multiple RHS; A destroyed, b (n, nrhs) overwritten."""
    A = np.asarray(A)
    b = np.asarray(b)
    lu, ipiv, x, info = _lapack.dgesv(A, b)
    if info != 0:
        raise np.linalg.LinAlgError("dgesv failed with info=%d" % info)
    A[:] = lu
    b[:] = x
    return 0


def generalsp(A, b, ntasks):
    return generals(A, b)


def mgeneral(A, b):
    """Batched general solve: A (n,n,nbatch), b (n,nbatch), in place.

    One vectorized batched-LAPACK solve over the whole stack — the
    host-side analogue of the reference's OpenMP loop over dgesv calls
    (reference: wlsqm/utils/lapackdrivers.pyx:1551-1610).
    """
    A_np = np.asarray(A)
    b_np = np.asarray(b)
    Ab = np.ascontiguousarray(np.moveaxis(A_np, 2, 0))
    x = np.linalg.solve(Ab, np.ascontiguousarray(b_np.T)[..., None])
    b_np[:] = x[..., 0].T


def mgeneralp(A, b, ntasks):
    mgeneral(A, b)


def mgeneralfactor(A, ipiv):
    """Batched LU factor; fills A and ipiv (n, nbatch) in place.

    One vectorized batched-LAPACK ``getrf`` over the stack; the pivots are
    dgetrf/dgetrs-format, so any single slice back-substitutes through the
    scalar :func:`generalfactored` too.  Reference:
    wlsqm/utils/lapackdrivers.pyx:1616-1689.
    """
    A_np = np.asarray(A)
    ipiv_np = np.asarray(ipiv)
    lu, piv = _batched_lu_factor(np.moveaxis(A_np, 2, 0))
    A_np[:] = np.moveaxis(lu, 0, 2)
    ipiv_np[:] = np.asarray(piv, dtype=ipiv_np.dtype).T


def mgeneralfactored(A, ipiv, b):
    """Batched back-substitution with an mgeneralfactor()-factored stack."""
    A_np = np.asarray(A)
    ipiv_np = np.asarray(ipiv)
    b_np = np.asarray(b)
    lu = np.moveaxis(A_np, 2, 0)
    piv = np.ascontiguousarray(ipiv_np.T)
    x = _batched_lu_solve(lu, piv, np.ascontiguousarray(b_np.T)[..., None])
    b_np[:] = x[..., 0].T


def mgeneralfactorp(A, ipiv, ntasks):
    mgeneralfactor(A, ipiv)


def mgeneralfactoredp(A, ipiv, b, ntasks):
    mgeneralfactored(A, ipiv, b)


# -----------------------------------------------------------------------------
# SVD (reference: wlsqm/utils/lapackdrivers.pyx:1730-1774)
# -----------------------------------------------------------------------------

def svd(A):
    """Singular values of general A (descending); A destroyed, like dgesvd."""
    A = np.asarray(A)
    s = scipy.linalg.svd(A, compute_uv=False)
    A[:] = 0.0  # mirror "destroyed (overwritten)" contract
    return s
