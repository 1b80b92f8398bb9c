"""Batched small dense factor/solve front-end.

Port of :mod:`wlsqm_tpu.ops.solve`.  The WLSQM normal matrix
A = Cᵀ·diag(w)·C is SPD and symmetric Ruiz equilibration keeps it so, so a
batched Cholesky plus two triangular solves replace the reference's LAPACK
LU pair (reference: wlsqm/utils/lapackdrivers.pyx:1415-1463).  The LU mode
is kept as the reference-parity debug mode (the reference LU-factors the
scaled normal matrix with dgetrf, wlsqm/fitter/impl.pyx:686).

``"chol_unrolled"`` names the JAX package's trace-time unrolled Cholesky
(``wlsqm_tpu/ops/smallchol.py``), which exists only because XLA's batched
Cholesky is slow on a TPU for n <= 35.  It computes the same factor, so
here the name is accepted and computed by the batched Cholesky.
"""

from __future__ import annotations

import torch

SOLVER_CHOLESKY = "chol"
SOLVER_LU = "lu"
SOLVER_CHOLESKY_UNROLLED = "chol_unrolled"

SOLVERS = (SOLVER_CHOLESKY, SOLVER_LU, SOLVER_CHOLESKY_UNROLLED)


def check_solver(solver: str) -> None:
    if solver not in SOLVERS:
        raise ValueError("unknown solver %r (this port has %s)"
                         % (solver, ", ".join(repr(s) for s in SOLVERS)))


def factor(A: torch.Tensor, solver: str = SOLVER_CHOLESKY):
    """Factor a batch of square matrices.  Returns an opaque factorization.

    A matrix that is not positive definite (Cholesky) or is exactly
    singular (LU) gets a NaN factor, as XLA's factorizations give it, so its
    solve is NaN instead of silently wrong.
    """
    check_solver(solver)
    if solver == SOLVER_LU:
        lu, piv, info = torch.linalg.lu_factor_ex(A)
        lu = torch.where((info != 0)[..., None, None], torch.nan, lu)
        return (lu, piv)
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info != 0)[..., None, None], torch.nan, L)
    return (L,)


def solve_factored(fac, b: torch.Tensor, solver: str = SOLVER_CHOLESKY) -> torch.Tensor:
    """Solve A x = b given ``fac = factor(A)``; b: (..., n, m) multi-RHS."""
    check_solver(solver)
    if solver == SOLVER_LU:
        lu, piv = fac
        return torch.linalg.lu_solve(lu, piv, b)
    (L,) = fac
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def solve(A: torch.Tensor, b: torch.Tensor, solver: str = SOLVER_CHOLESKY) -> torch.Tensor:
    """One-shot batched solve (factor + back-substitute)."""
    return solve_factored(factor(A, solver), b, solver)


def cond_2norm(A: torch.Tensor) -> torch.Tensor:
    """Batched 2-norm condition number via singular values
    (reference: wlsqm/fitter/impl.pyx:661-682, via dgesvd)."""
    s = torch.linalg.svdvals(A)
    return s[..., 0] / s[..., -1]
