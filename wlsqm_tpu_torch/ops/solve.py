"""Batched small dense factor/solve front-end (Cholesky).

Port of :mod:`wlsqm_tpu.ops.solve`, ``"chol"`` only.  The WLSQM normal
matrix A = Cᵀ·diag(w)·C is SPD and symmetric Ruiz equilibration keeps it
so, so a batched Cholesky plus two triangular solves replace the
reference's LAPACK LU pair (reference: wlsqm/utils/lapackdrivers.pyx:1415-1463).
"""

from __future__ import annotations

import torch

SOLVER_CHOLESKY = "chol"


def factor(A: torch.Tensor, solver: str = SOLVER_CHOLESKY):
    """Factor a batch of SPD matrices.  Returns an opaque factorization.

    A matrix that is not positive definite gets a NaN factor, as XLA's
    Cholesky gives it, so its solve is NaN instead of silently wrong.
    """
    if solver != SOLVER_CHOLESKY:
        raise ValueError("unknown solver %r (this port has 'chol')" % (solver,))
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info != 0)[..., None, None], torch.nan, L)
    return (L,)


def solve_factored(fac, b: torch.Tensor, solver: str = SOLVER_CHOLESKY) -> torch.Tensor:
    """Solve A x = b given ``fac = factor(A)``; b: (..., n, m) multi-RHS."""
    if solver != SOLVER_CHOLESKY:
        raise ValueError("unknown solver %r (this port has 'chol')" % (solver,))
    (L,) = fac
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def cond_2norm(A: torch.Tensor) -> torch.Tensor:
    """Batched 2-norm condition number via singular values
    (reference: wlsqm/fitter/impl.pyx:661-682, via dgesvd)."""
    s = torch.linalg.svdvals(A)
    return s[..., 0] / s[..., -1]
