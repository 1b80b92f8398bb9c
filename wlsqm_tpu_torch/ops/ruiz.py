"""Batched Ruiz-2001 l∞ row/column equilibration, in PyTorch.

Port of :mod:`wlsqm_tpu.ops.ruiz`.  Reproduces the scalar iteration of the
reference (reference: wlsqm/utils/lapackdrivers.pyx:553-623
``rescale_ruiz2001_c``): starting from accumulated scalings
DRprev = DCprev = 1, each sweep computes

    DR[j] = sqrt( max_m |A[j,m]| / (DRprev[j] * DCprev[m]) )
    DC[m] = sqrt( max_j |A[j,m]| / (DRprev[j] * DCprev[m]) )

(both sweeps read the *previous* iterates), accumulates ``DRprev *= DR``,
``row_scale /= DR`` (ditto for columns), and stops when
``max_j |1 - DR[j]^2| < eps`` and ``max_m |1 - DC[m]^2| < eps``, capped at
``max_iter`` sweeps.  Batched over the leading axes with a per-problem
``done`` mask: converged problems freeze with DR = DC = 1, and the Python
loop ends once every problem is done (the JAX ``lax.while_loop`` rule).

The factors carry no autograd history, as the reference's
``stop_gradient`` has it: the scaling is a pure preconditioner (the solve
row-scales the RHS and col-unscales the solution), so the fit is exactly
invariant to it and the true Jacobian through it is zero.  Detaching is
exact, and it keeps the sweeps off the tape.
"""

from __future__ import annotations

import torch

from wlsqm_tpu_torch.utils import profiling

RUIZ_EPS = 1e-15
RUIZ_MAX_ITER = 100


def ruiz_scale(A: torch.Tensor, max_iter: int = RUIZ_MAX_ITER, eps: float = RUIZ_EPS):
    """Ruiz row/column scaling factors for a batch of square matrices.

    A: (..., n, n).  Apply the result as
    ``row_scale[..., :, None] * A * col_scale[..., None, :]``
    (reference: wlsqm/utils/lapackdrivers.pyx:285-299 ``apply_scaling``).

    Returns (row_scale, col_scale, iterations): shapes (..., n), (..., n),
    (...,); ``iterations`` is the per-problem sweep count.  The loop's trip
    count, one host read a trip, adds to the counter ``engine.ruiz_sweeps``
    (:func:`wlsqm_tpu_torch.utils.profiling.count`).
    """
    absA = A.detach().abs()
    ones_n = torch.ones_like(A[..., :, 0])
    done = torch.zeros(ones_n.shape[:-1], dtype=torch.bool, device=A.device)
    iters = torch.zeros(ones_n.shape[:-1], dtype=torch.int32, device=A.device)
    dr_prev, dc_prev = ones_n, ones_n
    row_scale, col_scale = ones_n, ones_n
    k = 0
    while k < max_iter and not bool(done.all()):
        ratio = absA / (dr_prev[..., :, None] * dc_prev[..., None, :])
        row_max = ratio.amax(dim=-1)
        col_max = ratio.amax(dim=-2)
        dr = torch.sqrt(torch.where(row_max > 0, row_max, 1.0))
        dc = torch.sqrt(torch.where(col_max > 0, col_max, 1.0))
        dr = torch.where(done[..., None], ones_n, dr)
        dc = torch.where(done[..., None], ones_n, dc)

        dr_prev = dr_prev * dr
        dc_prev = dc_prev * dc
        row_scale = row_scale / dr
        col_scale = col_scale / dc

        # stopping rule on the *squared* factors = the l∞ norms themselves
        row_conv = (1.0 - dr * dr).abs().amax(dim=-1) < eps
        col_conv = (1.0 - dc * dc).abs().amax(dim=-1) < eps
        iters = torch.where(done, iters, iters + 1)
        done = done | (row_conv & col_conv)
        k += 1
    profiling.count("engine.ruiz_sweeps", k)
    return row_scale, col_scale, iters


def apply_scaling(A: torch.Tensor, row_scale: torch.Tensor,
                  col_scale: torch.Tensor) -> torch.Tensor:
    """Scale A in the reference's convention (multiply by the factors)."""
    return row_scale[..., :, None] * A * col_scale[..., None, :]


def jacobi_scale(A: torch.Tensor):
    """One-pass symmetric Jacobi scaling: D = 1/sqrt(diag(A)).

    Returns (row_scale, col_scale, iterations) like :func:`ruiz_scale`.
    """
    d = torch.diagonal(A.detach(), dim1=-2, dim2=-1)
    s = torch.where(d > 0, 1.0 / torch.sqrt(torch.where(d > 0, d, 1.0)), 1.0)
    iters = torch.ones(s.shape[:-1], dtype=torch.int32, device=A.device)
    return s, s, iters
