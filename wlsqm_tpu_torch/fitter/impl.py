"""Low-level fitting pipeline (compat alias surface).

Port of :mod:`wlsqm_tpu.fitter.impl`.  The reference's ``impl`` module holds
the numerical engine as C functions: ``make_c_nD`` / ``make_A`` /
``preprocess_A`` / ``solve`` / ``solve_iterative`` (reference:
wlsqm/fitter/impl.pyx).  This package's engine is
:mod:`wlsqm_tpu_torch.fitter.engine`, batched functions on tensors; this
module re-exports them under their pipeline-stage roles for users who
navigated the reference by module name.

Mapping:

* ``make_c_nD`` + ``Case_make_weights``  → :func:`basis` + :func:`neighbor_weights`
* ``make_A`` + ``preprocess_A``          → :func:`prepare` (assembly, Ruiz
  scaling and factorization, batched)
* ``solve`` (+ sensitivities)            → :func:`solve_prepared`
* ``solve_iterative``                    → :func:`solve_iterative_prepared`
* the whole per-case stack under OpenMP  → :func:`fit_batch` (the batch axis)
"""

from wlsqm_tpu_torch.fitter.engine import (  # noqa: F401
    Prepared,
    basis,
    dof_masks,
    fit_batch,
    neighbor_weights,
    prepare,
    solve_iterative_prepared,
    solve_prepared,
)

__all__ = [
    "Prepared",
    "basis",
    "dof_masks",
    "fit_batch",
    "neighbor_weights",
    "prepare",
    "solve_iterative_prepared",
    "solve_prepared",
]
