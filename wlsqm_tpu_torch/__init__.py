"""wlsqm_tpu_torch — the WLSQM fitter in PyTorch, with CUDA kernels for Hopper.

A port of :mod:`wlsqm_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100;
the JAX package stays the reference.  For each reference point xi, a local
polynomial surrogate of order 0-4 is fitted over a neighborhood by
weighted least squares; the solved DOFs equal the function value and all
partial derivatives of the surrogate at xi.  Everything computes in
float64, which the H100 runs natively.

This package never imports JAX.  It mirrors the layout of ``wlsqm_tpu``:

* the compatibility layer (this namespace) — the reference's
  ``fit_{1D,2D,3D}[_iterative][_many][_many_parallel]``
  (:mod:`~wlsqm_tpu_torch.fitter.simple`), ``ExpertSolver``
  (:mod:`~wlsqm_tpu_torch.fitter.expert`), ``interpolate_fit`` /
  ``lambdify_fit``, the DOF and knowns constants, and the routing knob
  ``set_compat_precision`` (``config.set_iter_count_fidelity`` beside it);
  NumPy in, outputs written in place; ``fitter.impl``, ``fitter.infra``,
  ``utils.lapackdrivers`` and ``utils.ptrwrap`` keep the reference's module
  names;
* :mod:`~wlsqm_tpu_torch.api` — ``fit``, ``fit_many``, ``plan_fit_many``,
  ``fit_stream`` (host clouds in chunks), the expert-mode ``prepare`` /
  ``solve`` and ``interpolate``;
* :mod:`~wlsqm_tpu_torch.parallel.sharding` — the case axis over a list
  of devices;
* :mod:`~wlsqm_tpu_torch.fitter.engine` — the batched f64 engine and
  ``Prepared``; :mod:`~wlsqm_tpu_torch.fitter.interp` and
  :mod:`~wlsqm_tpu_torch.fitter.polyeval` — evaluation of fitted models;
* :mod:`~wlsqm_tpu_torch.ops.fit_kernel` — the moment-assembly kernel
  (dim 2, basic, no knowns) and its plain torch version;
* :mod:`~wlsqm_tpu_torch.ops.fit_rows` — the rows-body kernel (dims 1-3,
  knowns, sensitivities, ALGO_ITERATIVE), its plain torch version and
  ``fit_rows_diffable``;
* :mod:`~wlsqm_tpu_torch.ops.gather` — the IBVP step's gather ``u[idx]``
  (Morton order, window plan, the gather kernel and its plain version);
* :mod:`~wlsqm_tpu_torch.utils.neighbors` — kNN on the device or a host
  k-d tree (the native one of :mod:`~wlsqm_tpu_torch.native`, or scipy's);
* :mod:`~wlsqm_tpu_torch.utils.serialization` — a Prepared to and from an
  ``.npz`` file in the JAX package's layout; :mod:`~wlsqm_tpu_torch.utils.profiling`
  — a synchronising timer and a ``torch.profiler`` trace;
* :mod:`~wlsqm_tpu_torch.warmup` — build the kernels and warm the routes;
* :mod:`~wlsqm_tpu_torch.examples` — a counterpart of each of the JAX
  package's examples (the heat and Euler time steppers, the adjoint
  recovery, stencil design, the response surface, the tour, ExpertSolver,
  the sharded pipeline, plan replay, the drivers benchmark).

The CUDA sources are in ``csrc/``, built with nvcc at first use by
:mod:`~wlsqm_tpu_torch.native`.  Without ``device=``, the entry points
compute on the CUDA card and raise where there is none; ``device="cpu"``
computes on the CPU.
"""

from wlsqm_tpu_torch import config  # noqa: F401  (TF32 off)
from wlsqm_tpu_torch.config import (  # noqa: F401
    set_compat_precision,
    compat_precision,
)
from wlsqm_tpu_torch.fitter.defs import *  # noqa: F401,F403  constants + number_of_dofs
from wlsqm_tpu_torch.fitter.simple import *  # noqa: F401,F403  fit_* family
from wlsqm_tpu_torch.fitter.interp import (  # noqa: F401
    interpolate_fit,
    lambdify_fit,
    interpolate_continuous,
)
from wlsqm_tpu_torch.fitter.expert import ExpertSolver  # noqa: F401
from wlsqm_tpu_torch.api import (  # noqa: F401
    fit,
    fit_many,
    fit_stream,
    plan_fit_many,
    FitPlan,
    FitResult,
    prepare,
    solve,
    interpolate,
)
from wlsqm_tpu_torch.fitter.engine import Prepared  # noqa: F401
from wlsqm_tpu_torch.warmup import warmup  # noqa: F401
