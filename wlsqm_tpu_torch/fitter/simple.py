"""Simple API: drop-in equivalents of the reference's 18 fitting entry points.

Port of :mod:`wlsqm_tpu.fitter.simple` (reference:
wlsqm/fitter/simple.pyx:60-604 — ``fit_{1D,2D,3D}`` × {basic, iterative} ×
{single, many, many_parallel}).

These are the NumPy-facing wrappers: they take the reference's array
layouts, write results **in place** into the caller's ``fi`` (and
``sens``) arrays after the whole batch is computed (so ``fk`` may be a view
of ``fi``, reference: wlsqm/fitter/simple.pyx:1010-1016), and return the
largest refinement iteration count.  Each call is one
:func:`wlsqm_tpu_torch.api.fit_many`:

* ``debug``, strict compat (:func:`wlsqm_tpu_torch.config.compat_precision`
  is ``"f64"``) or an iterative call under count fidelity
  (:func:`wlsqm_tpu_torch.config.iter_count_fidelity` with ``compat=True``,
  on by default) → ``backend="engine"``, the f64 engine;
* everything else → ``backend="auto"`` with ``gate="data"``: each
  homogeneous group that a CUDA fit kernel covers runs it (the moment
  kernel, else the rows kernel) with its conditioning key, and each case
  keeps the kernel's result only when the key times its data scale
  (max|fk| / max(|fi|, 1)) is under the calibration record's data edge;
  the other cases, and the groups no kernel covers, take the f64 engine.
  The data gate holds the 1e-10 bar on fields whose DOFs are of the size of
  their values, where the geometry-only certificate of ``fit_many``'s
  default does not (ROADMAP C4).

The ``*_many_parallel`` variants are the same call; ``ntasks`` is accepted
for source compatibility and ignored (the batch axis replaces OpenMP
threads).  One keyword is added to every entry, ``device=``: the card
unless ``device="cpu"``, and a machine without a card raises
(:func:`wlsqm_tpu_torch.config.resolve_device`).

Two parts of the JAX package's module are left out on purpose: its detour
of batches under 256 cases to the host CPU (a fallback that leaves the
device), and the power-of-two padding of the batch and neighbour axes
(which exists only to spare XLA recompiles; PyTorch runs eagerly).
"""

from __future__ import annotations

import numpy as np

from wlsqm_tpu_torch import api, config
from wlsqm_tpu_torch.fitter import defs

__all__ = [
    "fit_1D", "fit_1D_iterative", "fit_1D_many", "fit_1D_iterative_many",
    "fit_1D_many_parallel", "fit_1D_iterative_many_parallel",
    "fit_2D", "fit_2D_iterative", "fit_2D_many", "fit_2D_iterative_many",
    "fit_2D_many_parallel", "fit_2D_iterative_many_parallel",
    "fit_3D", "fit_3D_iterative", "fit_3D_many", "fit_3D_iterative_many",
    "fit_3D_many_parallel", "fit_3D_iterative_many_parallel",
]


def _compat_backend(iterative: bool, debug: bool) -> str:
    """The ``fit_many`` backend of a compat call: "engine" under ``debug``,
    strict compat or iterative count fidelity, else "auto"."""
    strict = config.compat_precision() == "f64" or (
        iterative and config.iter_count_fidelity(compat=True))
    return "engine" if debug or strict else "auto"


def _fit_many_host(dimension, xk, fk, nk, xi, fi, sens, do_sens, order, knowns,
                   weighting_method, iterative, max_iter, debug, device):
    """The body of every variant: one ``fit_many``, then the write-back.

    ``fk`` and the known values are copied before they go to the device (on
    the CPU a tensor would share the caller's memory, and ``fk`` may view
    ``fi``), and ``fi``/``sens`` are written only once every result exists.
    """
    xk = np.asarray(xk, dtype=np.float64)
    order = np.asarray(order, dtype=np.int32)
    B, K = xk.shape[0], xk.shape[1]
    xk_b = xk[:, :, None] if dimension == 1 else xk
    xi_b = np.asarray(xi, dtype=np.float64).reshape(B, dimension)
    NO = defs.number_of_dofs(dimension, int(order.max()))
    fi_np = np.asarray(fi)
    want_sens = bool(do_sens)
    if want_sens and sens is None:
        raise ValueError("do_sens=True requires a sens output array")

    backend = _compat_backend(iterative, debug)
    res = api.fit_many(
        xk_b, np.array(fk, dtype=np.float64), xi_b,
        nk=np.asarray(nk, dtype=np.int32), order=order,
        knowns=np.asarray(knowns, dtype=np.int64),
        weighting=np.asarray(weighting_method, dtype=np.int32),
        fi_init=np.array(fi_np[:, :NO], dtype=np.float64),
        do_sens=want_sens, iterative=bool(iterative), max_iter=int(max_iter),
        max_order=int(order.max()), debug=bool(debug),
        backend=backend, gate="data", device=device)
    fi_out = res.fi.cpu().numpy()
    sens_out = res.sens.cpu().numpy() if want_sens else None
    iters = int(res.iterations.max()) if B else 0

    fi_np[:, :NO] = fi_out
    if want_sens:
        if backend == "auto":   # the JAX package's kernel-route write-back
            sens[...] = 0.0
        sens[:, :K, :NO] = sens_out
    return iters


def _fit_one_host(dimension, xk, fk, xi, fi, sens, do_sens, order, knowns,
                  weighting_method, iterative, max_iter, debug, device):
    """Single-case wrapper: a many-case batch of size 1 (views of the
    caller's ``fi``/``sens``, so the write-back lands in place)."""
    xk = np.asarray(xk, dtype=np.float64)
    return _fit_many_host(
        dimension, xk[None, ...], np.asarray(fk, dtype=np.float64)[None, :],
        np.array([xk.shape[0]], dtype=np.int32),
        np.asarray(xi, dtype=np.float64).reshape(1, dimension),
        np.asarray(fi)[None, :], None if sens is None else np.asarray(sens)[None, :, :],
        do_sens, np.array([order], dtype=np.int32), np.array([knowns], dtype=np.int64),
        np.array([weighting_method], dtype=np.int32), iterative, max_iter, debug,
        device)


# -----------------------------------------------------------------------------
# Public API — signatures mirror the reference (reference: wlsqm/fitter/simple.pyx)
# -----------------------------------------------------------------------------

def _make_single(dimension, iterative, default_knowns):
    if iterative:
        def fit(xk, fk, xi, fi, sens=None, do_sens=0, order=2,
                knowns=default_knowns, weighting_method=defs.WEIGHT_CENTER,
                max_iter=10, debug=0, *, device=None):
            return _fit_one_host(dimension, xk, fk, xi, fi, sens, do_sens,
                                 order, knowns, weighting_method, True,
                                 max_iter, debug, device)
    else:
        def fit(xk, fk, xi, fi, sens=None, do_sens=0, order=2,
                knowns=default_knowns, weighting_method=defs.WEIGHT_CENTER,
                debug=0, *, device=None):
            return _fit_one_host(dimension, xk, fk, xi, fi, sens, do_sens,
                                 order, knowns, weighting_method, False,
                                 10, debug, device)
    return fit


def _make_many(dimension, iterative):
    if iterative:
        def fit(xk, fk, nk, xi, fi, sens, do_sens, order, knowns,
                weighting_method, max_iter=10, debug=0, *, device=None):
            return _fit_many_host(dimension, xk, fk, nk, xi, fi, sens,
                                  do_sens, order, knowns, weighting_method,
                                  True, max_iter, debug, device)
    else:
        def fit(xk, fk, nk, xi, fi, sens, do_sens, order, knowns,
                weighting_method, debug=0, *, device=None):
            return _fit_many_host(dimension, xk, fk, nk, xi, fi, sens,
                                  do_sens, order, knowns, weighting_method,
                                  False, 10, debug, device)
    return fit


def _make_many_parallel(dimension, iterative):
    if iterative:
        def fit(xk, fk, nk, xi, fi, sens, do_sens, order, knowns,
                weighting_method, max_iter=10, ntasks=8, debug=0, *, device=None):
            return _fit_many_host(dimension, xk, fk, nk, xi, fi, sens,
                                  do_sens, order, knowns, weighting_method,
                                  True, max_iter, debug, device)
    else:
        def fit(xk, fk, nk, xi, fi, sens, do_sens, order, knowns,
                weighting_method, ntasks=8, debug=0, *, device=None):
            return _fit_many_host(dimension, xk, fk, nk, xi, fi, sens,
                                  do_sens, order, knowns, weighting_method,
                                  False, 10, debug, device)
    return fit


_DEFAULT_KNOWNS = {1: defs.b1_F, 2: defs.b2_F, 3: defs.b3_F}

fit_1D = _make_single(1, False, _DEFAULT_KNOWNS[1])
fit_1D_iterative = _make_single(1, True, _DEFAULT_KNOWNS[1])
fit_1D_many = _make_many(1, False)
fit_1D_iterative_many = _make_many(1, True)
fit_1D_many_parallel = _make_many_parallel(1, False)
fit_1D_iterative_many_parallel = _make_many_parallel(1, True)

fit_2D = _make_single(2, False, _DEFAULT_KNOWNS[2])
fit_2D_iterative = _make_single(2, True, _DEFAULT_KNOWNS[2])
fit_2D_many = _make_many(2, False)
fit_2D_iterative_many = _make_many(2, True)
fit_2D_many_parallel = _make_many_parallel(2, False)
fit_2D_iterative_many_parallel = _make_many_parallel(2, True)

fit_3D = _make_single(3, False, _DEFAULT_KNOWNS[3])
fit_3D_iterative = _make_single(3, True, _DEFAULT_KNOWNS[3])
fit_3D_many = _make_many(3, False)
fit_3D_iterative_many = _make_many(3, True)
fit_3D_many_parallel = _make_many_parallel(3, False)
fit_3D_iterative_many_parallel = _make_many_parallel(3, True)

for _dim in (1, 2, 3):
    for _name, _doc in (
        ("fit_%dD", "Fit one local model to %dD scalar data."),
        ("fit_%dD_iterative",
         "Fit one local model to %dD scalar data, with iterative refinement."),
        ("fit_%dD_many", "Fit many local models to %dD scalar data (batched)."),
        ("fit_%dD_iterative_many",
         "Fit many local models to %dD scalar data (batched), with iterative refinement."),
        ("fit_%dD_many_parallel",
         "Fit many local models to %dD scalar data (batched; ntasks accepted for compatibility)."),
        ("fit_%dD_iterative_many_parallel",
         "Fit many local models to %dD scalar data (batched, iterative; ntasks accepted for compatibility)."),
    ):
        _f = globals()[_name % _dim]
        _f.__name__ = _name % _dim
        _f.__qualname__ = _f.__name__
        _f.__doc__ = (
            (_doc % _dim)
            + "\n\nArray layouts, defaults and in-place output semantics follow the"
            " reference API\n(reference: wlsqm/fitter/simple.pyx); the batch is one"
            " ``api.fit_many`` call on\n``device`` (the CUDA card unless"
            " ``device=\"cpu\"``). Returns the number of\nrefinement iterations"
            " taken (0 for the basic algorithm)."
        )
del _dim, _name, _doc, _f
