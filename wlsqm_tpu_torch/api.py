"""Functional PyTorch API for wlsqm_tpu_torch.

Port of :mod:`wlsqm_tpu.api`: ``fit_many`` and its plan, the expert-mode
``prepare`` / ``solve`` pair and ``interpolate``.  Typical flow::

    import wlsqm_tpu_torch as wtt

    plan = wtt.plan_fit_many(xk[:32768], xi[:32768], order=4,
                             weighting=wtt.WEIGHT_CENTER, do_sens=True)
    res = wtt.fit_many(xk, fk, xi, order=4, weighting=wtt.WEIGHT_CENTER,
                       do_sens=True, plan=plan)
    res.fi, res.sens                       # (B, NO) DOFs, (B, K, NO) d fi / d fk

    prep = wtt.prepare(xk, xi, order=2)    # geometry once (an IBVP cloud)
    fi, sens = wtt.solve(prep, fk)         # every step; fk (F, B, K) for F fields

Routing is by configuration: a homogeneous group with enough neighbours
runs on a kernel — the moment kernel
(:func:`wlsqm_tpu_torch.ops.fit_kernel.supported`: dim 2, basic, no
knowns) where it covers the group, else the rows kernel
(:func:`wlsqm_tpu_torch.ops.fit_rows.supported`: dims 1-3, knowns,
sensitivities, ALGO_ITERATIVE) — the CUDA kernel for CUDA tensors, its
plain torch version for CPU tensors; everything else runs ONE f64 engine
call.  There is no conditioning probe and no precision ladder: every route
computes in f64.  Without ``device=``, NumPy input and CPU tensors go to
the card, and a machine without one raises (``device="cpu"`` runs on the
CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import defs, engine, interp, ladder
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows
from wlsqm_tpu_torch.ops import solve as solve_ops

__all__ = ["FitResult", "FitPlan", "fit", "fit_many", "plan_fit_many", "prepare",
           "solve", "interpolate"]

#: backend names; the JAX package's "pallas" and "xla" are synonyms
_BACKENDS = {"auto": "auto", "kernel": "kernel", "engine": "engine",
             "pallas": "kernel", "xla": "engine"}


@dataclasses.dataclass(frozen=True)
class FitPlan:
    """A static routing decision for :func:`fit_many`.

    Computed once by :func:`plan_fit_many` and passed back via
    ``fit_many(..., plan=plan)``, it replays the decision with no inspection
    of the data.  Valid for batches with the same static configuration
    (dimension, order, knowns, weighting, do_sens, iterative).
    """

    route: ladder.Route


@dataclasses.dataclass(frozen=True)
class FitResult:
    """Result of a batched fit.

    fi          : (B, NO) solved DOFs (function value + derivatives at xi)
    sens        : (B, K, NO) sensitivities d fi / d fk, or None
    iterations  : (B,) refinement iterations taken (0 for the basic algorithm)
    cond_scaled : (B,) 2-norm condition numbers of the scaled matrices
                  (NaN unless debug=True)
    """

    fi: torch.Tensor
    sens: torch.Tensor | None
    iterations: torch.Tensor
    cond_scaled: torch.Tensor

    @property
    def ok(self) -> torch.Tensor:
        """(B,) per-case success flags: all solved DOFs finite."""
        return torch.isfinite(self.fi).all(dim=-1)


def _assembly(dim, order, knowns, weighting, do_sens, iterative, want=None):
    """The kernel body for a homogeneous group: "moments" where the moment
    kernel covers it, else "rows" where the rows kernel does, else None.
    ``want`` (a plan's ``route.assembly``) restricts the choice to one body."""
    if want in (None, "moments") and fit_kernel.supported(
            dim, order, knowns, weighting, do_sens=do_sens, iterative=iterative):
        return "moments"
    if want in (None, "rows") and fit_rows.supported(dim, order, knowns, weighting):
        return "rows"
    return None


def _run_kernel_group(xk, fk, nk, xi, fi_init, *, dim, order, knowns, weighting,
                      assembly, refine_steps, do_sens, iterative, max_iter):
    """Run one homogeneous group through a kernel body ("moments" or "rows").

    Returns (fi (B, no_g), iters (B,), sens (B, K, no_g) | None).
    """
    rs = fit_kernel.DEFAULT_REFINE_STEPS if refine_steps is None else refine_steps
    if assembly == "moments":
        fi = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=dim, order=order,
                                   weighting=weighting, refine_steps=rs)
        return fi, torch.zeros(xk.shape[0], dtype=torch.int32, device=fi.device), None
    return fit_rows.fit_rows(xk, fk, nk, xi, fi_init, dimension=dim, order=order,
                             weighting=weighting, knowns=knowns, refine_steps=rs,
                             do_sens=do_sens, max_iter=max_iter if iterative else 0)


def _embed_kernel_result(fi_g, iters, sens, fi_init, B, NO, dim, order) -> FitResult:
    """Embed a kernel group result (no_g DOFs) into the caller's NO-column
    layout, keeping ``fi_init`` values on the inactive trailing DOFs and
    zero sensitivities there (the engine's convention)."""
    no_g = defs.number_of_dofs(dim, order)
    fi = fi_g
    if no_g < NO:
        tail = (fi.new_zeros((B, NO - no_g)) if fi_init is None
                else fi_init[:, no_g:NO])
        fi = torch.cat([fi, tail], dim=1)
        if sens is not None:
            sens = torch.cat([sens, sens.new_zeros(sens.shape[:2] + (NO - no_g,))],
                             dim=2)
    return FitResult(fi=fi, sens=sens, iterations=iters,
                     cond_scaled=torch.full((B,), torch.nan, dtype=fi.dtype,
                                            device=fi.device))


def _scalar(v) -> int | None:
    """A per-batch parameter as an int; None when it is given per case."""
    if isinstance(v, torch.Tensor):
        return int(v.item()) if v.ndim == 0 else None
    return int(v) if np.ndim(v) == 0 else None


def _homogeneous(v, device) -> int | None:
    """The one value a parameter takes over the batch, or None."""
    s = _scalar(v)
    if s is not None:
        return s
    lo, hi = torch.aminmax(config.as_tensor(v, device, torch.int64))
    return int(lo) if bool(lo == hi) else None


def _validate_weighting(weighting, device) -> None:
    """Reject unknown weighting ids: the engine treats any non-CENTER id as
    uniform, so an invalid id would silently change semantics.  Per-case
    ids are checked on the device; only the bad ones come to the host."""
    s = _scalar(weighting)
    if s is not None:
        bad = [] if s in (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER) else [s]
    else:
        w = config.as_tensor(weighting, device, torch.int64)
        mask = (w != defs.WEIGHT_UNIFORM) & (w != defs.WEIGHT_CENTER)
        bad = torch.unique(w[mask]).tolist() if bool(mask.any()) else []
    if bad:
        raise ValueError(
            "weighting must be WEIGHT_UNIFORM (%d) or WEIGHT_CENTER (%d) "
            "per case; got unknown ids %s"
            % (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER, sorted(bad)))


def _broadcast_case_param(value, B, dtype, device) -> torch.Tensor:
    arr = config.as_tensor(value, device, dtype)
    if arr.ndim == 0:
        arr = arr.expand(B).contiguous()
    return arr


def _canon_geometry(xk, xi, device):
    """Coerce (B,K)/(B,) 1D layouts to (B,K,1)/(B,1) f64 on ``device``;
    infer the dimension."""
    xk = config.as_tensor(xk, device)
    if xk.ndim == 2:
        xk = xk[..., None]
    B, K, dim = xk.shape
    if xi is None:
        xi = xk.new_zeros((B, dim))
    else:
        xi = config.as_tensor(xi, device)
        if xi.ndim == 1 and dim == 1:
            xi = xi[:, None]
    return xk, xi, B, K, dim


def _kernel_shape_ok(K: int, dim: int, order: int) -> bool:
    """Enough neighbors for auto routing to use the kernel (the JAX
    package's rule, api.py l.707 and l.873, so both route alike)."""
    return K >= (3 * defs.number_of_dofs(dim, order)) // 2


def fit_many(
    xk,
    fk,
    xi=None,
    *,
    nk=None,
    order=2,
    knowns=0,
    weighting=defs.WEIGHT_UNIFORM,
    fi_init=None,
    do_sens: bool = False,
    iterative: bool = False,
    max_iter: int = 10,
    max_order: int | None = None,
    debug: bool = False,
    precision: str | None = None,
    ruiz_max_iter: int = 100,
    scaling: str = "ruiz",
    solver: str = solve_ops.SOLVER_CHOLESKY,
    backend: str = "auto",
    refine_steps: int | None = None,
    plan: FitPlan | None = None,
    device=None,
) -> FitResult:
    """Fit a batch of local surrogate models.

    xk: (B, K, dim) neighbor coordinates ((B, K) accepted for 1D)
    fk: (B, K) data values at the neighbors
    xi: (B, dim) fit origins; defaults to zeros
    nk: (B,) valid neighbor counts; defaults to K for every case
    order / knowns / weighting: scalars or (B,) arrays (scalars broadcast)
    fi_init: (B, NO) initial DOF array carrying the known values; zeros if None
    precision: None or "f64" (every route computes in f64).
    backend: "auto" (default — per-(order, knowns, weighting) groups with
        K >= 1.5 NO run on a kernel, the moment kernel where it covers the
        group, else the rows kernel; the rest in ONE engine call), "kernel"
        (force a kernel; homogeneous batches only, any K) or "engine" (the
        batched f64 engine).  The JAX package's names "pallas" and "xla"
        are accepted for the last two.
    refine_steps: residual sweeps of the kernel (default 1).
    plan: a :class:`FitPlan` from :func:`plan_fit_many`; replays its route,
        kernel body included.
    device: where to compute; defaults to ``xk``'s device when it is a
        CUDA tensor, else the card: NumPy input and CPU tensors are moved
        there, and with no card the call raises.  ``device="cpu"`` computes
        on the CPU.

    Returns a :class:`FitResult` of tensors on that device.
    """
    if backend not in _BACKENDS:
        raise ValueError("backend must be one of %s; got %r"
                         % (sorted(_BACKENDS), backend))
    backend = _BACKENDS[backend]
    if precision not in (None, engine.PRECISION_F64):
        raise ValueError("precision must be None or 'f64'; got %r" % (precision,))

    device = config.resolve_device(device, xk)
    xk, xi, B, K, dim = _canon_geometry(xk, xi, device)
    fk = config.as_tensor(fk, device)
    if tuple(fk.shape) != (B, K):
        raise ValueError("fk must have shape (B, K) = (%d, %d) matching xk; got %s"
                         % (B, K, tuple(fk.shape)))
    nk = (torch.full((B,), K, dtype=torch.int32, device=device) if nk is None
          else config.as_tensor(nk, device, torch.int32))
    if tuple(nk.shape) != (B,):
        raise ValueError("nk must have shape (B,) = (%d,); got %s"
                         % (B, tuple(nk.shape)))
    _validate_weighting(weighting, device)

    if max_order is None:
        max_order = _scalar(order)
        if max_order is None:
            max_order = int(config.as_tensor(order, device, torch.int64).max())
    NO = defs.number_of_dofs(dim, max_order)
    if fi_init is not None:
        fi_init = config.as_tensor(fi_init, device)
        if fi_init.ndim != 2 or fi_init.shape[0] != B or fi_init.shape[1] < NO:
            raise ValueError("fi_init must have shape (B, >=NO) = (%d, >=%d); got %s"
                             % (B, NO, tuple(fi_init.shape)))

    want = None
    if plan is not None:
        backend = "kernel" if plan.route.path == "kernel" else "engine"
        want = plan.route.assembly
        if refine_steps is None:
            refine_steps = plan.route.refine_steps

    if backend == "kernel":
        o, kn, wm = (_homogeneous(v, device) for v in (order, knowns, weighting))
        assembly = (None if debug or None in (o, kn, wm)
                    else _assembly(dim, o, kn, wm, do_sens, iterative, want))
        if assembly is None:
            raise ValueError(
                "backend='kernel' requires a homogeneous batch (one order, knowns "
                "mask and weighting, UNIFORM or CENTER, no debug) that a kernel "
                "covers: the moment kernel takes dim 2 with no knowns, the basic "
                "algorithm and no sens; the rows kernel takes dims 1-3, orders "
                "0-4, knowns, sens and ALGO_ITERATIVE%s; use backend='auto' or "
                "'engine'" % ("" if want is None else
                              " (this plan replays the %s kernel)" % want))
        fi_g, it_g, sens_g = _run_kernel_group(
            xk, fk, nk, xi, fi_init, dim=dim, order=o, knowns=kn, weighting=wm,
            assembly=assembly, refine_steps=refine_steps, do_sens=do_sens,
            iterative=iterative, max_iter=max_iter)
        return _embed_kernel_result(fi_g, it_g, sens_g, fi_init, B, NO, dim, o)

    order_a = _broadcast_case_param(order, B, torch.int32, device)
    knowns_a = _broadcast_case_param(knowns, B, torch.int64, device)
    weighting_a = _broadcast_case_param(weighting, B, torch.int32, device)
    if backend == "auto" and not debug:
        scalars = tuple(_scalar(v) for v in (order, knowns, weighting))
        return _auto_dispatch(
            xk, fk, nk, xi, fi_init, dim=dim, B=B, K=K, NO=NO,
            order_a=order_a, knowns_a=knowns_a, weighting_a=weighting_a,
            groups=None if None in scalars else [scalars],
            do_sens=do_sens, iterative=iterative, max_iter=max_iter,
            refine_steps=refine_steps, ruiz_max_iter=ruiz_max_iter,
            scaling=scaling, solver=solver)

    fi0 = xk.new_zeros((B, NO)) if fi_init is None else fi_init[:, :NO]
    fi, sens, iters, cond = engine.fit_batch(
        xk, fk, nk, xi, fi0, order_a, knowns_a, weighting_a,
        dimension=dim, NO=NO, do_sens=do_sens, iterative=iterative,
        max_iter=max_iter, debug=debug, ruiz_max_iter=ruiz_max_iter,
        scaling=scaling, solver=solver)
    return FitResult(fi=fi, sens=sens if do_sens else None, iterations=iters,
                     cond_scaled=cond)


def _auto_dispatch(xk, fk, nk, xi, fi_init, *, dim, B, K, NO, order_a,
                   knowns_a, weighting_a, groups, do_sens, iterative, max_iter,
                   refine_steps, ruiz_max_iter, scaling, solver) -> FitResult:
    """Route a concrete batch by configuration.

    Groups the batch by (order, knowns, weighting) — ``groups`` holds the
    one group of a scalar configuration, else the groups are found on the
    device.  Each group with K >= 1.5 NO that a kernel covers runs on it
    (:func:`_assembly`); everything else merges into ONE engine call.
    """
    if groups is None:
        keys = torch.stack([order_a.long(), knowns_a, weighting_a.long()], dim=1)
        groups = [tuple(g) for g in torch.unique(keys, dim=0).tolist()]
    whole = len(groups) == 1

    fi_out = xk.new_zeros((B, NO)) if fi_init is None else fi_init[:, :NO].clone()
    iters_out = torch.zeros(B, dtype=torch.int32, device=xk.device)
    sens_out = None
    leftover = torch.ones(B, dtype=torch.bool, device=xk.device)
    for o, kn, wm in groups:
        assembly = (_assembly(dim, o, kn, wm, do_sens, iterative)
                    if _kernel_shape_ok(K, dim, o) else None)
        if assembly is None:
            continue
        kw = dict(dim=dim, order=o, knowns=kn, weighting=wm, assembly=assembly,
                  refine_steps=refine_steps, do_sens=do_sens, iterative=iterative,
                  max_iter=max_iter)
        if whole:
            fi_g, it_g, sens_g = _run_kernel_group(xk, fk, nk, xi, fi_init, **kw)
            return _embed_kernel_result(fi_g, it_g, sens_g, fi_init, B, NO, dim, o)
        mask = (order_a == o) & (knowns_a == kn) & (weighting_a == wm)
        sel = mask.nonzero().squeeze(1)
        fi_g, it_g, sens_g = _run_kernel_group(
            xk[sel], fk[sel], nk[sel], xi[sel],
            None if fi_init is None else fi_init[sel], **kw)
        fi_out[sel, :fi_g.shape[1]] = fi_g
        iters_out[sel] = it_g
        if do_sens:
            if sens_out is None:
                sens_out = xk.new_zeros((B, K, NO))
            sens_out[sel, :, :sens_g.shape[2]] = sens_g
        leftover &= ~mask

    if do_sens and sens_out is None:
        sens_out = xk.new_zeros((B, K, NO))
    if bool(leftover.any()):
        rest = leftover.nonzero().squeeze(1)
        fi_r, sens_r, iters_r, _ = engine.fit_batch(
            xk[rest], fk[rest], nk[rest], xi[rest], fi_out[rest], order_a[rest],
            knowns_a[rest], weighting_a[rest], dimension=dim, NO=NO,
            do_sens=do_sens, iterative=iterative, max_iter=max_iter,
            ruiz_max_iter=ruiz_max_iter, scaling=scaling, solver=solver)
        fi_out[rest] = fi_r
        iters_out[rest] = iters_r
        if do_sens:
            sens_out[rest] = sens_r

    return FitResult(fi=fi_out, sens=sens_out, iterations=iters_out,
                     cond_scaled=torch.full((B,), torch.nan, dtype=xk.dtype,
                                            device=xk.device))


def plan_fit_many(
    xk,
    xi=None,
    *,
    nk=None,
    order=2,
    knowns=0,
    weighting=defs.WEIGHT_UNIFORM,
    do_sens: bool = False,
    iterative: bool = False,
    precision: str | None = None,
    refine_steps: int | None = None,
    device=None,
) -> FitPlan:
    """A static :class:`FitPlan` for a homogeneous configuration.

    ``order``/``knowns``/``weighting`` must be scalars.  With K >= 1.5 NO
    the route is ``Route(path="kernel", kernel_precision="f64",
    assembly=...)``: "moments" when the moment kernel covers the
    configuration, else "rows" when the rows kernel does (knowns, dims 1
    and 3, ``do_sens``, ``iterative``) — on a CPU tensor a kernel route
    runs its plain torch version.  Otherwise it is
    ``Route(path="xla", precision="f64")`` (the engine).  Only the shapes
    of ``xk`` are read; ``nk`` is accepted for the JAX package's signature.
    """
    scalars = tuple(_scalar(v) for v in (order, knowns, weighting))
    for name, s in zip(("order", "knowns", "weighting"), scalars):
        if s is None:
            raise ValueError(
                "plan_fit_many requires a scalar %s (homogeneous batch); "
                "heterogeneous batches must use eager fit_many bucketing" % name)
    if precision not in (None, engine.PRECISION_F64):
        raise ValueError("precision must be None or 'f64'; got %r" % (precision,))
    device = config.resolve_device(device, xk)
    xk, _, _, K, dim = _canon_geometry(xk, xi, device)
    o, kn, wm = scalars
    assembly = (_assembly(dim, o, kn, wm, do_sens, iterative)
                if _kernel_shape_ok(K, dim, o) else None)
    if assembly is not None:
        return FitPlan(route=ladder.Route(
            path="kernel", kernel_precision="f64", assembly=assembly,
            refine_steps=(fit_kernel.DEFAULT_REFINE_STEPS if refine_steps is None
                          else refine_steps)))
    return FitPlan(route=ladder.Route(path="xla", precision=engine.PRECISION_F64))


def fit(xk, fk, xi=None, **kwargs) -> FitResult:
    """Single-neighborhood convenience wrapper: a batch of one.

    xk: (K, dim) or (K,) for 1D; fk: (K,); xi: (dim,) or scalar.  The
    returned FitResult has its leading batch axis squeezed away.
    """
    device = config.resolve_device(kwargs.pop("device", None), xk)
    xk = config.as_tensor(xk, device)
    if xk.ndim == 1:
        xk = xk[:, None]
    xi_b = None if xi is None else config.as_tensor(xi, device).reshape(1, -1)
    fi_init = kwargs.pop("fi_init", None)
    if fi_init is not None:
        fi_init = config.as_tensor(fi_init, device)[None, :]
    res = fit_many(xk[None], config.as_tensor(fk, device)[None], xi_b,
                   fi_init=fi_init, device=device, **kwargs)
    return FitResult(
        fi=res.fi[0],
        sens=None if res.sens is None else res.sens[0],
        iterations=res.iterations[0],
        cond_scaled=res.cond_scaled[0],
    )


def prepare(
    xk,
    xi=None,
    *,
    nk=None,
    order=2,
    knowns=0,
    weighting=defs.WEIGHT_UNIFORM,
    max_order: int | None = None,
    solver: str = solve_ops.SOLVER_CHOLESKY,
    debug: bool = False,
    precision: str | None = engine.PRECISION_F64,
    ruiz_max_iter: int = 100,
    scaling: str = "ruiz",
    device=None,
) -> engine.Prepared:
    """Prepare geometry for repeated solves (expert mode).

    Builds, scales and factors the normal matrices of a batch once and
    returns a :class:`~wlsqm_tpu_torch.fitter.engine.Prepared` to pass to
    :func:`solve`.  Sharing it between fields is the reference's "guest
    mode" (reference: wlsqm/fitter/expert.pyx:110-124).  Same arguments as
    the JAX package's ``prepare``; ``solver`` is ``"chol"`` and
    ``precision`` ``"f64"`` (or None).  ``device`` as for :func:`fit_many`.
    """
    if solver != solve_ops.SOLVER_CHOLESKY:
        raise ValueError(
            "solver %r is not ported: this package has 'chol' (the f64 Cholesky); "
            "'lu' and 'chol_unrolled' wait on ROADMAP item A2" % (solver,))
    if precision not in (None, engine.PRECISION_F64):
        raise ValueError(
            "precision must be None or 'f64'; got %r (the emulated precisions wait "
            "on ROADMAP item A15)" % (precision,))
    device = config.resolve_device(device, xk)
    xk, xi, B, K, dim = _canon_geometry(xk, xi, device)
    if tuple(xi.shape) != (B, dim):
        raise ValueError("xi must have shape (B, dim) = (%d, %d) matching xk; got %s"
                         % (B, dim, tuple(xi.shape)))
    nk = (torch.full((B,), K, dtype=torch.int32, device=device) if nk is None
          else config.as_tensor(nk, device, torch.int32))
    if tuple(nk.shape) != (B,):
        raise ValueError("nk must have shape (B,) = (%d,); got %s" % (B, tuple(nk.shape)))
    _validate_weighting(weighting, device)
    order_a = _broadcast_case_param(order, B, torch.int32, device)
    knowns_a = _broadcast_case_param(knowns, B, torch.int64, device)
    weighting_a = _broadcast_case_param(weighting, B, torch.int32, device)
    if max_order is None:
        max_order = _scalar(order)
        if max_order is None:
            max_order = int(order_a.max())
    return engine.prepare(
        xk, nk, xi, order_a, knowns_a, weighting_a, dimension=dim,
        NO=defs.number_of_dofs(dim, max_order), solver=solver, debug=debug,
        ruiz_max_iter=ruiz_max_iter, scaling=scaling)


def solve(
    prep: engine.Prepared,
    fk,
    fi_init=None,
    *,
    do_sens: bool = False,
    iterative: bool = False,
    max_iter: int = 10,
    mixed_steps: int | None = None,
):
    """Solve prepared systems against data ``fk``, on the prepared device.

    fk (B, K) solves one field; fk (F, B, K) solves F fields against the
    same factorization in one multi-RHS solve.  Returns (fi, sens) for the
    basic algorithm, or (fi, sens, iterations) with ``iterative=True``;
    outputs carry the leading field axis when fk does (sens is one
    geometry-only array, expanded).  ``mixed_steps`` belongs to the JAX
    package's emulated precisions and must be None.
    """
    if mixed_steps is not None:
        raise ValueError("mixed_steps needs the emulated precisions (ROADMAP A15); "
                         "this package solves in f64: pass None")
    device = prep.c.device
    fk = config.as_tensor(fk, device)
    B, K, NO = prep.c.shape
    if tuple(fk.shape[-2:]) != (B, K) or fk.ndim not in (2, 3):
        raise ValueError(
            "fk must have shape (B, K) = (%d, %d) matching the prepared geometry "
            "(or (F, B, K) for multi-field); got %s" % (B, K, tuple(fk.shape)))
    fi0 = (fk.new_zeros(fk.shape[:-1] + (NO,)) if fi_init is None
           else config.as_tensor(fi_init, device))
    if tuple(fi0.shape) != tuple(fk.shape[:-1]) + (NO,):
        raise ValueError("fi_init must have shape %s; got %s"
                         % (tuple(fk.shape[:-1]) + (NO,), tuple(fi0.shape)))
    if iterative:
        return engine.solve_iterative_prepared(prep, fk, fi0, max_iter, do_sens)
    return engine.solve_prepared(prep, fk, fi0, do_sens)


def interpolate(fi, xi, x, *, dimension: int, order: int, diff: int = 0, device=None):
    """Evaluate fitted models (or their derivatives) at query points.

    Alias of :func:`wlsqm_tpu_torch.fitter.interp.eval_fit`; batch axes of
    fi/xi/x broadcast.  ``device`` as for :func:`fit_many`.
    """
    return interp.eval_fit(fi, xi, x, dimension=dimension, order=order, diff=diff,
                           device=device)
