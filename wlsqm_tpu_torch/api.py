"""Functional PyTorch API for wlsqm_tpu_torch.

Port of :mod:`wlsqm_tpu.api`: ``fit_many`` and its plan, ``fit_stream``
for clouds in host memory, the expert-mode ``prepare`` / ``solve`` pair and
``interpolate``.  Typical flow::

    import wlsqm_tpu_torch as wtt

    plan = wtt.plan_fit_many(xk[:32768], xi[:32768], order=4,
                             weighting=wtt.WEIGHT_CENTER, do_sens=True)
    res = wtt.fit_many(xk, fk, xi, order=4, weighting=wtt.WEIGHT_CENTER,
                       do_sens=True, plan=plan)
    res.fi, res.sens                       # (B, NO) DOFs, (B, K, NO) d fi / d fk

    prep = wtt.prepare(xk, xi, order=2)    # geometry once (an IBVP cloud)
    fi, sens = wtt.solve(prep, fk)         # every step; fk (F, B, K) for F fields

Routing is by configuration and by conditioning.  A homogeneous group with
enough neighbours is kernel-eligible — the moment kernel
(:func:`wlsqm_tpu_torch.ops.fit_kernel.supported`: dims 1-3, orders 0-4,
knowns, ALGO_ITERATIVE; on the certified routes dims 1-2,
:func:`wlsqm_tpu_torch.ops.fit_kernel.cert_ok`) where it covers the group,
else the rows kernel (:func:`wlsqm_tpu_torch.ops.fit_rows.supported`: the
same and sensitivities), as the JAX package routes; the CUDA kernel for
CUDA tensors, its plain torch version for CPU tensors.  ``backend="auto"`` and ``plan_fit_many``
then probe the group's conditioning
(:func:`wlsqm_tpu_torch.fitter.condprobe.probe`) and take the cheapest rung
of :func:`wlsqm_tpu_torch.fitter.ladder.choose` that the device's
calibration record certifies to 1e-10 against a correct f64 fit: a kernel
for the whole group; or, for the basic algorithm, the per-case split — the
kernel on every case with its per-case conditioning key, and the f64 engine
on exactly the cases whose key exceeds the certified edge; or the engine.
Every route computes in f64.  Everything not kernel-eligible runs in ONE
engine call.  Without ``device=``, NumPy input and CPU tensors go to the
card, and a machine without one raises (``device="cpu"`` runs on the CPU).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import warnings

import numpy as np
import torch

from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import calibration, condprobe, defs, engine, interp, ladder
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows
from wlsqm_tpu_torch.ops import solve as solve_ops
from wlsqm_tpu_torch.utils import profiling

__all__ = ["FitResult", "FitPlan", "fit", "fit_many", "fit_stream", "plan_fit_many",
           "prepare", "solve", "interpolate"]

#: backend names; the JAX package's "pallas" and "xla" are synonyms
_BACKENDS = {"auto": "auto", "kernel": "kernel", "engine": "engine",
             "pallas": "kernel", "xla": "engine"}

#: precision names of the JAX package; this package computes each in f64
_PRECISIONS = (None, engine.PRECISION_F64, "mixed", "fast", "ds")


def _check_precision(precision) -> None:
    if precision not in _PRECISIONS:
        raise ValueError("precision must be None, 'f64', 'mixed', 'fast' or 'ds' "
                         "(each computes in f64 here); got %r" % (precision,))


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


def _assembly(dim, order, knowns, weighting, do_sens, want=None, *, forced=False):
    """The kernel body for a homogeneous group: "moments" where the moment
    kernel covers it, else "rows" where the rows kernel does, else None.

    As in the JAX package, the certified routes (``backend="auto"``,
    :func:`plan_fit_many`) take the moment body only where its calibration
    units hold (:func:`fit_kernel.cert_ok`: dims 1-2), and a forced kernel
    (``backend="kernel"``) wherever it runs (:func:`fit_kernel.supported`,
    whose lattice guard is :func:`fit_kernel.auto_ok`: 3D too).
    Sensitivities need the rows body.  ``want`` (a plan's
    ``route.assembly``) restricts the choice to one body."""
    if (want in (None, "moments")
            and fit_kernel.supported(dim, order, knowns, weighting, do_sens=do_sens)
            and (forced or fit_kernel.cert_ok(dim, int(order)))):
        return "moments"
    if want in (None, "rows") and fit_rows.supported(dim, order, knowns, weighting):
        return "rows"
    return None


def _run_kernel_group(xk, fk, nk, xi, fi_init, *, dim, order, knowns, weighting,
                      assembly, refine_steps, do_sens=False, iterative=False,
                      max_iter=0, emit_cond=False):
    """Run one homogeneous group through a kernel body ("moments" or "rows").

    Returns (fi (B, no_g), iters (B,), sens (B, K, no_g) | None), and with
    ``emit_cond`` the per-case conditioning key (B,) after them.
    """
    rs = fit_kernel.DEFAULT_REFINE_STEPS if refine_steps is None else refine_steps
    mi = max_iter if iterative else 0
    if assembly == "moments":
        with profiling.span("api.kernel"):
            out = fit_kernel.fit_kernel(xk, fk, nk, xi, fi_init, dimension=dim,
                                        order=order, weighting=weighting, knowns=knowns,
                                        refine_steps=rs, max_iter=mi, emit_cond=emit_cond)
        out = out if isinstance(out, tuple) else (out,)
        iters = (out[1] if mi else
                 torch.zeros(xk.shape[0], dtype=torch.int32, device=out[0].device))
        return (out[0], iters, None) + ((out[-1],) if emit_cond else ())
    with profiling.span("api.kernel"):
        return fit_rows.fit_rows(xk, fk, nk, xi, fi_init, dimension=dim, order=order,
                                 weighting=weighting, knowns=knowns, refine_steps=rs,
                                 do_sens=do_sens, max_iter=mi, emit_cond=emit_cond)


def _engine_group(xk, fk, nk, xi, fi_init, *, dim, order, knowns, weighting):
    """The basic fit of a homogeneous group on the f64 engine: the tail rung
    of the split routes.  Returns fi (n, no_g)."""
    n = xk.shape[0]
    no_g = defs.number_of_dofs(dim, order)
    fi0 = xk.new_zeros((n, no_g)) if fi_init is None else fi_init[:, :no_g]

    def full(v, dtype):
        return torch.full((n,), v, dtype=dtype, device=xk.device)

    return engine.fit_batch(xk, fk, nk, xi, fi0, full(order, torch.int32),
                            full(knowns, torch.int64), full(weighting, torch.int32),
                            dimension=dim, NO=no_g)[0]


def _first_over_edge(est, edge: float, k: int):
    """Indices of the first ``k`` cases whose key fails ``est <= edge`` (NaN
    keys fail), in order, padded with B: a static-shape compaction with no
    host synchronisation."""
    B = est.shape[0]
    bad = ~(est <= edge)
    pos = torch.cumsum(bad, 0) - 1
    slot = torch.where(bad & (pos < k), pos, k)      # slot k collects the rest
    idx = torch.full((k + 1,), B, dtype=torch.int64, device=est.device)
    idx.scatter_(0, slot, torch.arange(B, device=est.device))
    return idx[:k]


def _run_kernel_split(xk, fk, nk, xi, fi_init, *, dim, order, knowns, weighting,
                      route):
    """Run one homogeneous group through the per-case certified split.

    The ``route.assembly`` kernel fits ALL cases and emits the per-case
    conditioning key; the cases whose key exceeds ``route.split_edge`` — the
    first of them in order, up to the static ``route.tail_frac`` window — are
    re-solved by the f64 engine and scattered over the kernel's result.
    Cases beyond the window stay on the kernel's (uncertified) result.
    Shapes are static throughout and nothing is read back, so a planned call
    never waits for the host here.  Certified cases take the kernel's
    envelope, tail cases the engine's result — a per-case decision over EVERY
    case, which the sampled probe of the batch-level routes cannot give.
    Basic algorithm only.  Returns (fi (B, no_g), iters zeros, None) like
    :func:`_run_kernel_group`.
    """
    B = xk.shape[0]
    kw = dict(dim=dim, order=order, knowns=knowns, weighting=weighting)
    fi, iters, _, est = _run_kernel_group(
        xk, fk, nk, xi, fi_init, assembly=route.assembly,
        refine_steps=route.refine_steps, emit_cond=True, **kw)
    if B == 0:
        return fi, iters, None
    k = max(1, min(int(np.ceil(route.tail_frac * B)), B))
    idx = _first_over_edge(est, route.split_edge, k)
    idxc = idx.clamp_max(B - 1)            # clipped gather; the fills are dropped
    fi_tail = _engine_group(xk[idxc], fk[idxc], nk[idxc], xi[idxc],
                            None if fi_init is None else fi_init[idxc], **kw)
    with profiling.span("api.split_scatter"):
        out = torch.cat([fi, fi.new_empty((1, fi.shape[1]))])   # row B takes the fills
        out[idx] = fi_tail
    return out[:B], iters, None


def _eager_split_group(xk, fk, nk, xi, fi_init, *, dim, order, knowns, weighting,
                       assembly, edge):
    """Eager (concrete-data) per-case split of one homogeneous group.

    Unlike the planned :func:`_run_kernel_split`, the eager path reads the
    kernel-emitted key and re-solves EXACTLY the uncertified cases on the f64
    engine — no static tail window, no margin: every case is either under
    the certified edge on the kernel, or solved by the reference algorithm.
    """
    kw = dict(dim=dim, order=order, knowns=knowns, weighting=weighting)
    fi, iters, _, est = _run_kernel_group(
        xk, fk, nk, xi, fi_init, assembly=assembly,
        refine_steps=condprobe.pick_steps_at_edge(edge, assembly=assembly),
        emit_cond=True, **kw)
    with profiling.span("api.split_select"):
        sel = (~(est <= edge)).nonzero().squeeze(1)
    if sel.numel():
        fi_tail = _engine_group(xk[sel], fk[sel], nk[sel], xi[sel],
                                None if fi_init is None else fi_init[sel], **kw)
        with profiling.span("api.split_scatter"):
            fi[sel] = fi_tail
    return fi, iters, None


def _data_gated_group(xk, fk, nk, xi, fi_init, *, dim, order, knowns, weighting,
                      assembly, refine_steps, do_sens, iterative, max_iter, edge):
    """Run one homogeneous group under the data gate (``gate="data"``).

    The ``assembly`` kernel fits every case and emits its key; a case keeps
    the kernel's result when key * max|fk| / max(|fi|, 1)
    (:func:`wlsqm_tpu_torch.fitter.calibration.data_ratio`) is at most
    ``edge`` (:func:`wlsqm_tpu_torch.fitter.condprobe.data_edges`), and every
    other case (NaN keys included) is solved again by the f64 engine, with
    its sensitivities and iteration count.  Reads the failing cases back to
    the host once.  Returns (fi (B, no_g), iters (B,), sens | None).
    """
    fi, iters, sens, est = _run_kernel_group(
        xk, fk, nk, xi, fi_init, dim=dim, order=order, knowns=knowns,
        weighting=weighting, assembly=assembly, refine_steps=refine_steps,
        do_sens=do_sens, iterative=iterative, max_iter=max_iter, emit_cond=True)
    with profiling.span("api.split_select"):
        sel = (~(est * calibration.data_ratio(fi, fk, nk) <= edge)).nonzero().squeeze(1)
    if sel.numel():
        n, no_g = sel.numel(), fi.shape[1]

        def full(v, dtype):
            return torch.full((n,), v, dtype=dtype, device=xk.device)

        fi0 = (xk.new_zeros((n, no_g)) if fi_init is None
               else fi_init[sel, :no_g])
        fi_t, sens_t, it_t, _ = engine.fit_batch(
            xk[sel], fk[sel], nk[sel], xi[sel], fi0, full(order, torch.int32),
            full(knowns, torch.int64), full(weighting, torch.int32), dimension=dim,
            NO=no_g, do_sens=do_sens, iterative=iterative, max_iter=max_iter)
        with profiling.span("api.split_scatter"):
            fi[sel] = fi_t
            iters[sel] = it_t.to(iters.dtype)
            if do_sens:
                sens[sel] = sens_t
    return fi, iters, sens


def _maybe_split_route(route, xk, nk, xi, *, dim, o, kn, wm, assembly,
                       certified: bool, basic: bool):
    """Re-route an uncertified batch-level route on the FULL key distribution.

    The sampled probe that picked the batch-level route sees a few hundred
    cases, so a batch it could not certify may still be certifiable case by
    case.  This pass launches the ``assembly`` kernel with ``emit_cond`` on
    the concrete planning batch (data zero: the key depends on the geometry
    alone) and re-routes on the exact key distribution, fastest per-case-sound
    rung first:

    1. every key under a body's key edge -> the whole batch on that kernel
       (the moment body first), now certified per case, not on the sample;
    2. a certified majority (:data:`ladder.SPLIT_MIN_FRAC`) -> the
       "kernel-split" route: the kernel for all, the engine for the tail
       window (the planning batch's tail fraction times
       :data:`ladder.TAIL_MARGIN`).

    A NaN key (a degenerate case) poisons the maximum, failing rung 1 —
    exactly right: such cases certify nothing.  A route the sample already
    certified, and a batch with sensitivities or ALGO_ITERATIVE, pass
    through untouched.  The decision needs concrete data; replayed batches
    ride the plan-representativeness contract that FitPlan carries
    throughout.
    """
    if certified or not basic or assembly is None:
        return route
    edges = condprobe.est_certified_edges()
    if not edges.get(assembly):
        return route
    B, K, _ = xk.shape
    est = _run_kernel_group(xk, xk.new_zeros((B, K)), nk, xi, None, dim=dim,
                            order=o, knowns=kn, weighting=wm, assembly=assembly,
                            refine_steps=None, emit_cond=True)[3]
    max_est = float(est.max()) if B else float("nan")
    for body in (("moments", "rows") if assembly == "moments" else ("rows",)):
        if edges.get(body) and max_est <= edges[body]:
            return ladder.Route(
                path="kernel", assembly=body,
                refine_steps=condprobe.pick_steps_at_edge(max_est, assembly=body))
    _, edge = condprobe.split_partition_choice(assembly=assembly)
    frac_fast = float((est <= edge).double().mean())
    if frac_fast < ladder.SPLIT_MIN_FRAC:
        return route
    return ladder.Route(
        path="kernel-split", assembly=assembly,
        refine_steps=condprobe.pick_steps_at_edge(edge, assembly=assembly),
        split_edge=edge,
        tail_frac=float(min(1.0, (1.0 - frac_fast) * ladder.TAIL_MARGIN)))


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


_GRAD_HINT = (
    "differentiate through backend='engine' (wlsqm_tpu_torch.fitter.engine.fit_batch, "
    "gradients in xk, fk, xi and fi_init) or, for gradients in fk at kernel speed, "
    "wlsqm_tpu_torch.ops.fit_rows.fit_rows_diffable")


def _grad_to_engine(name: str) -> None:
    """The autograd rule of ``backend="auto"``: the kernels have no backward,
    so a call that autograd records runs the f64 engine, with a warning (the
    JAX package's rule for traced calls, wlsqm_tpu/api.py:589-603)."""
    warnings.warn(
        "%s(backend='auto') under autograd: an input requires grad and the CUDA "
        "kernels have no backward, so this call runs the f64 engine, which autograd "
        "differentiates (the JAX package degrades a traced call the same way). Under "
        "torch.no_grad() the call routes as usual; for gradients in fk at kernel "
        "speed use wlsqm_tpu_torch.ops.fit_rows.fit_rows_diffable." % name,
        UserWarning, stacklevel=3)


def _check_mixed_steps(mixed_steps) -> None:
    """``mixed_steps`` tunes the sweeps of the JAX package's emulated
    precisions ("mixed", "fast", "ds"); this package solves in f64, so only
    None is accepted."""
    if mixed_steps is not None:
        raise ValueError("mixed_steps belongs to the JAX package's emulated "
                         "precisions (\"mixed\", \"fast\", \"ds\"); this package "
                         "solves in f64: pass None")


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
    mixed_steps: int | None = None,
    plan: FitPlan | None = None,
    gate: str = "geometry",
    device=None,
) -> FitResult:
    """Fit a batch of local surrogate models.

    xk: (B, K, dim) neighbor coordinates ((B, K) accepted for 1D)
    fk: (B, K) data values at the neighbors
    xi: (B, dim) fit origins; defaults to zeros
    nk: (B,) valid neighbor counts; defaults to K for every case
    order / knowns / weighting: scalars or (B,) arrays (scalars broadcast)
    fi_init: (B, NO) initial DOF array carrying the known values; zeros if None
    precision: None, or one of the JAX package's names ("f64", "mixed",
        "fast", "ds"); every route computes in f64 whichever is given.
    backend: "auto" (default — per-(order, knowns, weighting) groups with
        K >= 1.5 NO that a kernel covers are probed and take the cheapest
        certified rung: the kernel, the per-case split or the engine; the
        rest runs in ONE engine call), "kernel" (force a kernel, no
        accuracy guard; homogeneous batches only, any K) or "engine" (the
        batched f64 engine).  The JAX package's names "pallas" and "xla"
        are accepted for the last two.
    refine_steps: residual sweeps of the kernel (default 1); given, the
        auto route does not split.
    mixed_steps: the sweep dial of the JAX package's emulated precisions;
        must be None (every route here solves in f64).
    plan: a :class:`FitPlan` from :func:`plan_fit_many`; replays its route,
        kernel body included, with no inspection of the data.
    gate: how ``backend="auto"`` certifies a kernel's result.  "geometry"
        (default): the sampled probe and the key against the calibration
        record's edges, which hold the 1e-10 bar for fields whose DOFs are
        large beside their values, and can miss it by ~10x on fields whose
        DOFs are of the size of their values (ROADMAP C4).  "data": every
        group a kernel covers runs it with its key, and each case keeps the
        kernel's result only when key * max|fk| / max(|fi|, 1) is under the
        record's data edge (:func:`wlsqm_tpu_torch.fitter.condprobe.data_edges`,
        fitted over several field families); every other case is solved
        again by the f64 engine.  No probe runs, and the failing cases are
        read back once.  The compat surface (``fit_*``) uses "data".
    device: where to compute; defaults to ``xk``'s device when it is a
        CUDA tensor, else the card: NumPy input and CPU tensors are moved
        there, and with no card the call raises.  ``device="cpu"`` computes
        on the CPU.

    Under autograd (grad mode on and any of xk, fk, xi, fi_init requiring
    grad) the kernels are never launched, since they have no backward:
    ``backend="auto"`` runs the f64 engine with a ``UserWarning``, and a
    kernel route (``backend="kernel"``, or a plan whose route is a kernel)
    raises ``ValueError``.  Under ``torch.no_grad()`` nothing changes.

    Returns a :class:`FitResult` of tensors on that device.
    """
    with profiling.span("api.checks"):
        if backend not in _BACKENDS:
            raise ValueError("backend must be one of %s; got %r"
                             % (sorted(_BACKENDS), backend))
        if gate not in ("geometry", "data"):
            raise ValueError("gate must be 'geometry' or 'data'; got %r" % (gate,))
        backend = _BACKENDS[backend]
        _check_precision(precision)
        _check_mixed_steps(mixed_steps)
        solve_ops.check_solver(solver)

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
        split = plan is not None and plan.route.path == "kernel-split"
        if plan is not None:
            if split and (do_sens or iterative):
                raise ValueError("a kernel-split plan covers the basic algorithm only; "
                                 "re-plan with do_sens/iterative set")
            backend = "engine" if plan.route.path == "xla" else "kernel"
            want = plan.route.assembly
            if refine_steps is None:
                refine_steps = plan.route.refine_steps

        if config.wants_grad(xk, fk, xi, fi_init):
            if backend == "kernel":
                raise ValueError(
                    "fit_many: a kernel route (backend='kernel' or a plan whose route is a "
                    "kernel) under autograd: the CUDA kernels have no backward, so the "
                    "gradient would be missing; %s, or call it under torch.no_grad()"
                    % _GRAD_HINT)
            if backend == "auto":
                _grad_to_engine("fit_many")
                backend = "engine"

        if backend == "kernel":
            o, kn, wm = (_homogeneous(v, device) for v in (order, knowns, weighting))
            assembly = (None if debug or None in (o, kn, wm)
                        else _assembly(dim, o, kn, wm, do_sens, want, forced=True))
            if assembly is None:
                raise ValueError(
                    "backend='kernel' requires a homogeneous batch (one order, knowns "
                    "mask and weighting, UNIFORM or CENTER, no debug) that a kernel "
                    "covers: the moment kernel takes dims 1-3, orders 0-4, knowns and "
                    "ALGO_ITERATIVE, but no sens; the rows kernel takes all of that and "
                    "sens%s; use backend='auto' or 'engine'"
                    % ("" if want is None else " (this plan replays the %s kernel)" % want))
        else:
            order_a = _broadcast_case_param(order, B, torch.int32, device)
            knowns_a = _broadcast_case_param(knowns, B, torch.int64, device)
            weighting_a = _broadcast_case_param(weighting, B, torch.int32, device)

    if backend == "kernel":
        if split:
            fi_g, it_g, sens_g = _run_kernel_split(
                xk, fk, nk, xi, fi_init, dim=dim, order=o, knowns=kn, weighting=wm,
                route=dataclasses.replace(plan.route, refine_steps=refine_steps))
        else:
            fi_g, it_g, sens_g = _run_kernel_group(
                xk, fk, nk, xi, fi_init, dim=dim, order=o, knowns=kn, weighting=wm,
                assembly=assembly, refine_steps=refine_steps, do_sens=do_sens,
                iterative=iterative, max_iter=max_iter)
        return _embed_kernel_result(fi_g, it_g, sens_g, fi_init, B, NO, dim, o)

    if backend == "auto" and not debug:
        scalars = tuple(_scalar(v) for v in (order, knowns, weighting))
        return _auto_dispatch(
            xk, fk, nk, xi, fi_init, dim=dim, B=B, K=K, NO=NO,
            order_a=order_a, knowns_a=knowns_a, weighting_a=weighting_a,
            groups=None if None in scalars else [scalars],
            do_sens=do_sens, iterative=iterative, max_iter=max_iter,
            refine_steps=refine_steps, ruiz_max_iter=ruiz_max_iter,
            scaling=scaling, solver=solver, gate=gate)

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
                   refine_steps, ruiz_max_iter, scaling, solver,
                   gate="geometry") -> FitResult:
    """Certified routing of a concrete batch (see fitter/ladder.py).

    Groups the batch by (order, knowns, weighting) — ``groups`` holds the
    one group of a scalar configuration, else the groups are found on the
    device.  Each group with K >= 1.5 NO that a kernel covers
    (:func:`_assembly`) is probed and takes the cheapest rung that clears
    the accuracy bar: the kernel for the whole group, the eager per-case
    split (basic algorithm, when the sampled probe predicts a certified
    majority), or the engine.  Everything else merges into ONE engine call:
    with a single engine rung there is nothing to choose for the leftover,
    so it is not probed.  The JAX package also keeps groups under a quarter
    tile on the engine; that rule guards its tile padding, which a CUDA grid
    does not have.  Under ``gate="data"`` a covered group is not probed: it
    runs :func:`_data_gated_group` when the record has a data edge for its
    body, else joins the engine call.
    """
    if groups is None:
        keys = torch.stack([order_a.long(), knowns_a, weighting_a.long()], dim=1)
        groups = [tuple(g) for g in torch.unique(keys, dim=0).tolist()]
    whole = len(groups) == 1

    fi_out = xk.new_zeros((B, NO)) if fi_init is None else fi_init[:, :NO].clone()
    iters_out = torch.zeros(B, dtype=torch.int32, device=xk.device)
    sens_out = None
    leftover = torch.ones(B, dtype=torch.bool, device=xk.device)
    count_fidelity = iterative and config.iter_count_fidelity()
    for o, kn, wm in groups:
        assembly = (_assembly(dim, o, kn, wm, do_sens)
                    if _kernel_shape_ok(K, dim, o) and not count_fidelity else None)
        if assembly is None:
            continue
        if whole:
            mask, data = None, (xk, fk, nk, xi, fi_init)
        else:
            mask = (order_a == o) & (knowns_a == kn) & (weighting_a == wm)
            sel = mask.nonzero().squeeze(1)
            data = (xk[sel], fk[sel], nk[sel], xi[sel],
                    None if fi_init is None else fi_init[sel])
        kw = dict(dim=dim, order=o, knowns=kn, weighting=wm)
        if gate == "data":
            edge = condprobe.data_edges().get(assembly)
            if not edge:
                continue
            fi_g, it_g, sens_g = _data_gated_group(
                *data, assembly=assembly, refine_steps=refine_steps, do_sens=do_sens,
                iterative=iterative, max_iter=max_iter, edge=edge, **kw)
        else:
            cond_amp = condprobe.probe(data[0], data[2], data[3], o, wm,
                                       dimension=dim, knowns=kn)
            route = ladder.choose(cond_amp, moments_ok=assembly == "moments")
            edge = None
            if (cond_amp is not None and refine_steps is None
                    and not (do_sens or iterative)
                    and not (route.path == "kernel" and condprobe.accuracy_ok_from(
                        cond_amp, assembly=route.assembly))):
                choice = condprobe.split_partition_choice(assembly=assembly)
                # perf heuristic on the sampled probe (soundness comes from
                # the per-case runtime key): engage when the
                # median-slack-scaled sample mostly certifies
                if choice is not None and float(
                        (cond_amp[0] * cond_amp[1] * ladder.EST_OVER_COND_MED
                         <= choice[1]).mean()) >= ladder.SPLIT_MIN_FRAC:
                    edge = choice[1]
            if edge is not None:
                fi_g, it_g, sens_g = _eager_split_group(*data, assembly=assembly,
                                                        edge=edge, **kw)
            elif route.path == "kernel":
                fi_g, it_g, sens_g = _run_kernel_group(
                    *data, assembly=route.assembly, refine_steps=refine_steps,
                    do_sens=do_sens, iterative=iterative, max_iter=max_iter, **kw)
            else:
                continue   # the engine takes it in the merged leftover call
        if whole:
            return _embed_kernel_result(fi_g, it_g, sens_g, fi_init, B, NO, dim, o)
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
    """Compute a static :class:`FitPlan` from concrete representative data.

    Runs the same probe + ladder decision as ``fit_many(backend="auto")``
    and captures the outcome, so ``fit_many(..., plan=plan)`` runs with no
    inspection of the data.  ``order``/``knowns``/``weighting`` must be
    scalars.  With K >= 1.5 NO and a kernel that covers the configuration
    ("moments" where the moment kernel's certified route does: dims 1-2,
    knowns and ``iterative`` included; else "rows": ``do_sens`` and 3D) the
    route is the cheapest certified rung:
    ``Route(path="kernel", kernel_precision="f64", assembly=...)``; for the
    basic algorithm, when the sample does not certify the batch,
    :func:`_maybe_split_route` may upgrade to a kernel certified on the
    batch's exact key maximum, or to ``path="kernel-split"``; else
    ``Route(path="xla", precision="f64")`` (the engine), which is also the
    route of ``iterative`` under :func:`config.iter_count_fidelity` (off by
    default here; ``fit_many``'s auto route honours it too).
    ``refine_steps`` pins the kernel's sweeps and disables the split.  On
    CPU tensors a kernel route runs the kernel's plain torch version.
    Geometry that autograd records plans the engine, with a warning: a
    kernel route would raise on replay under autograd.
    """
    scalars = tuple(_scalar(v) for v in (order, knowns, weighting))
    for name, s in zip(("order", "knowns", "weighting"), scalars):
        if s is None:
            raise ValueError(
                "plan_fit_many requires a scalar %s (homogeneous batch); "
                "heterogeneous batches must use eager fit_many bucketing" % name)
    _check_precision(precision)
    device = config.resolve_device(device, xk)
    xk, xi, B, K, dim = _canon_geometry(xk, xi, device)
    nk = (torch.full((B,), K, dtype=torch.int32, device=device) if nk is None
          else config.as_tensor(nk, device, torch.int32))
    o, kn, wm = scalars
    count_fidelity = iterative and config.iter_count_fidelity()
    assembly = (_assembly(dim, o, kn, wm, do_sens)
                if _kernel_shape_ok(K, dim, o) and not count_fidelity else None)
    if assembly is not None and config.wants_grad(xk, xi):
        _grad_to_engine("plan_fit_many")
        assembly = None
    if assembly is None:
        return FitPlan(route=ladder.Route(path="xla", precision=engine.PRECISION_F64))
    cond_amp = condprobe.probe(xk, nk, xi, o, wm, dimension=dim, knowns=kn)
    route = ladder.choose(cond_amp, moments_ok=assembly == "moments")
    if refine_steps is not None:
        if route.path == "kernel":
            route = dataclasses.replace(route, refine_steps=refine_steps)
    else:
        route = _maybe_split_route(
            route, xk, nk, xi, dim=dim, o=o, kn=kn, wm=wm, assembly=assembly,
            certified=route.path == "kernel" and condprobe.accuracy_ok_from(
                cond_amp, assembly=route.assembly),
            basic=not (do_sens or iterative))
    return FitPlan(route=route)


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
    the JAX package's ``prepare``: ``solver`` is ``"chol"``, ``"lu"`` or
    ``"chol_unrolled"`` (computed as ``"chol"``, :mod:`~wlsqm_tpu_torch.ops.solve`);
    every ``precision`` name of the JAX package computes in f64.  ``device``
    as for :func:`fit_many`.
    """
    solve_ops.check_solver(solver)
    _check_precision(precision)
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
    geometry-only array, expanded).  ``mixed_steps`` is the sweep dial of
    the JAX package's emulated precisions and must be None.
    """
    with profiling.span("api.checks"):
        _check_mixed_steps(mixed_steps)
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


# ---------------------------------------------------------------------------
# Streaming clouds that live in host memory
# ---------------------------------------------------------------------------

#: host threads that copy a chunk into, and its results out of, pinned memory
_COPY_THREADS = 8


def _fill(dst: np.ndarray, src, lo: int, hi: int, a: int, pool=None) -> None:
    """``dst`` <- rows [a, a + len(dst)) of ``src``'s chunk [lo, hi), the rows
    past ``hi`` filled with the chunk's first row (the reference's padding);
    with a ``pool``, copied by its threads."""
    m = max(0, min(len(dst), hi - a))
    if m < len(dst):
        dst[m:] = src[lo]
    if pool is None:
        dst[:m] = src[a:a + m]
        return
    step = max(1, -(-m // _COPY_THREADS))
    list(pool.map(lambda r: np.copyto(dst[r:min(r + step, m)], src[a + r:a + min(r + step, m)]),
                  range(0, m, step)))


def _padded(src, lo: int, hi: int, a: int, n: int) -> np.ndarray:
    """Rows [a, a + n) of ``src``'s chunk [lo, hi), padded as :func:`_fill` pads."""
    out = np.empty((n,) + src.shape[1:], src.dtype)
    _fill(out, src, lo, hi, a)
    return out


class _Lane:
    """One device's share of each chunk: on a card, two pinned staging
    slots for the inputs and two for the results, the inputs' device
    slots, an upload stream and a compute stream, and the events that keep
    a slot from being refilled while a copy still reads it."""

    def __init__(self, device, n, arrays, NO):
        self.device, self.n = device, n
        self.cuda = device.type == "cuda"
        self.pending = [None, None]
        if not self.cuda:
            return
        f64 = dict(dtype=torch.float64)
        self.host = [{k: torch.empty((n,) + a.shape[1:], dtype=dt, pin_memory=True)
                      for k, (a, dt) in arrays.items()} for _ in range(2)]
        self.dev = [{k: torch.empty((n,) + a.shape[1:], dtype=dt, device=device)
                     for k, (a, dt) in arrays.items()} for _ in range(2)]
        self.fi = [torch.empty((n, NO), pin_memory=True, **f64) for _ in range(2)]
        self.it = [torch.empty((n,), dtype=torch.int32, pin_memory=True) for _ in range(2)]
        self.up = torch.cuda.Stream(device)
        self.comp = torch.cuda.Stream(device)
        self.uploaded = [torch.cuda.Event() for _ in range(2)]
        self.consumed = [torch.cuda.Event() for _ in range(2)]
        self.fetched = [torch.cuda.Event() for _ in range(2)]

    def launch(self, c, arrays, lo, hi, a, fit, pool) -> None:
        """Chunk c's rows [a, a + n): stage, upload and fit (queued)."""
        slot = c % 2
        if not self.cuda:
            self.pending[slot] = fit({k: torch.from_numpy(_padded(src, lo, hi, a, self.n))
                                      for k, (src, _) in arrays.items()})
            return
        self.uploaded[slot].synchronize()      # the upload of chunk c - 2 read this slot
        for k, (src, _) in arrays.items():
            _fill(self.host[slot][k].numpy(), src, lo, hi, a, pool)
        with torch.cuda.device(self.device):
            with torch.cuda.stream(self.up):
                self.up.wait_event(self.consumed[slot])   # chunk c - 2's fit is done with it
                for k in arrays:
                    self.dev[slot][k].copy_(self.host[slot][k], non_blocking=True)
                self.uploaded[slot].record(self.up)
            with torch.cuda.stream(self.comp):
                self.comp.wait_event(self.uploaded[slot])
                res = fit(self.dev[slot])
                self.consumed[slot].record(self.comp)
                self.fi[slot].copy_(res.fi, non_blocking=True)
                self.it[slot].copy_(res.iterations, non_blocking=True)
                self.fetched[slot].record(self.comp)
        self.pending[slot] = res

    def drain(self, c, fi_out, iters_out, a, m, pool) -> None:
        """Write chunk c's first m results to rows [a, a + m) of the outputs."""
        slot = c % 2
        res, self.pending[slot] = self.pending[slot], None
        if not self.cuda:
            fi_out[a:a + m] = res.fi[:m].numpy()
            iters_out[a:a + m] = res.iterations[:m].numpy()
            return
        self.fetched[slot].synchronize()
        _fill(fi_out[a:a + m], self.fi[slot].numpy(), 0, m, 0, pool)
        iters_out[a:a + m] = self.it[slot].numpy()[:m]


def fit_stream(xk, fk, xi=None, *, nk=None, chunk: int = 65536, out=None, mesh=None,
               **kwargs) -> FitResult:
    """Fit a cloud that lives in host memory, streaming fixed-size chunks.

    Port of the JAX package's ``fit_stream`` (wlsqm_tpu/api.py:902-1022).
    Host arrays (NumPy, ``np.memmap`` included) are uploaded one chunk at a
    time and fitted with :func:`fit_many`; the DOFs land in a host array, so
    the cloud is bounded by host storage, not device memory.  On a card each
    device keeps two pinned staging slots: a chunk is copied into one and
    uploaded on a side stream while the previous chunk computes on the
    compute stream, with events between them, and its results come back
    into pinned memory and are written straight into ``out``.  The last
    partial chunk is padded by repeating its first row, as the reference
    does.  (The reference streams nothing: its OpenMP loop holds the whole
    problem set in RAM, wlsqm/fitter/simple.pyx:953ff.)

    xk (B, K, dim) | fk (B, K) | xi (B, dim) | nk (B,) — host array-likes.
    chunk: cases per step (default 65536).
    out: optional preallocated (B, NO) f64 array for the DOFs.
    mesh: optional list of devices (:func:`wlsqm_tpu_torch.parallel.sharding.make_mesh`;
        one device may repeat).  Each chunk, rounded up to a multiple of the
        device count, is split over them, each device streaming its share
        on its own streams (the JAX package's ``_fit_stream_sharded``).  With
        per-case ``order``/``knowns``/``weighting``/``fi_init`` arrays each
        share runs :func:`fit_many`'s eager routing on its own cases (the
        JAX package's ``_fit_stream_sharded_hetero`` decides a chunk's
        routes once for all shards; both certify every route).
    kwargs: forwarded to :func:`fit_many` (order, weighting, backend, gate,
        device, ...); per-case parameter arrays are sliced with the
        geometry.  ``do_sens``/``debug`` are refused (their outputs would not
        stream); call :func:`fit_many` on a chunk.

    With a scalar configuration and ``backend="auto"`` the route is planned
    once (:func:`plan_fit_many`) on the first ``min(B, chunk)`` cases and
    replayed on every chunk.  Returns a :class:`FitResult` of host NumPy
    arrays (``sens`` None).
    """
    if kwargs.get("do_sens") or kwargs.get("debug"):
        raise ValueError("fit_stream does not support do_sens/debug; "
                         "call fit_many on individual chunks instead")
    device = kwargs.pop("device", None)
    xk = np.asarray(xk)
    if xk.ndim == 2:
        xk = xk[:, :, None]
    B, K, dim = xk.shape
    fk = np.asarray(fk)
    xi_np = None if xi is None else np.asarray(xi)
    nk_np = None if nk is None else np.asarray(nk)
    per_case = {}
    for key in ("order", "knowns", "weighting", "fi_init"):
        v = kwargs.get(key)
        if v is not None and np.ndim(v) >= 1:
            per_case[key] = np.asarray(v)

    order = kwargs.get("order", 2)
    max_order = kwargs.get("max_order") or int(np.max(np.asarray(order)))
    NO = defs.number_of_dofs(dim, max_order)
    kwargs.setdefault("max_order", max_order)

    fi_out = out if out is not None else np.empty((B, NO), np.float64)
    if fi_out.shape != (B, NO):
        raise ValueError("out must have shape (%d, %d)" % (B, NO))
    iters_out = np.zeros((B,), np.int32)
    result = FitResult(fi=fi_out, sens=None, iterations=iters_out,
                       cond_scaled=np.full((B,), np.nan))
    if B == 0:
        return result

    from wlsqm_tpu_torch.parallel import sharding

    devs = (sharding.make_mesh(devices=mesh) if mesh is not None
            else [config.resolve_device(device)])
    if (kwargs.get("backend", "auto") == "auto" and "plan" not in kwargs
            and not per_case and (B >= chunk or mesh is not None)):
        # plan once, replay per chunk: the stream neither re-probes every chunk
        # nor flip-flops between routes; the probe needs representative
        # geometry only, so a mesh's plan looks at no more than 16,384 cases
        probe_n = min(B, chunk if mesh is None else min(chunk, 16384))
        kwargs["plan"] = plan_fit_many(
            xk[:probe_n], None if xi_np is None else xi_np[:probe_n],
            nk=None if nk_np is None else nk_np[:probe_n], order=order,
            knowns=kwargs.get("knowns", 0),
            weighting=kwargs.get("weighting", defs.WEIGHT_UNIFORM),
            iterative=bool(kwargs.get("iterative", False)),
            precision=kwargs.get("precision"), refine_steps=kwargs.get("refine_steps"),
            device=devs[0])

    D = len(devs)
    step = sharding.pad_cases(min(chunk, B), D)
    sub = step // D
    arrays = {"xk": (xk, torch.float64), "fk": (fk, torch.float64)}
    if xi_np is not None:
        arrays["xi"] = (xi_np, torch.float64)
    if nk_np is not None:
        arrays["nk"] = (nk_np, torch.int32)
    lanes = [_Lane(d, sub, arrays, NO) for d in devs]
    kw = {k: v for k, v in kwargs.items() if k not in per_case}

    def fitter(lo, hi, a, lane):
        def fit(t):
            cases = {k: _padded(v, lo, hi, a, sub) for k, v in per_case.items()}
            return fit_many(t["xk"], t["fk"], t.get("xi"), nk=t.get("nk"),
                            device=lane.device, **cases, **kw)
        return fit

    chunks = list(range(0, B, step))
    with concurrent.futures.ThreadPoolExecutor(_COPY_THREADS) as pool:
        for c, lo in enumerate(chunks + [None]):
            if lo is not None:
                hi = min(lo + step, B)
                for i, lane in enumerate(lanes):
                    a = lo + i * sub
                    lane.launch(c, arrays, lo, hi, a, fitter(lo, hi, a, lane), pool)
            if c:
                plo = chunks[c - 1]
                phi = min(plo + step, B)
                for i, lane in enumerate(lanes):
                    a = plo + i * sub
                    lane.drain(c - 1, fi_out, iters_out, a, max(0, min(sub, phi - a)), pool)
    return result
