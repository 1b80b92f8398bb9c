"""ExpertSolver: prepare-once / solve-many API with cached factorizations.

Port of :mod:`wlsqm_tpu.fitter.expert` (reference:
wlsqm/fitter/expert.pyx:66-781).  The reference caches per-case C buffers
(basis matrix, scaled and LU-factored normal matrix) inside a CaseManager
and reuses them across solves; here the prepared state is a
:class:`wlsqm_tpu_torch.fitter.engine.Prepared` of batched f64 tensors on
the device, made once by :meth:`ExpertSolver.prepare`.  That suits IBVP
explicit time stepping: geometry is prepared once, then each time step
solves with new data.

Every solve back-substitutes the prepared factor on the device: the JAX
package sends kernel-eligible batches through its fused TPU kernel instead
(recompute beats caching there), and the port does not, for two measured
reasons (``chip_smoke.phase_expert``, PERF.md): on the H100 the prepared
solve costs a few milliseconds of a NumPy solve that the host copies set
at ~150 ms (2^20 cases), so a kernel would win back little; and the
kernels' certificate needs the data's scale (ROADMAP C4), so on fields
whose DOFs are of the size of their values most cases would be solved a
second time by the engine.  The ``fit_*`` entries, which have no prepared
factor, do run the kernels (:mod:`wlsqm_tpu_torch.fitter.simple`).

Guest mode (``host=``) shares the host solver's prepared tensors instead of
recomputing them (reference: wlsqm/fitter/expert.pyx:110-124,161-189).

Global interpolation patches the local models into a piecewise global
surrogate (reference: wlsqm/fitter/expert.pyx:658-781): 'nearest'
evaluates each query with the Voronoi-nearest local model; 'continuous'
blends all models within radius ``r`` with weight ``(1 - sqrt(d²/r²))²``.
The searches run on a host k-d tree (:func:`wlsqm_tpu_torch.utils.neighbors.host_tree`),
the model evaluations on the device; ``device=True`` blends on the device
alone (:func:`wlsqm_tpu_torch.fitter.interp.interpolate_continuous`).
"""

from __future__ import annotations

import dataclasses
import operator

import numpy as np
import torch

from wlsqm_tpu_torch import api, config
from wlsqm_tpu_torch.fitter import defs, engine, tables
from wlsqm_tpu_torch.ops import solve as solve_ops

__all__ = ["ExpertSolver", "number_of_dofs"]

# re-export (reference: wlsqm/fitter/expert.pyx:57-63)
number_of_dofs = defs.number_of_dofs

def _eval_models_at_points(fi, active, xi, x, *, dimension, NO, diff):
    """Evaluate model m at point x[m], for m = 0..M-1 (one point per model).

    fi (M, NO) padded coefficients; ``active`` masks each case's own DOF
    count, so heterogeneous per-case orders evaluate correctly.
    """
    coeffs = torch.where(active, fi, 0.0)
    P = torch.as_tensor(tables.diff_projection(dimension, diff)[:NO, :NO],
                        dtype=fi.dtype, device=fi.device)
    coeffs = coeffs @ P.T
    c = engine.basis(x - xi, dimension, NO)         # (M, NO)
    return torch.sum(c * coeffs, dim=-1)


def _prepared_bytes(prep: engine.Prepared) -> int:
    """Bytes held by the tensors of a Prepared (the factor's included)."""
    total = 0
    for f in dataclasses.fields(prep):
        v = getattr(prep, f.name)
        for t in (v if isinstance(v, tuple) else (v,)):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


class ExpertSolver:
    """Advanced API with separate prepare and solve stages.

    Typical usage::

        s = ExpertSolver(dimension, nk, order, knowns, weighting_method, ...)
        s.prepare(xi, xk)     # build + precondition + factor (once)
        s.solve(fk, fi)       # many times, with different data fk

    Constructor arguments mirror the reference
    (reference: wlsqm/fitter/expert.pyx:92-157): per-case arrays ``nk``,
    ``order``, ``knowns``, ``weighting_method`` of shape (ncases,);
    ``algorithm`` one of ALGO_BASIC/ALGO_ITERATIVE; ``do_sens``; ``max_iter``;
    ``ntasks`` (accepted for compatibility — parallelism is the batch axis);
    ``debug`` (compute 2-norm condition numbers during prepare);
    ``host`` (guest mode: share another prepared solver's tensors).

    ``precision``: None (the default, "f64") or one of the JAX package's
    names ``"f64"``, ``"mixed"``, ``"fast"``, ``"ds"``.  Every name computes
    in f64 here; the name still picks the JAX package's defaults of
    ``scaling`` ("ruiz" for f64, "jacobi" otherwise) and ``solver`` ("chol"
    for f64 and "mixed", else "chol_unrolled", computed as "chol").

    ``device``: where the prepared state lives and every solve computes —
    the CUDA card unless ``device="cpu"``; :meth:`prepare` raises on a
    machine without a card (:func:`wlsqm_tpu_torch.config.resolve_device`).
    """

    def __init__(self, dimension, nk, order, knowns, weighting_method,
                 algorithm=defs.ALGO_BASIC, do_sens=False, max_iter=10,
                 ntasks=1, debug=False, host=None,
                 precision=None, scaling=None, solver=None, *, device=None):
        nk = np.asarray(nk, dtype=np.int32)
        order = np.asarray(order, dtype=np.int32)
        knowns = np.asarray(knowns, dtype=np.int64)
        weighting_method = np.asarray(weighting_method, dtype=np.int32)

        # Per-case arrays are the contract (reference:
        # wlsqm/fitter/expert.pyx:92-103); a scalar here is a usage error —
        # report it as one instead of an IndexError on .shape[0].
        for name, arr in (("nk", nk), ("order", order), ("knowns", knowns),
                          ("weighting_method", weighting_method)):
            if arr.ndim != 1:
                raise ValueError(
                    "%s must be a 1D per-case array of shape (ncases,); got "
                    "ndim=%d (broadcast scalars with e.g. np.full(ncases, v))"
                    % (name, arr.ndim))

        ncases = nk.shape[0]
        if (order.shape[0] != ncases or knowns.shape[0] != ncases
                or weighting_method.shape[0] != ncases):
            raise ValueError(
                "nk, order, knowns and weighting_method must have the same "
                "length; got len(nk)=%d, len(order)=%d, len(knowns)=%d, "
                "len(weighting_method)=%d"
                % (nk.shape[0], order.shape[0], knowns.shape[0],
                   weighting_method.shape[0]))
        if dimension not in (1, 2, 3):
            raise ValueError("Dimension must be 1, 2 or 3, got %s" % (dimension,))
        # algorithm is a scalar in the reference too (one `int` for the whole
        # solver, wlsqm/fitter/expert.pyx:93); a per-case array is a usage
        # error — report it as one instead of numpy's ambiguous-truth-value
        # error.  Size-1 arrays coerce like the reference's int() would.
        try:
            algorithm = operator.index(
                algorithm.item() if isinstance(algorithm, np.ndarray)
                and algorithm.size == 1 else algorithm)
        except TypeError:
            raise TypeError(
                "algorithm must be a single ALGO_* integer for the whole "
                "solver (the reference takes one int, not a per-case array); "
                "got %r" % (type(algorithm).__name__,)) from None
        if algorithm not in (defs.ALGO_BASIC, defs.ALGO_ITERATIVE):
            raise ValueError(
                "Unknown algorithm specifier %s; see wlsqm_tpu_torch.fitter.defs "
                "for valid specifiers ALGO_*" % (algorithm,))
        if ntasks is None or ntasks < 1:
            raise ValueError("ntasks must be >= 1, got %s" % (ntasks,))
        api._check_precision(precision)

        if host is not None:
            if not host.ready:
                raise RuntimeError(
                    "In guest mode, host must be in the ready state "
                    "(host.prepare() must have been called first).")
            if host.ncases != ncases:
                raise RuntimeError(
                    "In guest mode, number of cases must match; got %d, host "
                    "has %d" % (ncases, host.ncases))
            if host.dimension != dimension:
                raise ValueError(
                    "In guest mode, dimension must match; got %d, host has %d"
                    % (dimension, host.dimension))
            if bool(host.debug) != bool(debug):
                raise ValueError(
                    "In guest mode, debug flag must match; got %s, host has %s"
                    % (bool(debug), bool(host.debug)))
            for name, mine, theirs in (
                ("nk", nk, host.nk), ("order", order, host.order),
                ("knowns", knowns, host.knowns),
                ("weighting_method", weighting_method, host.weighting_method),
            ):
                if (np.asarray(theirs) != mine).any():
                    raise ValueError(
                        "In guest mode, '%s' must match element-by-element."
                        % name)

        self.host = host
        self.ready = False
        self.dimension = int(dimension)
        self.algorithm = int(algorithm)
        self.max_iter = int(max_iter)
        self.ncases = int(ncases)
        self.do_sens = bool(do_sens)
        self.ntasks = int(ntasks)
        self.debug = bool(debug)

        self.nk = nk
        self.order = order
        self.knowns = knowns
        self.weighting_method = weighting_method

        self.precision = engine.PRECISION_F64 if precision is None else precision
        if scaling is None:
            scaling = "ruiz" if self.precision == engine.PRECISION_F64 else "jacobi"
        if solver is None:
            solver = (solve_ops.SOLVER_CHOLESKY if self.precision in ("f64", "mixed")
                      else solve_ops.SOLVER_CHOLESKY_UNROLLED)
        solve_ops.check_solver(solver)
        self.scaling = scaling
        self.solver = solver
        self._device_arg = device

        self.NO = defs.number_of_dofs(self.dimension, int(order.max()))
        self.device: torch.device | None = None
        self.xk = None
        self.xi = None
        self.tree = None
        self.prepared: engine.Prepared | None = None
        self._geo = None          # (xk, nk, xi) on the device, uploaded once
        self._fi_internal = None  # last solved coefficients, (ncases, NO) tensor
        self._fi0_dev = None      # device zeros for knowns-free solves
        # active-DOF write-back mask (the reference's Case_get_fi copies the
        # active DOFs only; trailing inactive DOFs stay untouched)
        counts = np.asarray(defs._DOF_COUNTS[self.dimension])
        no_per = counts[np.clip(self.order, 0, defs.MAX_ORDER)]
        self._active_np = (np.arange(self.NO)[None, :] < no_per[:, None])

    # -- prepare -----------------------------------------------------------

    def prepare(self, xi, xk):
        """Build, precondition and factor the problem matrix for each case.

        (reference: wlsqm/fitter/expert.pyx:309-426)

        xi: (ncases, dim) fit origins ((ncases,) in 1D)
        xk: (ncases, max(nk), dim) neighbor coordinates ((ncases, max(nk)) in 1D)

        The geometry goes to the device once; the prepared path is the f64
        engine (Ruiz or Jacobi scaling, the chosen factorization).
        """
        self.ready = False

        if self.host is not None:
            # guest mode: borrow the host's prepared tensors outright
            h = self.host
            self.device, self.prepared, self._geo = h.device, h.prepared, h._geo
            self.xk, self.xi, self.tree = h.xk, h.xi, h.tree
            self.ready = True
            return

        device = config.resolve_device(self._device_arg)
        xi = np.asarray(xi, dtype=np.float64)
        xk = np.asarray(xk, dtype=np.float64)
        xi_b = xi.reshape(self.ncases, self.dimension)
        xk_b = xk.reshape(self.ncases, -1, self.dimension)

        self.device = device
        self.xi = xi
        self.xk = xk
        self.tree = None
        self._fi0_dev = None
        self._fi_internal = None
        self._geo = (config.as_tensor(xk_b, device),
                     torch.as_tensor(self.nk, device=device),
                     config.as_tensor(xi_b, device))

        def per_case(a):
            return torch.as_tensor(a, device=device)

        self.prepared = engine.prepare(
            self._geo[0], self._geo[1], self._geo[2], per_case(self.order),
            per_case(self.knowns), per_case(self.weighting_method),
            dimension=self.dimension, NO=self.NO, solver=self.solver,
            debug=self.debug, scaling=self.scaling)
        self.ready = True

    def conds(self, estimate=False):
        """Per-case 2-norm condition numbers of the scaled problem matrices.

        Requires ``debug=True`` and a prior :meth:`prepare`
        (reference: wlsqm/fitter/expert.pyx:429-464).

        ``estimate=True`` (extension): power-iteration estimates from the
        prepared factorizations instead — available without debug mode and
        without the O(n³) SVDs (:func:`wlsqm_tpu_torch.fitter.engine.cond_estimate`).
        """
        if not self.ready:
            raise RuntimeError(
                "Solver is not in the ready state; prepare() must be called "
                "before conds()")
        if estimate:
            return engine.cond_estimate(self.prepared).cpu().numpy()
        if not self.debug:
            raise RuntimeError(
                "Not in debug mode; condition number data has not been computed")
        return self.prepared.cond_scaled.cpu().numpy()

    def memory_used(self):
        """Bytes held by the prepared tensors, as (used, total).

        The reference reports its bump-allocator fill
        (reference: wlsqm/fitter/expert.pyx:289-306); here the analogous
        quantity is the footprint of the Prepared tensors on the device.
        """
        if self.prepared is None:
            return (0, 0)
        total = _prepared_bytes(self.prepared)
        return (total, total)

    # -- solve -------------------------------------------------------------

    def _require_ready(self, what):
        if not self.ready:
            raise RuntimeError(
                "Solver is not in the ready state; prepare() must be called "
                "before %s()" % what)

    def solve(self, fk, fi, sens=None):
        """Fit the model to data ``fk`` using the prepared geometry.

        (reference: wlsqm/fitter/expert.pyx:467-655)

        fk  : (ncases, max(nk)) function values at the neighbor points — a
              NumPy array, or a tensor (a tensor on the solver's device is
              used without a copy)
        fi  : (ncases, NO) in/out NumPy — knowns in, unknowns filled in
              place (use :meth:`solve_device` for device-resident output)
        sens: (ncases, max(nk), NO) out if ``do_sens`` was set

        Returns the maximum number of refinement iterations taken (0 for
        ALGO_BASIC).  Every output is computed before any is written, and
        comes back in one transfer; only each case's active DOFs are written
        to ``fi``.
        """
        self._require_ready("solve")
        if self.do_sens and sens is None:
            raise ValueError("do_sens solver requires a sens output array")
        fk_t = config.as_tensor(fk, self.device)
        K = int(fk_t.shape[1])
        fi_np = np.asarray(fi)
        if int(self.knowns.max()) or self.algorithm == defs.ALGO_ITERATIVE:
            fi_in = config.as_tensor(np.array(fi_np[:, :self.NO], dtype=np.float64),
                                     self.device)
        else:
            if self._fi0_dev is None:
                self._fi0_dev = torch.zeros((self.ncases, self.NO), dtype=config.DTYPE,
                                            device=self.device)
            fi_in = self._fi0_dev

        if self.algorithm == defs.ALGO_ITERATIVE:
            fi_out, sens_out, iters = engine.solve_iterative_prepared(
                self.prepared, fk_t, fi_in, self.max_iter, self.do_sens)
        else:
            fi_out, sens_out = engine.solve_prepared(self.prepared, fk_t, fi_in,
                                                     self.do_sens)
            iters = None

        self._fi_internal = fi_out
        host = [t.cpu() for t in (fi_out, iters, sens_out) if t is not None]
        fi_h = host.pop(0).numpy()
        max_iters = int(host.pop(0).numpy().max(initial=0)) if iters is not None else 0
        np.copyto(fi_np[:, :self.NO], fi_h, where=self._active_np)
        if self.do_sens:
            sens[:, :K, :self.NO] = host.pop(0).numpy()
        return max_iters

    def solve_device(self, fk, fi_init=None):
        """Device-resident solve: tensors in, tensors out, no host sync.

        The extension :meth:`solve` cannot offer under the reference's
        in-place NumPy contract: nothing crosses the host boundary, so
        back-to-back calls (an IBVP time loop, a multi-field sweep) queue on
        the device.  Runs the prepared path (:func:`wlsqm_tpu_torch.api.solve`).

        fk: (ncases, max_nk) for one field, or (F, ncases, max_nk) to solve F
        fields against the same factorizations in one call.
        fi_init: optional (…, ncases, NO) knowns/seed values.

        Returns ``(fi, sens, iterations)``; ``sens`` is None unless
        ``do_sens``; ``iterations`` is zeros for ALGO_BASIC.
        """
        self._require_ready("solve_device")
        out = api.solve(self.prepared, fk, fi_init, do_sens=self.do_sens,
                        iterative=self.algorithm == defs.ALGO_ITERATIVE,
                        max_iter=self.max_iter)
        if len(out) == 2:
            fi_out, sens_out = out
            iters = torch.zeros(fi_out.shape[:-1], dtype=torch.int32,
                                device=fi_out.device)
        else:
            fi_out, sens_out, iters = out
        self._fi_internal = fi_out[0] if fi_out.ndim == 3 else fi_out
        return fi_out, sens_out, iters

    def solve_stream(self, fk_iter, fi_init=None):
        """Pipelined repeated solves: one solve kept in flight.

        Generator over an iterable of ``fk`` arrays (time steps, field
        sweeps).  Step i+1 is queued on the device before step i's results
        are handed out: each step's DOFs and its largest count are copied
        into pinned host buffers with ``non_blocking=True`` and a CUDA event
        is recorded after them, so the copy of step i overlaps the compute of
        step i+1 and only step i's event is waited on.

        fk_iter: iterable of (ncases, max_nk) NumPy arrays or tensors.
        fi_init: optional (ncases, NO) knowns/seed, reused every step.

        Yields ``(fi, max_iters)`` per step — ``fi`` a fresh host
        (ncases, NO) float64 array, ``max_iters`` an int (0 for
        ALGO_BASIC), matching :meth:`solve`'s return convention.
        """
        # validate eagerly (a generator body would defer these errors to the
        # first next(), far from the faulty call site)
        self._require_ready("solve_stream")
        if self.do_sens:
            raise ValueError(
                "solve_stream does not support do_sens (the sensitivity "
                "tensor would dominate the transfer); use solve()")
        return self._solve_stream_inner(fk_iter, fi_init)

    def _solve_stream_inner(self, fk_iter, fi_init):
        cuda = self.device.type == "cuda"

        def launch(fk):
            fi_d, _, it_d = self.solve_device(fk, fi_init)
            it_max = it_d.max() if it_d.numel() else it_d.new_zeros(())
            if not cuda:
                return fi_d.clone(), it_max, None
            fi_h = torch.empty(fi_d.shape, dtype=fi_d.dtype, pin_memory=True)
            it_h = torch.empty((), dtype=it_max.dtype, pin_memory=True)
            fi_h.copy_(fi_d, non_blocking=True)
            it_h.copy_(it_max, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return fi_h, it_h, done

        def finish(pending):
            fi_h, it_h, done = pending
            if done is not None:
                done.synchronize()
            return fi_h.numpy(), int(it_h)

        pending = None
        for fk in fk_iter:
            nxt = launch(fk)
            if pending is not None:
                yield finish(pending)
            pending = nxt
        if pending is not None:
            yield finish(pending)

    # -- global interpolation ---------------------------------------------

    def prep_interpolate(self):
        """Index the xi points for fast nearest/radius lookups.

        (reference: wlsqm/fitter/expert.pyx:658-681)
        """
        self._require_ready("prep_interpolate")
        if self.host is not None:
            self.tree = self.host.tree
        else:
            from wlsqm_tpu_torch.utils.neighbors import host_tree

            self.tree = host_tree(np.asarray(self.xi).reshape(self.ncases, self.dimension))

    def interpolate(self, x, mode="nearest", r=None, diff=0, I=None,
                    device=False):
        """Interpolate the patched global model (or a derivative) at ``x``.

        (reference: wlsqm/fitter/expert.pyx:687-781)

        mode='nearest':   Voronoi-piecewise — each query uses the local model
                          whose origin is nearest (jumps across cell borders).
        mode='continuous': weighted average of all local models with origin
                          within radius ``r``; weight (1 - sqrt(d²/r²))²
                          falls to zero at r, giving a continuous patching.
        I: optional per-query model indices to skip the nearest-model search.
        device=True (extension, mode='continuous', homogeneous order): run
        the blending on the device alone — no host k-d tree, no
        prep_interpolate needed
        (:func:`wlsqm_tpu_torch.fitter.interp.interpolate_continuous`).

        Returns (out, I_out) as NumPy arrays; I_out is None in 'continuous'
        mode.
        """
        if mode not in ("nearest", "continuous"):
            raise ValueError(
                "mode must be one of 'nearest', 'continuous'; got '%s'" % (mode,))
        if mode == "continuous" and r is None:
            raise ValueError("r must be specified in mode='continuous'")
        if diff is None:
            raise ValueError("diff cannot be None")
        dim = self.dimension
        if device and mode == "continuous":
            if self._fi_internal is None:
                raise RuntimeError("solve() must be called before interpolate()")
            if self.order.min() != self.order.max():
                raise ValueError("device=True requires a homogeneous per-case order")
            from wlsqm_tpu_torch.fitter.interp import interpolate_continuous

            xq = np.asarray(x, dtype=np.float64).reshape(-1, dim)
            num, den = interpolate_continuous(
                self._fi_internal, self._geo[2], xq, r, dimension=dim,
                order=int(self.order[0]), diff=int(diff), device=self.device)
            with np.errstate(invalid="ignore", divide="ignore"):
                out = num.cpu().numpy() / den.cpu().numpy()
            return (out, None)
        if self.tree is None:
            raise RuntimeError(
                "Points xi have not been indexed; prep_interpolate() must be "
                "called before interpolate()")
        if self._fi_internal is None:
            raise RuntimeError("solve() must be called before interpolate()")
        if I is not None and len(I) != len(x):
            raise ValueError(
                "When 'I' is specified, 'I' must have the same length as x; "
                "got len(I) = %d, len(x) = %d." % (len(I), len(x)))

        xq = np.asarray(x, dtype=np.float64).reshape(-1, dim)
        nx = xq.shape[0]
        xi_np = np.asarray(self.xi).reshape(self.ncases, dim)

        def evaluate(models, points):
            idx = torch.as_tensor(models, device=self.device)
            return _eval_models_at_points(
                self._fi_internal[idx], self.prepared.active[idx], self._geo[2][idx],
                config.as_tensor(points, self.device), dimension=dim, NO=self.NO,
                diff=int(diff)).cpu().numpy()

        if mode == "nearest":
            if I is None:
                _, idx = self.tree.query(xq, k=1)
                idx = np.asarray(idx, dtype=np.int64)
            else:
                idx = np.asarray(I, dtype=np.int64)
            return (evaluate(idx, xq), idx)

        # continuous mode: radius query on the host tree, batched eval on the device
        neighbor_lists = self.tree.query_ball_point(xq, r)
        pair_q = np.concatenate(
            [np.full(len(lst), m, dtype=np.int64)
             for m, lst in enumerate(neighbor_lists)]
        ) if nx else np.zeros(0, np.int64)
        pair_m = np.concatenate(
            [np.asarray(lst, dtype=np.int64) for lst in neighbor_lists]
        ) if nx else np.zeros(0, np.int64)

        out = np.zeros(nx, dtype=np.float64)
        if pair_q.size:
            vals = evaluate(pair_m, xq[pair_q])
            d2 = ((xq[pair_q] - xi_np[pair_m]) ** 2).sum(axis=-1)
            # alpha = 0 variant of the center weight; falls to 0 at r
            # (reference: wlsqm/fitter/expert.pyx:40-46,978-980)
            tmp = 1.0 - np.sqrt(d2 / (r * r))
            wgt = tmp * tmp
            num = np.zeros(nx)
            den = np.zeros(nx)
            np.add.at(num, pair_q, wgt * vals)
            np.add.at(den, pair_q, wgt)
            with np.errstate(invalid="ignore", divide="ignore"):
                out = num / den
        return (out, None)
