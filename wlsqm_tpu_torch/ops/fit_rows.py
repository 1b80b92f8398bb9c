"""The rows-body fit kernel: host wrapper, plain version, tables.

Port of the rows body of the fused TPU kernel
(``wlsqm_tpu/ops/pallas_fit.py``: ``_make_kernel`` l.901, launched by
``fit_pallas`` l.1316 at l.1502).  Per case, with the offsets prescaled by
an exact power of two and PLAIN monomial basis rows c_kj (the factorials
go into the f64 de-scale, as in ``_basis_cols`` l.174):

* weights, UNIFORM or CENTER (normalised by the exact max d²);
* known DOFs eliminated: ``fkeff = fk - sum_known ĝ_j c_kj``, and identity
  rows and columns with a zero RHS in A = CᵀWC (l.1004-1038);
* Jacobi scaling, Cholesky with the pivot guard max(acc, 1e-30), one direct
  solve and ``refine_steps`` residual sweeps through the rows (l.1040-1136);
* ALGO_ITERATIVE when ``max_iter > 0``: corrective refits with the
  reference's exact l∞ stagnation rule and per-case counts; a known DOF is
  never updated (l.1144-1238);
* sensitivities when ``do_sens``: one solve and its sweeps per neighbour,
  from the initial factor only (l.1249-1307).

The TPU computes in f32 pairs because it has no f64; the H100 has FP64, so
both versions here compute in float64:

* :func:`fit_rows_plain` — batched torch, what the CPU runs and what the
  CUDA kernel is checked against;
* the CUDA kernel ``csrc/fit_rows.cu`` — dims 1-3, orders 0-4
  (:func:`supported`), one library of 30 instances, each compiled as one of
  two bodies by a rule on NO (:func:`warp_body`): one thread per case for
  the small systems, one warp per case with its state in shared memory and
  the normal equations on the FP64 tensor cores for NO >= WARP_MIN_NO.  Its
  tables come from :func:`tables_header`, generated from the same
  ``tables.EXPONENTS`` rows that :func:`basis_rows` reads.

:func:`fit_rows` is the host contract of ``fit_pallas`` for the rows body;
:func:`fit_rows_diffable` is ``fit_pallas_diffable`` (gradient in fk from
the sensitivities).  :data:`LAUNCHES` counts kernel launches.

With ``emit_cond=True`` both versions also return, last, the per-case
conditioning key of the scaled matrix with its identity rows for the known
DOFs (``_cond_estimate``, pallas_fit.py l.382, written at l.1067-1068), for
the basic fit, with ``do_sens`` and with ``max_iter`` alike; see
:mod:`wlsqm_tpu_torch.ops.fit_kernel`.  The kernel with the key is a second
library of the same source; :data:`COND_LAUNCHES` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from wlsqm_tpu_torch import config, native
from wlsqm_tpu_torch.fitter import defs, engine, tables
from wlsqm_tpu_torch.ops import fit_kernel
from wlsqm_tpu_torch.utils import profiling

__all__ = ["fit_rows", "fit_rows_plain", "fit_rows_diffable", "basis_rows",
           "supported", "LAUNCHES", "COND_LAUNCHES"]

#: residual sweeps after each direct f64 solve (DOFs and sensitivities)
DEFAULT_REFINE_STEPS = fit_kernel.DEFAULT_REFINE_STEPS

#: number of CUDA kernel launches made by :func:`fit_rows`
LAUNCHES = 0

#: of those, the launches that also wrote the conditioning key
COND_LAUNCHES = 0

_SRC = os.path.join(native.CSRC, "fit_rows.cu")
_INCLUDES = (os.path.join(native.CSRC, "warp_chol.cuh"),)
_HEADER = "fit_rows_tables.cuh"
_ENTRY = "wlsqm_fit_rows"


# ---------------------------------------------------------------------------
# Tables (shared by the plain version and the generated CUDA header)
# ---------------------------------------------------------------------------

def basis_rows(d, dimension: int, order: int):
    """(..., NO) plain-monomial basis rows of prescaled offsets d (..., dim).

    Same power ladder and product order as ``pallas_fit._basis_cols``
    (d², d³ = d²·d, d⁴ = d²·d², then the axes in order), and as the CUDA
    kernel; the 1/m! factors are left to the f64 de-scale.
    """
    NO = defs.number_of_dofs(dimension, order)
    ladders = []
    for a in range(dimension):
        x = d[..., a]
        lad = [None, x]
        if order >= 2:
            x2 = x * x
            lad += [x2, x2 * x, x2 * x2][:order - 1]
        ladders.append(lad)
    cols = []
    for row in tables.EXPONENTS[dimension][:NO]:
        val = None
        for a in range(dimension):
            e = int(row[a])
            if e:
                val = ladders[a][e] if val is None else val * ladders[a][e]
        cols.append(torch.ones_like(d[..., 0]) if val is None else val)
    return torch.stack(cols, dim=-1)


known_dofs = fit_kernel.known_dofs


#: the rows kernel runs its warp body for NO >= WARP_MIN_NO, its thread
#: body below (the cut measured on the H100: PERF.md, PR 5)
WARP_MIN_NO = 11

#: neighbours per chunk of the warp body (one per lane) and the row stride
#: of its right-hand-side buffers (csrc/fit_rows.cu: kKC, kLDX)
_KC, _LDX = 32, 36


def warp_body(dimension: int, order: int) -> bool:
    """Whether the kernel instance of (dimension, order) is the warp body:
    a compile-time rule on NO, written into the generated header."""
    return defs.number_of_dofs(dimension, order) >= WARP_MIN_NO


def warp_smem_bytes(dimension: int, order: int, do_sens: bool = False,
                    emit_cond: bool = False) -> int:
    """Dynamic shared memory of one warp-body case, in bytes; independent of
    K (neighbours are taken 32 at a time).  The layout of
    ``csrc/fit_rows.cu:WarpLayout``, which checks it at compile time:
    basis rows (32, NP + 4) with NP = NO + 1 (the column of fkeff) rounded
    up to the 8 x 8 tile, four per-neighbour vectors, the packed matrix,
    eight DOF vectors, and the right-hand-side buffers (NP, 36): one for the
    key, three and a (32, 36) product for the sensitivities."""
    NO = defs.number_of_dofs(dimension, order)
    NP = (NO // 8 + 1) * 8
    base = _KC * (NP + 4) + 4 * _KC + (NO * (NO + 1) // 2 + 1) // 2 * 2 + 8 * NP
    if do_sens:
        base += 3 * NP * _LDX + _KC * _LDX
    elif emit_cond:
        base += NP * _LDX
    return 8 * base


def tables_header() -> str:
    """C++ header with the kernel's tables, one struct per (dim, order).

    ``RowsTables<DIM, ORDER>`` holds NO and ``ex(j, a)``, the exponent of
    axis a in DOF j (``tables.EXPONENTS``), as a constexpr switch: in the
    kernel's unrolled basis loop every argument is a compile-time constant,
    so each lookup folds away.  ``kWarp`` is :func:`warp_body`, and
    ``kSmemBase``, ``kSmemKey`` and ``kSmemSens`` are
    :func:`warp_smem_bytes` without sens or key, with the key, with sens.
    """
    out = ["// Generated by wlsqm_tpu_torch.ops.fit_rows.tables_header() from",
           "// tables.EXPONENTS; the build writes it, do not edit.",
           "#pragma once",
           "",
           "template <int DIM, int ORDER> struct RowsTables;",
           ""]
    for dim in (1, 2, 3):
        for order in range(defs.MAX_ORDER + 1):
            NO = defs.number_of_dofs(dim, order)
            exp = tables.EXPONENTS[dim][:NO]
            cases = " ".join("case %d: return %d;" % (j * dim + a, int(exp[j, a]))
                             for j in range(NO) for a in range(dim) if exp[j, a])
            out += ["template <> struct RowsTables<%d, %d> {" % (dim, order),
                    "  static constexpr int NO = %d;" % NO,
                    "  static constexpr bool kWarp = %s;" % str(warp_body(dim, order)).lower(),
                    "  static constexpr int kSmemBase = %d, kSmemKey = %d, kSmemSens = %d;" % (
                        warp_smem_bytes(dim, order), warp_smem_bytes(dim, order, emit_cond=True),
                        warp_smem_bytes(dim, order, do_sens=True)),
                    "  __host__ __device__ static constexpr int ex(int j, int a) {",
                    "    switch (j * %d + a) { %s default: return 0; }" % (dim, cases),
                    "  }",
                    "};",
                    ""]
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Shared host contract: scaled knowns in, de-scale and restore out
# ---------------------------------------------------------------------------

_scaled_knowns = fit_kernel._scaled_knowns


def _finish(y, iters, sens, fi_init, dscale, KN, key=None):
    """De-scale the kernel's outputs into the reference's DOF convention.

    fi = y · fact · 2^(-e_s·deg); known fi restored bit-exactly from
    ``fi_init`` (pallas_fit.py l.1524-1529); sens de-scaled in place per DOF
    column, NaN in the known columns (l.1536-1541).  Returns (fi, iters,
    sens) with zero counts when the basic algorithm ran, and the
    conditioning ``key`` after them when it is given.
    """
    with profiling.span("fit_rows.finish", y.device):
        fi = fit_kernel._restore_knowns(y * dscale, fi_init, KN)
        if sens is not None:
            sens.mul_(dscale[:, None, :])
            if KN:
                sens[:, :, KN] = torch.nan
    if iters is None:
        iters = torch.zeros(y.shape[0], dtype=torch.int32, device=y.device)
    if key is not None:
        return fi, iters, sens, key
    return fi, iters, sens


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _chol_solve_cols(L, R):
    """(L Lᵀ)⁻¹ R for R (B, NO, m)."""
    Y = torch.linalg.solve_triangular(L, R, upper=False)
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)


def _solve_rows(d, fk, kmask, ghat, *, dimension, order, weighting, KN,
                refine_steps, do_sens, max_iter, emit_cond=False):
    """The kernel body on prescaled offsets ``d`` (B, K, dim) and data
    ``fk`` (B, K), both zero on padded slots.  Returns the scaled solution
    x̂ (B, NO) (ĝ on known DOFs), the counts or None, the scaled
    sensitivities (B, K, NO) or None, and the conditioning key before the
    radius amplification or None."""
    NO = defs.number_of_dofs(dimension, order)
    c = basis_rows(d, dimension, order)                                # (B, K, NO)
    w = engine.neighbor_weights(torch.sum(d * d, dim=-1), kmask,
                                torch.tensor(weighting, device=d.device))
    cw = c * w[..., None]
    unknown = torch.ones(NO, dtype=torch.bool, device=d.device)
    unknown[KN] = False

    fkeff = fk
    if KN:
        fkeff = fk - (c[..., KN] * ghat[:, None, KN]).sum(-1)
    A = cw.mT @ c                                                      # (B, NO, NO)
    b = (cw.mT @ fkeff[..., None])[..., 0]
    if KN:
        A[:, KN, :] = 0.0
        A[:, :, KN] = 0.0
        A[:, KN, KN] = 1.0
        b[:, KN] = 0.0
    djj = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.where(djj > 0, 1.0 / torch.sqrt(torch.where(djj > 0, djj, 1.0)), 1.0)
    As = A * (s[:, :, None] * s[:, None, :])
    L = fit_kernel._cholesky_guarded(As)
    key = fit_kernel.cond_key_from_factor(As, L) if emit_cond else None
    sc = s[..., None]

    def solve(rhs):
        """Direct solve of the scaled system, then sweeps through the rows:
        y += solve(rhs - s (Cᵀ W C) (s y)), known rows held at 0."""
        y = _chol_solve_cols(L, rhs)
        for _ in range(refine_steps):
            r = rhs - sc * (cw.mT @ (c @ (sc * y)))
            r = torch.where(unknown[:, None], r, 0.0)
            y = y + _chol_solve_cols(L, r)
        return y

    xh = torch.where(unknown, solve((b * s)[..., None])[..., 0] * s, ghat)

    iters = None
    if max_iter:
        B = d.shape[0]
        done = torch.zeros(B, dtype=torch.bool, device=d.device)
        prev = torch.full((B,), -1.0, dtype=d.dtype, device=d.device)
        iters = torch.zeros(B, dtype=torch.int32, device=d.device)
        for _ in range(max_iter):
            r = torch.where(kmask, fk - (c @ xh[..., None])[..., 0], 0.0)
            nrm = r.abs().amax(dim=-1)
            done = done | (nrm == prev)
            rhs = torch.where(unknown, (cw.mT @ r[..., None])[..., 0] * s, 0.0)
            dy = _chol_solve_cols(L, rhs[..., None])[..., 0]
            upd = ~done
            xh = torch.where(upd[:, None] & unknown, xh + dy * s, xh)
            iters += upd.to(torch.int32)
            prev = nrm

    sens = None
    if do_sens:
        rhs = torch.where(unknown[:, None], cw.mT * sc, 0.0)          # (B, NO, K)
        sens = (solve(rhs) * sc).mT.contiguous()                       # (B, K, NO)
    return xh, iters, sens, key


def fit_rows_plain(xk, fk, nk, xi, fi_init=None, *, dimension: int, order: int,
                   weighting: int, knowns: int = 0,
                   refine_steps: int = DEFAULT_REFINE_STEPS, do_sens: bool = False,
                   max_iter: int = 0, emit_cond: bool = False):
    """The kernel's computation in batched torch f64, for any dimension 1-3
    and order 0-4; same arguments and results as :func:`fit_rows`.

    Memory is O(B·K·NO), and O(B·K²) for the sensitivities' sweeps.
    """
    KN = known_dofs(knowns, dimension, order)
    with profiling.span("fit_rows.prescale", xk.device):
        delta, kmask, e_s, inv_s = fit_kernel._prescale(xk, nk, xi)
        dscale = fit_kernel._dof_scale(e_s, dimension, order)
        ghat = _scaled_knowns(fi_init, dscale, KN)
    y, iters, sens, key = _solve_rows(
        delta * inv_s[:, None, None], torch.where(kmask, fk, 0.0), kmask, ghat,
        dimension=dimension, order=order, weighting=weighting, KN=KN,
        refine_steps=refine_steps, do_sens=do_sens, max_iter=max_iter,
        emit_cond=emit_cond)
    if emit_cond:
        key = key * fit_kernel.cond_amp_factor(inv_s, order)
    return _finish(y, iters, sens, fi_init, dscale, KN, key)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def supported(dimension: int, order, knowns, weighting) -> bool:
    """Whether the CUDA kernel covers this configuration.

    Homogeneous batches only (one order, one knowns mask, one weighting),
    dimensions 1-3, orders 0-4, WEIGHT_UNIFORM or WEIGHT_CENTER, with or
    without sensitivities and ALGO_ITERATIVE.  Neither body keeps anything
    sized by K (the warp body takes neighbours 32 at a time), so K is not
    limited.
    """
    order = np.asarray(order)
    knowns = np.asarray(knowns)
    weighting = np.asarray(weighting)
    return bool(
        dimension in (1, 2, 3)
        and order.min() == order.max()
        and 0 <= int(order.max()) <= defs.MAX_ORDER
        and knowns.min() == knowns.max()
        and weighting.min() == weighting.max()
        and int(weighting.max()) in (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER))


@functools.cache
def load(emit_cond: bool = False) -> native.Library:
    """The kernel's shared library, built with nvcc on first use; with
    ``emit_cond`` the library whose instances also write the key."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return native.build(
        "fit_rows_cond" if emit_cond else "fit_rows", [_SRC],
        {_HEADER: tables_header()},
        {_ENTRY: (i32, [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32,
                        i32, i32, i64, i32, i32, vp]),
         "wlsqm_rows_thread_layout": (i32, [i32, i32, vp])},
        defines=("WLSQM_EMIT_COND=%d" % emit_cond,), includes=_INCLUDES)


def _launch(xk, fk, nk, xi, inv_s, ghat, out, iters, sens, est=None, *, order: int,
            weighting: int, knowns: int, refine_steps: int, max_iter: int) -> None:
    """Launch the kernel on the current stream.

    Writes the scaled solution into ``out`` (B, NO), the counts into
    ``iters`` (B,) when ``max_iter > 0``, the scaled sensitivities into
    ``sens`` (B, K, NO) when it is given, and the key before the radius
    amplification into ``est`` (B,) when it is given.  ``ghat`` (B, NO) holds the scaled
    known values and is given exactly when the knowns mask marks a DOF below
    NO.  Checks device, dtype, shape and contiguity, and raises on a refused
    launch (the C entry returns ``cudaGetLastError()``).  Does not
    synchronise.
    """
    global LAUNCHES, COND_LAUNCHES
    B, K, dim = xk.shape
    NO = defs.number_of_dofs(dim, order)
    has_known = bool(known_dofs(knowns, dim, order))
    expect = [(xk, (B, K, dim), torch.float64), (fk, (B, K), torch.float64),
              (nk, (B,), torch.int32), (xi, (B, dim), torch.float64),
              (inv_s, (B,), torch.float64), (out, (B, NO), torch.float64)]
    for t, shape, dtype, want in ((ghat, (B, NO), torch.float64, has_known),
                                  (iters, (B,), torch.int32, max_iter > 0),
                                  (sens, (B, K, NO), torch.float64, sens is not None),
                                  (est, (B,), torch.float64, est is not None)):
        if (t is not None) != want:
            raise ValueError("fit_rows kernel: an optional tensor of shape %s is %s"
                             % (shape, "missing" if want else "not expected"))
        if t is not None:
            expect.append((t, shape, dtype))
    for t, shape, dtype in expect:
        if (t.device != xk.device or t.device.type != "cuda"
                or tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(
                "fit_rows kernel wants contiguous %s %s on one CUDA device; got "
                "%s %s on %s (xk on %s)"
                % (dtype, shape, t.dtype, tuple(t.shape), t.device, xk.device))
    if (not supported(dim, order, knowns, weighting) or refine_steps < 0
            or max_iter < 0):
        raise ValueError("fit_rows kernel does not cover dim=%d order=%d "
                         "weighting=%d refine_steps=%d max_iter=%d"
                         % (dim, order, weighting, refine_steps, max_iter))
    if B == 0:
        return

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = load(est is not None).lib
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream(xk.device).cuda_stream
        status = getattr(lib, _ENTRY)(
            xk.data_ptr(), fk.data_ptr(), nk.data_ptr(), xi.data_ptr(),
            inv_s.data_ptr(), ptr(ghat), out.data_ptr(), ptr(iters), ptr(sens),
            ptr(est), B, K, dim, order, weighting, int(knowns), refine_steps,
            max_iter, stream)
    if status != 0:
        raise RuntimeError("fit_rows kernel launch failed: CUDA error %d" % status)
    LAUNCHES += 1
    COND_LAUNCHES += est is not None


def fit_rows(xk, fk, nk, xi, fi_init=None, *, dimension: int, order: int,
             weighting: int, knowns: int = 0,
             refine_steps: int = DEFAULT_REFINE_STEPS, do_sens: bool = False,
             max_iter: int = 0, emit_cond: bool = False):
    """Fit a homogeneous batch with the rows-body kernel.

    xk (B, K, dim) f64 | fk (B, K) f64 | nk (B,) int | xi (B, dim) f64 |
    fi_init (B, >=NO) f64 or None (the known values), all on one device.
    Returns (fi (B, NO), iters (B,) int32, sens (B, K, NO) or None): counts
    are 0 unless ``max_iter > 0`` (ALGO_ITERATIVE); sens is
    d fi / d fk when ``do_sens``, NaN on known DOFs.  With ``emit_cond`` the
    conditioning key (B,) f64 comes last, and the rest is the same bits as
    without it.  A CPU tensor runs
    :func:`fit_rows_plain`; a CUDA tensor launches the kernel (see
    :func:`supported` for what it covers) or raises.
    """
    if xk.device.type == "cpu":
        return fit_rows_plain(xk, fk, nk, xi, fi_init, dimension=dimension,
                              order=order, weighting=weighting, knowns=knowns,
                              refine_steps=refine_steps, do_sens=do_sens,
                              max_iter=max_iter, emit_cond=emit_cond)
    config.refuse_grad("fit_rows", "use fit_rows_diffable (gradients in fk) or the "
                       "f64 engine (wlsqm_tpu_torch.fitter.engine.fit_batch)",
                       xk, fk, xi, fi_init)
    if xk.shape[-1] != dimension:
        raise ValueError("xk has dimension %d, not %d" % (xk.shape[-1], dimension))
    B, K, _ = xk.shape
    NO = defs.number_of_dofs(dimension, order)
    nk = nk.to(torch.int32).contiguous()
    KN = known_dofs(knowns, dimension, order)
    with profiling.span("fit_rows.prescale", xk.device):
        _, _, e_s, inv_s = fit_kernel._prescale(xk, nk, xi)
        dscale = fit_kernel._dof_scale(e_s, dimension, order)
        ghat = _scaled_knowns(fi_init, dscale, KN) if KN else None
    f64 = dict(dtype=torch.float64, device=xk.device)
    out = torch.empty((B, NO), **f64)
    iters = (torch.empty((B,), dtype=torch.int32, device=xk.device) if max_iter > 0
             else None)
    sens = torch.empty((B, K, NO), **f64) if do_sens else None
    est = torch.empty((B,), **f64) if emit_cond else None
    _launch(xk.contiguous(), fk.contiguous(), nk, xi.contiguous(), inv_s, ghat,
            out, iters, sens, est, order=order, weighting=weighting, knowns=knowns,
            refine_steps=refine_steps, max_iter=max_iter)
    if emit_cond:
        est = est * fit_kernel.cond_amp_factor(inv_s, order)
    return _finish(out, iters, sens, fi_init, dscale, KN, est)


# ---------------------------------------------------------------------------
# Reverse-mode differentiable wrapper
# ---------------------------------------------------------------------------

class _FitRowsLinear(torch.autograd.Function):
    """The basic fit is linear in fk, and its Jacobian d fi / d fk is the
    sensitivity array: the backward pass is one contraction with it
    (pallas_fit.py l.1606-1618)."""

    @staticmethod
    def forward(ctx, fk, xk, nk, xi, fi_init, kw):
        fi, _, sens = fit_rows(xk, fk, nk, xi, fi_init, do_sens=True, **kw)
        ctx.save_for_backward(sens)
        return fi

    @staticmethod
    def backward(ctx, g):
        (sens,) = ctx.saved_tensors
        # known DOFs carry NaN sens columns (constants in fk): zero gradient
        dfk = torch.einsum("bkj,bj->bk", torch.nan_to_num(sens), g)
        return dfk, None, None, None, None, None


def fit_rows_diffable(xk, fk, nk, xi, fi_init=None, *, dimension: int, order: int,
                      weighting: int, knowns: int = 0,
                      refine_steps: int = DEFAULT_REFINE_STEPS):
    """:func:`fit_rows` (basic algorithm), reverse-mode differentiable in fk.

    Counterpart of ``fit_pallas_diffable`` (pallas_fit.py l.1624-1663): the
    forward pass is one ``do_sens`` launch, the backward pass
    ``einsum("bkj,bj->bk", sens, g)``.  xk, xi and fi_init get no gradient
    (the kernel has no geometry derivative; the engine path
    differentiates in them).  ALGO_ITERATIVE is not offered: its
    corrective refits make the map piecewise in fk, and the initial-solve
    sensitivities are not its Jacobian.  Returns fi (B, NO).
    """
    if not supported(dimension, order, knowns, weighting):
        raise ValueError(
            "fit_rows_diffable: configuration not covered by the rows kernel "
            "(dims 1-3, orders 0-4, one order/knowns/weighting, UNIFORM or "
            "CENTER); use the engine path (wlsqm_tpu_torch.fitter.engine)")
    kw = dict(dimension=dimension, order=order, weighting=weighting,
              knowns=knowns, refine_steps=refine_steps)
    return _FitRowsLinear.apply(
        fk, xk.detach(), nk, xi.detach(),
        None if fi_init is None else fi_init.detach(), kw)
