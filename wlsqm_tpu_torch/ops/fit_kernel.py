"""The moment-assembly fit kernel: host wrapper, plain version, tables.

Port of the moment body of the fused TPU kernel
(``wlsqm_tpu/ops/pallas_fit.py``: ``_make_kernel_moment`` l.438, launched
by ``fit_pallas`` l.1316).  With PLAIN monomial columns the normal matrix
is a weighted moment matrix, ``A[j,m] = M[exp_j + exp_m]`` with
``M[e] = sum_k w_k prod_a d_ka^e_a`` over the radius-prescaled offsets d,
and every neighbor's contribution to every moment is ONE multiply, chained
from a lower-degree moment (:func:`moment_lattice`).  The RHS is the same
chain rooted at w*f over the DOF exponents (:func:`dof_chain`).  Per case:
Jacobi scale from the moment diagonal, Cholesky of the scaled matrix, one
solve, then ``refine_steps`` residual sweeps through the moments.

The TPU computes this in f32 pairs because it has no f64; the H100 has
native FP64, so both versions here compute in float64 and are held to the
f64 engine.  Two versions of the same math:

* :func:`fit_moments_plain` — batched torch, any dimension and order; what
  the CPU runs, and what the CUDA kernel is checked against;
* the CUDA kernel ``csrc/fit_moment.cu`` — one thread per case, its
  moments, scale and last factor rows in shared memory, dim 2, orders 0-4,
  UNIFORM/CENTER, basic algorithm, no knowns (:func:`supported`); it
  computes each case's radius scale and de-scales fi in its stores, so its
  wrapper makes no pass over the inputs.  Its loop tables are generated from
  :func:`moment_lattice` and :func:`dof_chain` (:func:`tables_header`), so
  the two versions cannot drift.

:func:`fit_kernel` takes the JAX public layout and returns (B, NO) f64
DOFs.  On a CPU tensor it runs the plain version; on a CUDA tensor it
launches the kernel or raises.  :data:`LAUNCHES` counts kernel launches.

With ``emit_cond=True`` both versions also return the per-case
conditioning key (``_cond_estimate``, pallas_fit.py l.382, the
``emit_cond`` output of that kernel): ``‖A_jac‖∞ · ‖A_jac⁻¹‖_F · amp``, an
upper bound of ``cond₂(A_jac) · amp`` with ``amp = max(inv_s, 1)^order``,
from the scaled matrix and the Cholesky factor the fit already holds
(:func:`cond_key_from_factor` is the plain version).  The kernel with the
key is a second library of the same source (``-DWLSQM_EMIT_COND=1``), so
the instances without it compile as before; :data:`COND_LAUNCHES` counts
its launches.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
from math import factorial

import numpy as np
import torch

from wlsqm_tpu_torch import config, native
from wlsqm_tpu_torch.fitter import defs, engine, tables

__all__ = ["fit_kernel", "fit_moments_plain", "supported", "LAUNCHES",
           "COND_LAUNCHES", "cond_key_from_factor", "cond_amp_factor"]

#: residual sweeps after the direct f64 solve
DEFAULT_REFINE_STEPS = 1

#: number of CUDA kernel launches made by :func:`fit_kernel`
LAUNCHES = 0

#: of those, the launches that also wrote the conditioning key
COND_LAUNCHES = 0

#: the kernel's configuration space (anything else routes to the engine)
KERNEL_DIMENSION = 2

_SRC = os.path.join(native.CSRC, "fit_moment.cu")
_HEADER = "fit_moment_tables.cuh"
_ENTRY = "wlsqm_fit_moment_2d"
_SCALE_ENTRY = "wlsqm_moment_scale"


# ---------------------------------------------------------------------------
# Chain tables (shared by the plain version and the generated CUDA header)
# ---------------------------------------------------------------------------

def moment_lattice(dimension: int, maxdeg: int):
    """Degree-graded lattice of multi-indices with chain parents.

    Returns (exps, parents, index): exps is an (NM, dimension) int array
    ordered by (degree, lex), so every entry's parent (itself minus one unit
    on its first nonzero axis) appears earlier; parents[i] = (parent_index,
    axis) with parents[0] = (None, None); index maps exponent tuples to
    positions.  Same table as ``pallas_fit._moment_lattice``.
    """
    exps = sorted(
        (e for e in itertools.product(range(maxdeg + 1), repeat=dimension)
         if sum(e) <= maxdeg),
        key=lambda e: (sum(e), e))
    index = {e: i for i, e in enumerate(exps)}
    parents = [(None, None)]
    for e in exps[1:]:
        ax = next(a for a in range(dimension) if e[a] > 0)
        p = list(e)
        p[ax] -= 1
        parents.append((index[tuple(p)], ax))
    return np.asarray(exps, np.int64), parents, index


def dof_chain(dimension: int, order: int):
    """Chain parents over the DOF exponent rows (reference DOF order).

    The DOF layout is degree-graded (reference: wlsqm/fitter/defs.pyx:79-87),
    so each row's parent monomial appears at a smaller index.  Returns
    (exp, chain) with chain[j] = (parent_dof, axis), (None, None) for F.
    """
    NO = defs.number_of_dofs(dimension, order)
    exp = tables.EXPONENTS[dimension][:NO]
    index = {tuple(int(v) for v in row): j for j, row in enumerate(exp)}
    chain = []
    for j, row in enumerate(exp):
        e = tuple(int(v) for v in row)
        if sum(e) == 0:
            chain.append((None, None))
            continue
        ax = next(a for a in range(dimension) if e[a] > 0)
        p = list(e)
        p[ax] -= 1
        pj = index[tuple(p)]
        if pj >= j:
            raise AssertionError("DOF layout must be degree-graded")
        chain.append((pj, ax))
    return exp, chain


def moment_slots(dimension: int, order: int) -> np.ndarray:
    """(NO, NO) moment index of each normal-matrix entry A[j, m]."""
    exp, _ = dof_chain(dimension, order)
    _, _, index = moment_lattice(dimension, 2 * order)
    return np.asarray([[index[tuple(int(v) for v in (exp[j] + exp[m]))]
                        for m in range(len(exp))] for j in range(len(exp))],
                      np.int64)


def _switch(name: str, arg: str, values) -> list[str]:
    """A constexpr switch function returning ``values[arg]``."""
    cases = " ".join("case %d: return %d;" % (i, v) for i, v in enumerate(values))
    return ["  __host__ __device__ static constexpr int %s(int %s) {" % (name, arg),
            "    switch (%s) { %s default: return 0; }" % (arg, cases),
            "  }"]


def tables_header(dimension: int = KERNEL_DIMENSION) -> str:
    """C++ header with the kernel's loop tables, one struct per order.

    ``MomentTables<ORDER>`` holds NO and NM, the moment chain (``mpar``,
    ``maxis``), the RHS chain over the DOFs (``bpar``, ``baxis``), the
    moment index of each A[j, m] (``slot``), each moment's exponents
    (``mex``, ``mey``: first and last axis), and per DOF its degree
    (``deg``), first exponent (``ex``) and factorial product (``fact``,
    for the de-scale), all as constexpr switch
    functions: inside the kernel's unrolled loops every argument is a
    compile-time constant, so each lookup folds away and the per-case
    arrays stay in registers.
    """
    out = ["// Generated by wlsqm_tpu_torch.ops.fit_kernel.tables_header() from",
           "// moment_lattice() and dof_chain(); the build writes it, do not edit.",
           "#pragma once",
           "",
           "template <int ORDER> struct MomentTables;",
           ""]
    for order in range(defs.MAX_ORDER + 1):
        NO = defs.number_of_dofs(dimension, order)
        _, parents, _ = moment_lattice(dimension, 2 * order)
        _, chain = dof_chain(dimension, order)
        slots = moment_slots(dimension, order)
        out += ["template <> struct MomentTables<%d> {" % order,
                "  static constexpr int NO = %d;" % NO,
                "  static constexpr int NM = %d;" % len(parents)]
        out += _switch("mpar", "i", [p if p is not None else 0 for p, _ in parents])
        out += _switch("maxis", "i", [a if a is not None else 0 for _, a in parents])
        out += _switch("bpar", "j", [p if p is not None else 0 for p, _ in chain])
        out += _switch("baxis", "j", [a if a is not None else 0 for _, a in chain])
        mexp, _, _ = moment_lattice(dimension, 2 * order)
        out += _switch("mex", "i", [int(e[0]) for e in mexp])
        out += _switch("mey", "i", [int(e[-1]) for e in mexp])
        exp = tables.EXPONENTS[dimension][:NO]
        out += _switch("deg", "j", [int(row.sum()) for row in exp])
        out += _switch("ex", "j", [int(row[0]) for row in exp])
        out += _switch("fact", "j", [int(np.prod([factorial(int(v)) for v in row]))
                                     for row in exp])
        out += ["  __host__ __device__ static constexpr int slot(int j, int m) {",
                "    switch (j * NO + m) { %s default: return 0; }" % " ".join(
                    "case %d: return %d;" % (i, v)
                    for i, v in enumerate(slots.reshape(-1))),
                "  }",
                "};",
                ""]
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Shared host math: prescale and de-scale
# ---------------------------------------------------------------------------

def _prescale(xk, nk, xi):
    """Masked offsets and the per-case power-of-two scale.

    Neighbors k >= nk are zeroed before any arithmetic (padded slots may
    hold NaN).  e_s and inv_s = 2^-e_s are computed exactly as
    ``fit_pallas`` does (pallas_fit.py l.1401-1404); the kernel and the
    f64 de-scale use the same e_s.
    """
    K = xk.shape[1]
    kmask = torch.arange(K, device=xk.device)[None, :] < nk[:, None]
    delta = torch.where(kmask[:, :, None], xk - xi[:, None, :], 0.0)
    inv_s, e_s = engine.radius_pow2_scale(torch.sum(delta * delta, dim=-1), kmask)
    return delta, kmask, e_s, inv_s


def _dof_scale(e_s, dimension: int, order: int):
    """fact * 2^(-e_s * deg): the plain scaled monomial space back to the
    reference's baked DOFs.  Every factor is exact (small-integer
    mantissas), so the de-scale rounds once per DOF."""
    NO = defs.number_of_dofs(dimension, order)
    exp = tables.EXPONENTS[dimension][:NO]
    fact = torch.as_tensor([float(np.prod([factorial(int(v)) for v in row]))
                            for row in exp], dtype=e_s.dtype, device=e_s.device)
    deg = torch.as_tensor(tables.DEGREE[dimension][:NO], dtype=e_s.dtype,
                          device=e_s.device)
    return fact[None, :] * torch.exp2(-e_s[:, None] * deg[None, :])


def _case_exponent(xk, nk, xi):
    """Plain twin of the kernel's own scale (``case_h2`` and
    ``scale_exponent`` in csrc/fit_moment.cu): e per case from h² = max over
    k < nk of the unfused sum of the squared unscaled offsets, NaN kept, as
    :func:`_prescale` computes it (the kernel must give its e_s bit for bit,
    since fit_rows and condprobe keep using :func:`_prescale`)."""
    K = xk.shape[1]
    d = xk - xi[:, None, :]
    d2 = d[..., 0] * d[..., 0]
    for a in range(1, xk.shape[-1]):
        d2 = d2 + d[..., a] * d[..., a]
    valid = torch.arange(K, device=xk.device)[None, :] < nk[:, None]
    h2 = torch.where(valid, d2, 0.0).amax(dim=-1)
    return torch.ceil(0.5 * torch.log2(torch.where(h2 > 0, h2, 1.0)))


def _store_scale(e_s, dimension: int, order: int):
    """Plain twin of the kernel's de-scale in its stores:
    ldexp(fact, -e_s * deg) per DOF, exact for finite e_s, so
    ``(y * s) * _store_scale(...)`` is the bits of ``out * _dof_scale(...)``."""
    NO = defs.number_of_dofs(dimension, order)
    exp = tables.EXPONENTS[dimension][:NO]
    fact = torch.as_tensor([float(np.prod([factorial(int(v)) for v in row]))
                            for row in exp], dtype=e_s.dtype, device=e_s.device)
    deg = torch.as_tensor(tables.DEGREE[dimension][:NO], device=e_s.device)
    return torch.ldexp(fact[None, :].expand(len(e_s), NO),
                       (-e_s[:, None] * deg[None, :]).to(torch.int64))


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _cholesky_guarded(A):
    """Batched Cholesky with the kernel's pivot guard sqrt(max(acc, 1e-30)).

    A zero pivot (a degenerate neighborhood, e.g. every neighbor at xi)
    yields a finite factor instead of a failure, as in the TPU kernel
    (pallas_fit.py l.738), so such a case solves to 0 in that DOF.
    """
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        lj = L[:, j, :j]
        dj = torch.sqrt(torch.clamp_min(A[:, j, j] - (lj * lj).sum(-1), 1e-30))
        L[:, j, j] = dj
        if j + 1 < n:
            t = A[:, j, j + 1:] - (L[:, j + 1:, :j] @ lj[..., None])[..., 0]
            L[:, j + 1:, j] = t * (1.0 / dj)[:, None]
    return L


def _chol_solve(L, r):
    y = torch.linalg.solve_triangular(L, r[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def cond_key_from_factor(As, L):
    """‖As‖∞ · ‖As⁻¹‖_F of the scaled matrices ``As`` (B, NO, NO) with lower
    Cholesky factors ``L``: the kernels' conditioning key before the radius
    amplification, in plain torch (NaN row sums are kept)."""
    ninf = As.abs().sum(-1).amax(-1)
    eye = torch.eye(As.shape[-1], dtype=As.dtype, device=As.device).expand_as(As)
    Y = torch.linalg.solve_triangular(L, eye, upper=False)
    Ai = torch.linalg.solve_triangular(L.mT, Y, upper=True)
    return ninf * torch.sqrt((Ai * Ai).sum((-2, -1)))


def cond_amp_factor(inv_s, order: int):
    """The radius amplification of the key: max(inv_s, 1)^order, the factor
    by which the de-scale multiplies the solve's error (pallas_fit.py
    l.1544-1549)."""
    return torch.clamp_min(inv_s, 1.0) ** order


def _solve_moments(d, fk, kmask, *, dimension, order, weighting, refine_steps,
                   emit_cond=False):
    """Solution in the scaled plain-monomial space, from prescaled offsets
    ``d`` (B, K, dim) and data ``fk`` (B, K), both zero on padded slots;
    with ``emit_cond`` also the key before the radius amplification."""
    _, parents, _ = moment_lattice(dimension, 2 * order)
    _, chain = dof_chain(dimension, order)
    slots = torch.as_tensor(moment_slots(dimension, order), device=d.device)

    w = engine.neighbor_weights(torch.sum(d * d, dim=-1), kmask,
                                torch.tensor(weighting, device=d.device))

    vals = [w]
    for p, ax in parents[1:]:
        vals.append(vals[p] * d[..., ax])
    M = torch.stack([v.sum(dim=-1) for v in vals], dim=-1)        # (B, NM)
    bv = [w * fk]
    for p, ax in chain[1:]:
        bv.append(bv[p] * d[..., ax])
    b = torch.stack([v.sum(dim=-1) for v in bv], dim=-1)          # (B, NO)

    A = M[:, slots]                                               # (B, NO, NO)
    djj = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.where(djj > 0, 1.0 / torch.sqrt(torch.where(djj > 0, djj, 1.0)), 1.0)
    As = A * (s[:, :, None] * s[:, None, :])
    L = _cholesky_guarded(As)
    y = _chol_solve(L, b * s)
    for _ in range(refine_steps):
        acc = (A @ (y * s)[..., None])[..., 0]
        y = y + _chol_solve(L, (b - acc) * s)
    if emit_cond:
        return y * s, cond_key_from_factor(As, L)
    return y * s


def fit_moments_plain(xk, fk, nk, xi, *, dimension: int, order: int,
                      weighting: int, refine_steps: int = DEFAULT_REFINE_STEPS,
                      emit_cond: bool = False):
    """The kernel's computation in batched torch f64, any dimension and order.

    xk (B, K, dim) | fk (B, K) | nk (B,) | xi (B, dim).  Returns fi (B, NO)
    in the reference's DOF convention, and with ``emit_cond`` the key (B,)
    after it.  Memory is O(B·K·NM): the chain values of every moment are
    live at once.
    """
    delta, kmask, e_s, inv_s = _prescale(xk, nk, xi)
    out = _solve_moments(delta * inv_s[:, None, None], torch.where(kmask, fk, 0.0),
                         kmask, dimension=dimension, order=order,
                         weighting=weighting, refine_steps=refine_steps,
                         emit_cond=emit_cond)
    dscale = _dof_scale(e_s, dimension, order)
    if emit_cond:
        return out[0] * dscale, out[1] * cond_amp_factor(inv_s, order)
    return out * dscale


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def supported(dimension: int, order, knowns, weighting, *, do_sens: bool = False,
              iterative: bool = False) -> bool:
    """Whether the CUDA kernel covers this configuration.

    Homogeneous batches only (one order, one weighting), dimension 2,
    orders 0-4, WEIGHT_UNIFORM or WEIGHT_CENTER, no knowns, the basic
    algorithm, no sensitivities.  ``fit_many`` routes everything else to
    the engine, by configuration and never on failure.
    """
    order = np.asarray(order)
    knowns = np.asarray(knowns)
    weighting = np.asarray(weighting)
    return bool(
        dimension == KERNEL_DIMENSION
        and not (do_sens or iterative)
        and order.min() == order.max()
        and 0 <= int(order.max()) <= defs.MAX_ORDER
        and not knowns.any()
        and weighting.min() == weighting.max()
        and int(weighting.max()) in (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER))


@functools.cache
def load(emit_cond: bool = False) -> native.Library:
    """The kernel's shared library, built with nvcc on first use; with
    ``emit_cond`` the library whose instances also write the key."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return native.build(
        "fit_moment_cond" if emit_cond else "fit_moment", [_SRC],
        {_HEADER: tables_header()},
        {_ENTRY: (i32, [vp] * 6 + [ctypes.c_int64, i32, i32, i32, i32, vp]),
         _SCALE_ENTRY: (i32, [vp] * 5 + [ctypes.c_int64, i32, vp])},
        defines=("WLSQM_EMIT_COND=%d" % emit_cond,))


def _check(tensors, name: str) -> None:
    """Each (tensor, shape, dtype) contiguous on the first one's CUDA device."""
    dev = tensors[0][0].device
    for t, shape, dtype in tensors:
        if (t.device != dev or t.device.type != "cuda" or tuple(t.shape) != shape
                or t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(
                "%s kernel wants contiguous %s %s on one CUDA device; got "
                "%s %s on %s (xk on %s)"
                % (name, dtype, shape, t.dtype, tuple(t.shape), t.device, dev))


def _launch(xk, fk, nk, xi, out, est=None, *, order: int, weighting: int,
            refine_steps: int) -> None:
    """Launch the kernel on the current stream: out = fi (the scale and the
    de-scale happen in the kernel), and est (B,) = the key with its radius
    amplification when it is given.

    Checks device, dtype, shape and contiguity, and raises on a refused
    launch (the C entry returns ``cudaGetLastError()``).  Does not
    synchronise.
    """
    global LAUNCHES, COND_LAUNCHES
    B, K, dim = xk.shape
    NO = defs.number_of_dofs(dim, order)
    expect = [(xk, (B, K, dim), torch.float64), (fk, (B, K), torch.float64),
              (nk, (B,), torch.int32), (xi, (B, dim), torch.float64),
              (out, (B, NO), torch.float64)]
    if est is not None:
        expect.append((est, (B,), torch.float64))
    _check(expect, "fit_moment")
    if not supported(dim, order, 0, weighting) or refine_steps < 0 or K < 1:
        raise ValueError("fit_moment kernel does not cover dim=%d order=%d "
                         "weighting=%d refine_steps=%d K=%d"
                         % (dim, order, weighting, refine_steps, K))
    if B == 0:
        return
    lib = load(est is not None).lib
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream(xk.device).cuda_stream
        status = getattr(lib, _ENTRY)(
            xk.data_ptr(), fk.data_ptr(), nk.data_ptr(), xi.data_ptr(), out.data_ptr(),
            None if est is None else est.data_ptr(), B, K, order, weighting,
            refine_steps, stream)
    if status != 0:
        raise RuntimeError("fit_moment kernel launch failed: CUDA error %d" % status)
    LAUNCHES += 1
    COND_LAUNCHES += est is not None


def moment_scale(xk, nk, xi):
    """The kernel's own scale alone, on the card: (e_s, inv_s) per case from
    the same device functions the fit runs (``wlsqm_moment_scale``), for
    holding them to :func:`_prescale` bit for bit.  xk (B, K, 2) f64 |
    nk (B,) i32 | xi (B, 2) f64, contiguous on one CUDA device."""
    B, K, dim = xk.shape
    e_s = torch.empty((B,), dtype=torch.float64, device=xk.device)
    inv_s = torch.empty_like(e_s)
    _check([(xk, (B, K, KERNEL_DIMENSION), torch.float64), (nk, (B,), torch.int32),
            (xi, (B, KERNEL_DIMENSION), torch.float64)], "moment_scale")
    with torch.cuda.device(xk.device):
        status = getattr(load().lib, _SCALE_ENTRY)(
            xk.data_ptr(), nk.data_ptr(), xi.data_ptr(), e_s.data_ptr(),
            inv_s.data_ptr(), B, K, torch.cuda.current_stream(xk.device).cuda_stream)
    if status != 0:
        raise RuntimeError("moment_scale launch failed: CUDA error %d" % status)
    return e_s, inv_s


def fit_kernel(xk, fk, nk, xi, *, dimension: int, order: int, weighting: int,
               refine_steps: int = DEFAULT_REFINE_STEPS, emit_cond: bool = False):
    """Fit a homogeneous batch with the moment-assembly kernel.

    xk (B, K, dim) f64 | fk (B, K) f64 | nk (B,) int | xi (B, dim) f64, all
    on one device.  Returns fi (B, NO) f64, and with ``emit_cond`` the
    conditioning key (B,) f64 after it (fi is the same bits either way).  A
    CPU tensor runs :func:`fit_moments_plain`; a CUDA tensor launches the
    kernel (see :func:`supported` for what it covers) or raises.  On the
    card the kernel scales and de-scales each case itself, so this is
    argument checks and one launch: nothing of size (B, K) is allocated and
    no pass is made over xk or fk.
    """
    if xk.device.type == "cpu":
        return fit_moments_plain(xk, fk, nk, xi, dimension=dimension, order=order,
                                 weighting=weighting, refine_steps=refine_steps,
                                 emit_cond=emit_cond)
    config.refuse_grad("fit_kernel", "differentiate through the f64 engine "
                       "(wlsqm_tpu_torch.fitter.engine.fit_batch)", xk, fk, xi)
    if xk.shape[-1] != dimension:
        raise ValueError("xk has dimension %d, not %d" % (xk.shape[-1], dimension))
    B = xk.shape[0]
    out = torch.empty((B, defs.number_of_dofs(dimension, order)), dtype=torch.float64,
                      device=xk.device)
    est = torch.empty((B,), dtype=torch.float64, device=xk.device) if emit_cond else None
    _launch(xk.contiguous(), fk.contiguous(), nk.to(torch.int32).contiguous(),
            xi.contiguous(), out, est, order=order, weighting=weighting,
            refine_steps=refine_steps)
    return (out, est) if emit_cond else out
