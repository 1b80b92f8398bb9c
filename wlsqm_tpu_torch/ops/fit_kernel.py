"""The moment-assembly fit kernel: host wrapper, plain version, tables.

Port of the moment body of the fused TPU kernel
(``wlsqm_tpu/ops/pallas_fit.py``: ``_make_kernel_moment`` l.438, launched
by ``fit_pallas`` l.1502).  With PLAIN monomial columns the normal matrix
is a weighted moment matrix, ``A[j,m] = M[exp_j + exp_m]`` with
``M[e] = sum_k w_k prod_a d_ka^e_a`` over the radius-prescaled offsets d,
and every neighbor's contribution to every moment is ONE multiply, chained
from a lower-degree moment (:func:`moment_lattice`).  The RHS is the same
chain rooted at w*f over the DOF exponents (:func:`dof_chain`).  Per case:
known DOFs eliminated through the moments (``b_m -= g_j M[e_j + e_m]``,
identity rows, scale 1; l.633-650), Jacobi scale from the moment diagonal,
Cholesky of the scaled matrix, one solve, then ``refine_steps`` residual
sweeps through the moments; with ``max_iter`` the ALGO_ITERATIVE
corrective refits, each one such sweep, stopped by the reference's exact
l∞ stagnation rule on the per-neighbour data residual (l.817-885); the
known values written back on output (l.887-897).

The TPU computes this in f32 pairs because it has no f64; the H100 has
native FP64, so both versions here compute in float64 and are held to the
f64 engine.  Two versions of the same math:

* :func:`fit_moments_plain` — batched torch, any dimension and order; what
  the CPU runs, and what the CUDA kernel is checked against;
* the CUDA kernel ``csrc/fit_moment.cu`` — dims 1-3, orders 0-4, any
  knowns mask, the basic algorithm and ALGO_ITERATIVE, UNIFORM/CENTER
  (:func:`supported`); one library per dimension (and one more with the
  key).  A thread per case for the small systems (NO < :data:`WARP_MIN_NO`:
  1D, 2D, 3D orders 0-2), a warp per case for 3D orders 3-4.  It computes
  each case's radius scale, scales the known values and de-scales fi in its
  stores, so its wrapper makes no pass over the inputs.  Its loop tables are
  generated from :func:`moment_lattice` and :func:`dof_chain`
  (:func:`tables_header`), so the two versions cannot drift.

:func:`fit_kernel` takes the JAX public layout and returns (B, NO) f64
DOFs (and the counts with ``max_iter``).  On a CPU tensor it runs the plain
version; on a CUDA tensor it launches the kernel or raises.
:data:`LAUNCHES` counts kernel launches.

With ``emit_cond=True`` both versions also return the per-case
conditioning key (``_cond_estimate``, pallas_fit.py l.382, the
``emit_cond`` output of that kernel): ``‖A_jac‖∞ · ‖A_jac⁻¹‖_F · amp``, an
upper bound of ``cond₂(A_jac) · amp`` with ``amp = max(inv_s, 1)^order``,
from the scaled matrix (identity rows for the known DOFs) and the Cholesky
factor the fit already holds (:func:`cond_key_from_factor` is the plain
version).  The kernel with the key is a second library of the same source
(``-DWLSQM_EMIT_COND=1``), so the instances without it compile as before;
:data:`COND_LAUNCHES` counts its launches.
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

__all__ = ["fit_kernel", "fit_moments_plain", "supported", "auto_ok", "cert_ok",
           "LAUNCHES", "COND_LAUNCHES", "cond_key_from_factor", "cond_amp_factor"]

#: residual sweeps after the direct f64 solve
DEFAULT_REFINE_STEPS = 1

#: number of CUDA kernel launches made by :func:`fit_kernel`
LAUNCHES = 0

#: of those, the launches that also wrote the conditioning key
COND_LAUNCHES = 0

#: largest moment lattice the moment body takes: the JAX package's
#: ``pallas_fit.MOMENT_AUTO_NM`` (every order <= 4 in dims 1-3; 3D order 4
#: has 165 moments of degree <= 8)
MOMENT_AUTO_NM = 165

#: the kernel runs a warp per case for NO >= WARP_MIN_NO (3D orders 3-4):
#: a thread's moments (NM = 84 / 165) and packed factor do not fit its
#: registers and a block's shared memory there
WARP_MIN_NO = 20

_SRC = os.path.join(native.CSRC, "fit_moment.cu")
_INCLUDES = (os.path.join(native.CSRC, "warp_chol.cuh"),)
_HEADER = "fit_moment_tables.cuh"
_ENTRY = "wlsqm_fit_moment"
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


def known_dofs(knowns: int, dimension: int, order: int) -> list[int]:
    """The DOFs (below NO) that the knowns bitmask marks as known."""
    return [j for j in range(defs.number_of_dofs(dimension, order))
            if (int(knowns) >> j) & 1]


def warp_body(dimension: int, order: int) -> bool:
    """Whether the kernel instance of (dimension, order) is the warp body:
    a compile-time rule on NO, written into the generated header."""
    return defs.number_of_dofs(dimension, order) >= WARP_MIN_NO


def _switch(name: str, arg: str, values) -> list[str]:
    """A constexpr switch function returning ``values[arg]``."""
    cases = " ".join("case %d: return %d;" % (i, v) for i, v in enumerate(values))
    return ["  __host__ __device__ static constexpr int %s(int %s) {" % (name, arg),
            "    switch (%s) { %s default: return 0; }" % (arg, cases),
            "  }"]


def _array(name: str, values, ctype: str = "unsigned char",
           rtype: str = "int") -> list[str]:
    """A device array of small integers (read at run-time indices)."""
    return ["  static __device__ __forceinline__ %s %s(int i) {" % (rtype, name),
            "    static const %s v[] = {%s};"
            % (ctype, ", ".join(str(int(v)) for v in values)),
            "    return v[i];",
            "  }"]


def _warp_pairs(order: int) -> list[tuple[int, int]]:
    """The (x, y) exponent pairs of the 3D moment lattice, the rows of the
    warp body's moment product, by degree a + b: those of degree <= order,
    the only ones whose products reach the RHS columns or the z power 2
    order, come first and fill the first :func:`_warp_rhs_tiles` tiles."""
    return sorted(((a, b) for a in range(2 * order + 1) for b in range(2 * order + 1 - a)),
                  key=lambda ab: (ab[0] + ab[1], ab))


def _warp_rhs_tiles(order: int) -> int:
    """How many 8-row tiles of pairs the product's second column tile
    (columns 8-15: w dz^c for c >= 8, then w f dz^c) must run for: the
    tiles that hold a pair of degree <= order; the map drops every product
    of that column tile past them (checked here)."""
    pairs = _warp_pairs(order)
    tiles = -(-sum(a + b <= order for a, b in pairs) // 8)
    pmap = _warp_product_map(order)
    if any(pmap[p * 16 + c] != 255 for p in range(8 * tiles, len(pairs)) for c in range(8, 16)):
        raise AssertionError("a product past the RHS tiles is kept")
    return tiles


def _warp_pair_rows(order: int) -> list[int]:
    """For each row p of the warp body's moment product, padded to a
    multiple of 8: a | b << 4 for its (x, y) pair (a, b), the ladder rows
    its lanes multiply; 0 for the padding (products the map drops)."""
    pairs = _warp_pairs(order)
    return [a | b << 4 for a, b in pairs] + [0] * (-(-len(pairs) // 8) * 8 - len(pairs))


def _warp_product_map(order: int) -> list[int]:
    """For each (pair p, column col) of the warp body's moment product (16
    columns: z powers 0..2 order of w, then 0..order of w f): the moment it
    is (its lattice index), NM + the DOF it is the RHS entry of, or 255."""
    _, _, index = moment_lattice(3, 2 * order)
    NM = len(index)
    exp = tables.EXPONENTS[3][:defs.number_of_dofs(3, order)]
    dof = {tuple(int(v) for v in row): j for j, row in enumerate(exp)}
    pairs = _warp_pairs(order)
    out = []
    for p in range(-(-len(pairs) // 8) * 8):
        for col in range(16):
            v = 255
            if p < len(pairs):
                a, b = pairs[p]
                if col <= 2 * order and a + b + col <= 2 * order:
                    v = index[(a, b, col)]
                elif 2 * order < col <= 3 * order + 1 and (a, b, col - 2 * order - 1) in dof:
                    v = NM + dof[(a, b, col - 2 * order - 1)]
            out.append(v)
    return out


def warp_triangle(dimension: int, order: int) -> list[int]:
    """For each entry (i, m), m <= i, of the packed lower normal matrix, in
    packed order (row i at i (i + 1) / 2): i | m << 8 | slot(m, i) << 16,
    the row, the column and the moment the warp body reads for it."""
    slots = moment_slots(dimension, order)
    NO = len(slots)
    return [i | m << 8 | int(slots[m, i]) << 16 for i in range(NO) for m in range(i + 1)]


def tables_header() -> str:
    """C++ header with the kernel's loop tables, one struct per (dim, order).

    ``MomentTables<DIM, ORDER>`` holds NO and NM, ``kWarp`` (:func:`warp_body`),
    the moment chain (``mpar``, ``maxis``), the RHS chain over the DOFs
    (``bpar``, ``baxis``), the moment index of each A[j, m] (``slot``),
    each moment's exponent of axis a (``me(i, a)``; ``mex`` and ``mey``, its
    first and last axis), and per DOF its exponent of axis a (``de(j, a)``),
    degree (``deg``), first exponent (``ex``) and factorial product
    (``fact``, for the de-scale), all as constexpr switch functions: inside
    the thread body's unrolled loops every argument is a compile-time
    constant, so each lookup folds away and the per-case arrays stay in
    registers.  The warp body (3D) indexes its tables at run time, so its
    instances also get device arrays (``slot_at``, ``deg_at``, ``fact_at``,
    and ``tri_at``, :func:`warp_triangle`, which its lanes read in packed
    order): a switch on a run-time index would be left as a jump table.  Its
    moment sums are one matrix product, rows the (x, y) exponent pairs
    (``pab_at``, :func:`_warp_pair_rows`; NPP of them, padded to a multiple
    of 8, by degree, so the second column tile runs for the first ``TJ1``
    row tiles only, :func:`_warp_rhs_tiles`), columns the z powers of w and
    then of w f; ``pc_at(p * 16 + col)`` says which moment (below NM) or RHS
    entry (NM + DOF) each product is, 255 none.
    """
    out = ["// Generated by wlsqm_tpu_torch.ops.fit_kernel.tables_header() from",
           "// moment_lattice() and dof_chain(); the build writes it, do not edit.",
           "#pragma once",
           "",
           "template <int DIM, int ORDER> struct MomentTables;",
           ""]
    for dim in (1, 2, 3):
        for order in range(defs.MAX_ORDER + 1):
            NO = defs.number_of_dofs(dim, order)
            mexp, parents, _ = moment_lattice(dim, 2 * order)
            _, chain = dof_chain(dim, order)
            slots = moment_slots(dim, order)
            exp = tables.EXPONENTS[dim][:NO]
            facts = [int(np.prod([factorial(int(v)) for v in row])) for row in exp]
            warp = warp_body(dim, order)
            out += ["template <> struct MomentTables<%d, %d> {" % (dim, order),
                    "  static constexpr int NO = %d;" % NO,
                    "  static constexpr int NM = %d;" % len(parents),
                    "  static constexpr bool kWarp = %s;" % str(warp).lower()]
            out += _switch("mpar", "i", [p if p is not None else 0 for p, _ in parents])
            out += _switch("maxis", "i", [a if a is not None else 0 for _, a in parents])
            out += _switch("bpar", "j", [p if p is not None else 0 for p, _ in chain])
            out += _switch("baxis", "j", [a if a is not None else 0 for _, a in chain])
            out += _switch("mex", "i", [int(e[0]) for e in mexp])
            out += _switch("mey", "i", [int(e[-1]) for e in mexp])
            out += _switch("deg", "j", [int(row.sum()) for row in exp])
            out += _switch("ex", "j", [int(row[0]) for row in exp])
            out += _switch("fact", "j", facts)
            out += ["  __host__ __device__ static constexpr int me(int i, int a) {",
                    "    switch (i * %d + a) { %s default: return 0; }" % (dim, " ".join(
                        "case %d: return %d;" % (i * dim + a, int(mexp[i, a]))
                        for i in range(len(mexp)) for a in range(dim) if mexp[i, a])),
                    "  }",
                    "  __host__ __device__ static constexpr int de(int j, int a) {",
                    "    switch (j * %d + a) { %s default: return 0; }" % (dim, " ".join(
                        "case %d: return %d;" % (j * dim + a, int(exp[j, a]))
                        for j in range(NO) for a in range(dim) if exp[j, a])),
                    "  }",
                    "  __host__ __device__ static constexpr int slot(int j, int m) {",
                    "    switch (j * NO + m) { %s default: return 0; }" % " ".join(
                        "case %d: return %d;" % (i, v)
                        for i, v in enumerate(slots.reshape(-1))),
                    "  }"]
            if warp:
                pairs = _warp_pairs(order)
                out += ["  static constexpr int NPP = %d;" % (-(-len(pairs) // 8) * 8),
                        "  static constexpr int TJ1 = %d;" % _warp_rhs_tiles(order)]
                out += _array("pc_at", _warp_product_map(order))
                out += _array("pab_at", _warp_pair_rows(order))
                out += _array("slot_at", slots.reshape(-1))
                out += _array("tri_at", warp_triangle(dim, order), "unsigned", "unsigned")
                out += _array("deg_at", [int(row.sum()) for row in exp])
                out += _array("fact_at", facts)
            out += ["};", ""]
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Shared host math: prescale, de-scale, scaled knowns
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


def _scaled_knowns(fi_init, dscale, KN):
    """ĝ = gi / fact · 2^(e_s·deg) on the known DOFs, 0 elsewhere (B, NO);
    gi = fi_init, or 0 when it is None (pallas_fit.py l.1425-1433).  The
    kernels compute the same quotient, bit for bit, from fi_init."""
    g = dscale.new_zeros(dscale.shape)
    if fi_init is not None:
        g[:, KN] = fi_init[:, KN].to(dscale) / dscale[:, KN]
    return g


def _restore_knowns(fi, fi_init, KN):
    """The known DOFs of fi set to fi_init's values bit for bit (0 without
    fi_init), as ``fit_pallas`` restores them (pallas_fit.py l.1524-1529)."""
    if KN:
        fi[:, KN] = (fi.new_zeros(()) if fi_init is None else fi_init[:, KN].to(fi))
    return fi


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


def _solve_moments(d, fk, kmask, ghat=None, *, dimension, order, weighting,
                   refine_steps, KN=(), max_iter=0, emit_cond=False):
    """Solution in the scaled plain-monomial space, from prescaled offsets
    ``d`` (B, K, dim) and data ``fk`` (B, K), both zero on padded slots, and
    the scaled known values ``ghat`` (B, NO) of the DOFs ``KN``.  Returns
    (x̂ (B, NO) with ĝ on the known DOFs, the counts or None, the key before
    the radius amplification or None)."""
    NO = defs.number_of_dofs(dimension, order)
    _, parents, _ = moment_lattice(dimension, 2 * order)
    _, chain = dof_chain(dimension, order)
    slots_np = moment_slots(dimension, order)
    slots = torch.as_tensor(slots_np, device=d.device)
    unknown = torch.ones(NO, dtype=torch.bool, device=d.device)
    unknown[list(KN)] = False
    UN = [j for j in range(NO) if j not in KN]

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
    for j in KN:    # the known values through the moments: b_m -= g_j M[e_j + e_m]
        b[:, UN] = b[:, UN] - ghat[:, j:j + 1] * M[:, slots_np[j, UN]]

    A = M[:, slots]                                               # (B, NO, NO)
    djj = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.where(djj > 0, 1.0 / torch.sqrt(torch.where(djj > 0, djj, 1.0)), 1.0)
    As = A * (s[:, :, None] * s[:, None, :])
    if KN:          # identity rows and columns, scale 1
        s = torch.where(unknown, s, 1.0)
        As[:, KN, :] = 0.0
        As[:, :, KN] = 0.0
        As[:, KN, KN] = 1.0
    L = _cholesky_guarded(As)

    def sweep(y):
        """y + solve(s (b - A (s y))) over the unknown DOFs."""
        acc = (A @ torch.where(unknown, y * s, 0.0)[..., None])[..., 0]
        return y + _chol_solve(L, torch.where(unknown, (b - acc) * s, 0.0))

    y = _chol_solve(L, torch.where(unknown, b * s, 0.0))
    for _ in range(refine_steps):
        y = sweep(y)

    iters = None
    if max_iter:
        # the basis rows for the data residual, by the same chains
        cv = [torch.ones_like(d[..., 0])]
        for p, ax in chain[1:]:
            cv.append(cv[p] * d[..., ax])
        c = torch.stack(cv, dim=-1)                               # (B, K, NO)
        B = d.shape[0]
        done = torch.zeros(B, dtype=torch.bool, device=d.device)
        prev = torch.full((B,), -1.0, dtype=d.dtype, device=d.device)
        iters = torch.zeros(B, dtype=torch.int32, device=d.device)
        for _ in range(max_iter):
            xh = torch.where(unknown, y * s, ghat if KN else 0.0)
            r = torch.where(kmask, fk - (c @ xh[..., None])[..., 0], 0.0)
            nrm = r.abs().amax(dim=-1)
            done = done | (nrm == prev)
            upd = ~done
            y = torch.where(upd[:, None], sweep(y), y)
            iters += upd.to(torch.int32)
            prev = nrm

    x = y * s
    if KN:
        x = torch.where(unknown, x, ghat)
    return x, iters, cond_key_from_factor(As, L) if emit_cond else None


def fit_moments_plain(xk, fk, nk, xi, fi_init=None, *, dimension: int, order: int,
                      weighting: int, knowns: int = 0,
                      refine_steps: int = DEFAULT_REFINE_STEPS, max_iter: int = 0,
                      emit_cond: bool = False):
    """The kernel's computation in batched torch f64, any dimension and order.

    xk (B, K, dim) | fk (B, K) | nk (B,) | xi (B, dim) | fi_init (B, >=NO)
    or None (the known values; 0 without it).  Returns fi (B, NO) in the
    reference's DOF convention (known DOFs are fi_init's bits), then the
    counts (B,) int32 when ``max_iter > 0``, then the key (B,) with
    ``emit_cond``; fi alone when neither is asked.  Memory is O(B·K·NM): the
    chain values of every moment are live at once.
    """
    delta, kmask, e_s, inv_s = _prescale(xk, nk, xi)
    dscale = _dof_scale(e_s, dimension, order)
    KN = known_dofs(knowns, dimension, order)
    ghat = _scaled_knowns(fi_init, dscale, KN) if KN else None
    x, iters, key = _solve_moments(
        delta * inv_s[:, None, None], torch.where(kmask, fk, 0.0), kmask, ghat,
        dimension=dimension, order=order, weighting=weighting,
        refine_steps=refine_steps, KN=KN, max_iter=max_iter, emit_cond=emit_cond)
    out = [_restore_knowns(x * dscale, fi_init, KN)]
    if max_iter:
        out.append(iters)
    if emit_cond:
        out.append(key * cond_amp_factor(inv_s, order))
    return out[0] if len(out) == 1 else tuple(out)


# ---------------------------------------------------------------------------
# Coverage
# ---------------------------------------------------------------------------

@functools.cache
def _lattice_size(dimension: int, order: int) -> int:
    """NM, cached: the predicates run on every call of the route."""
    return len(moment_lattice(dimension, 2 * order)[0])


def supported(dimension: int, order, knowns, weighting, *, do_sens: bool = False) -> bool:
    """Whether the CUDA kernel covers this configuration.

    Homogeneous batches only (one order, one knowns mask, one weighting),
    dimensions 1-3, orders 0-4 with a lattice of at most
    :data:`MOMENT_AUTO_NM` moments, WEIGHT_UNIFORM or WEIGHT_CENTER, the
    basic algorithm or ALGO_ITERATIVE, no sensitivities (they need per
    (k, j) basis rows: the rows kernel's).  K is not limited.  ``fit_many``
    routes by configuration (:func:`auto_ok`, :func:`cert_ok`), never on
    failure.
    """
    order = np.asarray(order)
    knowns = np.asarray(knowns)
    weighting = np.asarray(weighting)
    return bool(
        not do_sens
        and order.min() == order.max()
        and auto_ok(dimension, int(order.max()))
        and knowns.min() == knowns.max()
        and weighting.min() == weighting.max()
        and int(weighting.max()) in (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER))


def auto_ok(dimension: int, order: int) -> bool:
    """Whether a forced kernel (``backend="kernel"``) may take the moment
    body: the port's ``pallas_fit.moment_auto_ok``, the lattice guard
    without the TPU's VMEM term (this kernel takes any K)."""
    return (dimension in (1, 2, 3) and 0 <= order <= defs.MAX_ORDER
            and _lattice_size(int(dimension), int(order)) <= MOMENT_AUTO_NM)


def cert_ok(dimension: int, order: int) -> bool:
    """Whether the certified route may take the moment body: the port's
    ``pallas_fit.moment_cert_ok``, dimension <= 2 (the moment calibration
    units come from the 1D/2D family; certified 3D stays on the rows body)."""
    return dimension <= 2 and auto_ok(dimension, order)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def load(dimension: int, emit_cond: bool = False) -> native.Library:
    """The kernel's shared library of one dimension, built with nvcc on
    first use; with ``emit_cond`` the library whose instances also write the
    key."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return native.build(
        "fit_moment_d%d%s" % (dimension, "_cond" if emit_cond else ""), [_SRC],
        {_HEADER: tables_header()},
        {_ENTRY: (i32, [vp] * 8 + [i64, i32, i32, i32, i32, i64, i64, i32, i32, i32, vp]),
         _SCALE_ENTRY: (i32, [vp] * 5 + [i64, i32, i32, vp])},
        defines=("WLSQM_EMIT_COND=%d" % emit_cond, "WLSQM_MOMENT_DIM=%d" % dimension),
        includes=_INCLUDES)


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


def _launch(xk, fk, nk, xi, out, est=None, *, gi=None, iters=None, order: int,
            weighting: int, knowns: int = 0, refine_steps: int, max_iter: int = 0,
            ext: int | None = None) -> None:
    """Launch the kernel on the current stream: out = fi (the scale, the
    known values' scale and the de-scale happen in the kernel; known DOFs
    get gi's bits, or 0 where gi is None), est (B,) = the key with its
    radius amplification when it is given, and iters (B,) = the
    ALGO_ITERATIVE counts when ``max_iter > 0``.  gi (B, >=NO) f64 with unit
    column stride, or None.

    ``ext`` picks the 2D thread body's instance: 1 (or True) the one
    compiled with knowns (and ALGO_ITERATIVE), 2 the one with
    ALGO_ITERATIVE alone; by default the call's own (knowns: 1; else
    ``max_iter > 0``: 2; else the basic instance, compiled without either).
    It exists for card tests that hold the 2D instances to the same bits on
    calls that ask less than an instance adds: no knowns mask or
    ``max_iter`` reaches those instances otherwise without running what
    they add.  Checks device, dtype, shape and contiguity, and raises on
    a refused launch (the C entry returns ``cudaGetLastError()``).  Does not
    synchronise.
    """
    global LAUNCHES, COND_LAUNCHES
    B, K, dim = xk.shape
    NO = defs.number_of_dofs(dim, order)
    has_known = bool(known_dofs(knowns, dim, order))
    expect = [(xk, (B, K, dim), torch.float64), (fk, (B, K), torch.float64),
              (nk, (B,), torch.int32), (xi, (B, dim), torch.float64),
              (out, (B, NO), torch.float64)]
    for t, shape, dtype, want in ((iters, (B,), torch.int32, max_iter > 0),
                                  (est, (B,), torch.float64, est is not None)):
        if (t is not None) != want:
            raise ValueError("fit_moment kernel: an optional tensor of shape %s is %s"
                             % (shape, "missing" if want else "not expected"))
        if t is not None:
            expect.append((t, shape, dtype))
    _check(expect, "fit_moment")
    if gi is not None and (gi.device != xk.device or gi.dtype != torch.float64
                           or gi.ndim != 2 or gi.shape[0] != B or gi.shape[1] < NO
                           or (B > 1 and gi.stride(1) != 1)):
        raise ValueError("fit_moment kernel wants the known values as a (B, >=NO) f64 "
                         "tensor with unit column stride on %s; got %s %s on %s"
                         % (xk.device, gi.dtype, tuple(gi.shape), gi.device))
    if (not supported(dim, order, knowns, weighting) or refine_steps < 0 or max_iter < 0
            or K < 1):
        raise ValueError("fit_moment kernel does not cover dim=%d order=%d knowns=%d "
                         "weighting=%d refine_steps=%d max_iter=%d K=%d"
                         % (dim, order, knowns, weighting, refine_steps, max_iter, K))
    if B == 0:
        return
    if ext is None:
        ext = 1 if has_known else 2 if max_iter > 0 else 0

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = load(dim, est is not None).lib
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream(xk.device).cuda_stream
        status = getattr(lib, _ENTRY)(
            xk.data_ptr(), fk.data_ptr(), nk.data_ptr(), xi.data_ptr(),
            ptr(gi if has_known else None), out.data_ptr(), ptr(iters), ptr(est), B, K,
            dim, order, weighting, int(knowns) if has_known else 0,
            gi.stride(0) if has_known and gi is not None else 0, refine_steps, max_iter,
            int(ext), stream)
    if status != 0:
        raise RuntimeError("fit_moment kernel launch failed: CUDA error %d" % status)
    LAUNCHES += 1
    COND_LAUNCHES += est is not None


def moment_scale(xk, nk, xi):
    """The kernel's own scale alone, on the card: (e_s, inv_s) per case from
    the same device functions the fit runs (``wlsqm_moment_scale``), for
    holding them to :func:`_prescale` bit for bit.  xk (B, K, dim) f64 |
    nk (B,) i32 | xi (B, dim) f64, contiguous on one CUDA device."""
    B, K, dim = xk.shape
    e_s = torch.empty((B,), dtype=torch.float64, device=xk.device)
    inv_s = torch.empty_like(e_s)
    _check([(xk, (B, K, dim), torch.float64), (nk, (B,), torch.int32),
            (xi, (B, dim), torch.float64)], "moment_scale")
    with torch.cuda.device(xk.device):
        status = getattr(load(dim).lib, _SCALE_ENTRY)(
            xk.data_ptr(), nk.data_ptr(), xi.data_ptr(), e_s.data_ptr(),
            inv_s.data_ptr(), B, K, dim, torch.cuda.current_stream(xk.device).cuda_stream)
    if status != 0:
        raise RuntimeError("moment_scale launch failed: CUDA error %d" % status)
    return e_s, inv_s


def fit_kernel(xk, fk, nk, xi, fi_init=None, *, dimension: int, order: int,
               weighting: int, knowns: int = 0, refine_steps: int = DEFAULT_REFINE_STEPS,
               max_iter: int = 0, emit_cond: bool = False):
    """Fit a homogeneous batch with the moment-assembly kernel.

    xk (B, K, dim) f64 | fk (B, K) f64 | nk (B,) int | xi (B, dim) f64 |
    fi_init (B, >=NO) f64 or None (the known values), all on one device.
    Returns fi (B, NO) f64 when ``max_iter == 0``, else (fi, iters (B,)
    int32), with the conditioning key (B,) f64 last under ``emit_cond`` (fi
    is the same bits either way), as ``fit_pallas`` orders its outputs.  A
    CPU tensor runs :func:`fit_moments_plain`; a CUDA tensor launches the
    kernel (see :func:`supported` for what it covers) or raises: it never
    falls back.  On the card the kernel scales, scales the known values and
    de-scales each case itself, so this is argument checks and one launch:
    nothing of size (B, K) is allocated and no pass is made over xk or fk.
    """
    if xk.device.type == "cpu":
        return fit_moments_plain(xk, fk, nk, xi, fi_init, dimension=dimension,
                                 order=order, weighting=weighting, knowns=knowns,
                                 refine_steps=refine_steps, max_iter=max_iter,
                                 emit_cond=emit_cond)
    config.refuse_grad("fit_kernel", "differentiate through the f64 engine "
                       "(wlsqm_tpu_torch.fitter.engine.fit_batch)", xk, fk, xi, fi_init)
    if xk.shape[-1] != dimension:
        raise ValueError("xk has dimension %d, not %d" % (xk.shape[-1], dimension))
    B = xk.shape[0]
    gi = None
    if fi_init is not None and known_dofs(knowns, dimension, order):
        gi = fi_init if fi_init.stride(-1) == 1 else fi_init.contiguous()
    out = torch.empty((B, defs.number_of_dofs(dimension, order)), dtype=torch.float64,
                      device=xk.device)
    iters = (torch.empty((B,), dtype=torch.int32, device=xk.device) if max_iter > 0
             else None)
    est = torch.empty((B,), dtype=torch.float64, device=xk.device) if emit_cond else None
    _launch(xk.contiguous(), fk.contiguous(), nk.to(torch.int32).contiguous(),
            xi.contiguous(), out, est, gi=gi, iters=iters, order=order,
            weighting=weighting, knowns=knowns, refine_steps=refine_steps,
            max_iter=max_iter)
    res = [out] + ([iters] if max_iter > 0 else []) + ([est] if emit_cond else [])
    return res[0] if len(res) == 1 else tuple(res)
