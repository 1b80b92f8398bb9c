"""The batched WLSQM fitting engine, float64, in PyTorch.

Port of :mod:`wlsqm_tpu.fitter.engine` at precision ``"f64"``.  It is the
port's own oracle on the card and the route for every configuration the
CUDA kernel does not take.  Same formulation as the JAX engine:

* every case is padded to ``NO`` DOFs and ``K`` neighbors; ragged neighbor
  counts become a weight mask (w = 0 for k >= nk, reference:
  wlsqm/fitter/simple.pyx:334);
* per-case polynomial order becomes a DOF activity mask (the DOF numbering
  is grouped by derivative order);
* known DOFs get identity rows/columns in A and move to the RHS
  (reference: wlsqm/fitter/impl.pyx:789-818);
* batched Ruiz equilibration (:mod:`wlsqm_tpu_torch.ops.ruiz`) and a
  batched Cholesky of the scaled SPD normal matrix
  (:mod:`wlsqm_tpu_torch.ops.solve`).

Shapes (B = number of cases, K = padded neighbor count, NO = padded DOFs):
  xk (B, K, dim) | fk (B, K) | nk (B,) | xi (B, dim)
  order (B,) | knowns (B,) int64 | weighting (B,) | fi (B, NO)
"""

from __future__ import annotations

import dataclasses

import torch

from wlsqm_tpu_torch.fitter import defs, tables
from wlsqm_tpu_torch.ops import ruiz as ruiz_ops
from wlsqm_tpu_torch.ops import solve as solve_ops
from wlsqm_tpu_torch.utils import profiling

# weight function constants (reference: wlsqm/fitter/infra.pyx:45-46)
WEIGHT_ALPHA = 1e-4
WEIGHT_BETA = 1.0 - WEIGHT_ALPHA

PRECISION_F64 = "f64"


# -----------------------------------------------------------------------------
# Basis construction
# -----------------------------------------------------------------------------

def basis(delta: torch.Tensor, dimension: int, NO: int) -> torch.Tensor:
    """Baked monomial basis rows for offsets ``delta``.

    delta: (..., dim) offsets (x - xi).  Returns (..., NO) with
    ``c[..., j] = prod_a delta[..., a] ** EXP[j, a] / prod_a EXP[j, a]!``,
    the powers built by the reference's multiplication sequence
    (d2 = d*d, d3 = d2*d, d4 = d2*d2; reference: wlsqm/fitter/impl.pyx:107-117).
    """
    exp = tables.EXPONENTS[dimension][:NO]
    invfact = torch.as_tensor(tables.INV_FACT[dimension][:NO], dtype=delta.dtype,
                              device=delta.device)
    max_pow = int(exp.max()) if NO > 1 else 0

    cols = []
    for a in range(dimension):
        d = delta[..., a]
        powers = [torch.ones_like(d), d]
        if max_pow >= 2:
            d2 = d * d
            powers.append(d2)
            if max_pow >= 3:
                powers.append(d2 * d)
                if max_pow >= 4:
                    powers.append(d2 * d2)
        p = torch.stack(powers, dim=-1)                     # (..., max_pow+1)
        idx = torch.as_tensor(exp[:, a], dtype=torch.long, device=delta.device)
        cols.append(p[..., idx])                            # (..., NO)
    c = cols[0]
    for col in cols[1:]:
        c = c * col
    return c * invfact


def dof_masks(order: torch.Tensor, knowns: torch.Tensor, dimension: int, NO: int):
    """(active, known, unknown) boolean masks of shape (..., NO)."""
    # defs._DOF_COUNTS as binomial(order + dim, dim), so that no table
    # crosses from the host (a copy that waits on the stream)
    o = order.clamp(0, defs.MAX_ORDER).to(torch.int64)
    no = o + 1
    for i in range(2, dimension + 1):
        no = no * (o + i) // i
    j = torch.arange(NO, dtype=torch.int32, device=order.device)
    active = j < no[..., None]
    bits = (knowns[..., None].to(torch.int64) >> j.to(torch.int64)) & 1
    known = bits.bool() & active
    unknown = active & ~known
    return active, known, unknown


def radius_pow2_scale(d2: torch.Tensor, kmask: torch.Tensor):
    """Per-case power-of-two neighborhood radius scale.

    Returns (inv_s, e) with s = 2**e the smallest power of two with
    s**2 >= max d2 over valid neighbors, and inv_s = 2**-e exactly.  Scaling
    the offsets by inv_s keeps every monomial column O(1); being a power of
    two it is exactly invertible (the DOFs transform by s**degree).
    """
    h2 = torch.where(kmask, d2, 0.0).amax(dim=-1)
    e = torch.ceil(0.5 * torch.log2(torch.where(h2 > 0, h2, 1.0)))
    return torch.exp2(-e), e


def neighbor_weights(d2: torch.Tensor, kmask: torch.Tensor,
                     weighting: torch.Tensor) -> torch.Tensor:
    """Fitting weights from squared distances.

    WEIGHT_UNIFORM: w = 1.  WEIGHT_CENTER: w = alpha + beta*(1 - sqrt(d2/max_d2))^2
    normalized by the neighborhood's max squared distance
    (reference: wlsqm/fitter/infra.pyx:668-702 ``Case_make_weights``).
    Padded neighbors (kmask False) get w = 0.
    """
    d2m = torch.where(kmask, d2, 0.0)
    max_d2 = d2m.amax(dim=-1, keepdim=True)
    safe = torch.where(max_d2 > 0, max_d2, 1.0)
    tmp = 1.0 - torch.sqrt(d2m / safe)
    center = WEIGHT_ALPHA + WEIGHT_BETA * tmp * tmp
    w = torch.where(weighting[..., None] == defs.WEIGHT_CENTER, center,
                    torch.ones_like(center))
    return torch.where(kmask, w, 0.0)


# -----------------------------------------------------------------------------
# Prepared state
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Prepared:
    """Cached geometry: basis rows, weights, scaled and factored normal matrices.

    Counterpart of the JAX ``Prepared`` pytree at precision "f64" (reference:
    the prepared Case arrays, wlsqm/fitter/infra.pxd:124-183).  Immutable;
    solving against it is a function of (Prepared, fk, fi).
    """

    c: torch.Tensor            # (B, K, NO) baked basis rows
    w: torch.Tensor            # (B, K) weights; 0 for padded neighbors
    fac: tuple                 # factorization of the scaled masked normal matrix
    row_scale: torch.Tensor    # (B, NO)
    col_scale: torch.Tensor    # (B, NO)
    active: torch.Tensor       # (B, NO) bool
    known: torch.Tensor        # (B, NO) bool
    unknown: torch.Tensor      # (B, NO) bool
    xi: torch.Tensor           # (B, dim) fit origins
    cond_orig: torch.Tensor    # (B,) 2-norm condition numbers (NaN unless debug)
    cond_scaled: torch.Tensor  # (B,)
    ruiz_iters: torch.Tensor   # (B,) equilibration sweeps taken
    dimension: int
    solver: str

    @property
    def ncases(self) -> int:
        return self.c.shape[0]

    @property
    def nk_max(self) -> int:
        return self.c.shape[1]

    @property
    def no_max(self) -> int:
        return self.c.shape[2]


def prepare(
    xk: torch.Tensor,
    nk: torch.Tensor,
    xi: torch.Tensor,
    order: torch.Tensor,
    knowns: torch.Tensor,
    weighting: torch.Tensor,
    *,
    dimension: int,
    NO: int,
    solver: str = solve_ops.SOLVER_CHOLESKY,
    debug: bool = False,
    ruiz_max_iter: int = ruiz_ops.RUIZ_MAX_ITER,
    ruiz_eps: float = ruiz_ops.RUIZ_EPS,
    scaling: str = "ruiz",
) -> Prepared:
    """Build, precondition and factor the normal matrices of a batch
    (reference: wlsqm/fitter/impl.pyx:47-689, make_c → make_A → preprocess_A).
    """
    B, K, _ = xk.shape
    with profiling.span("engine.assemble"):
        kmask = torch.arange(K, device=xk.device)[None, :] < nk[:, None]
        delta = xk - xi[:, None, :]
        # padded slots may hold anything, NaN included; the reference never reads
        # them, so zero them before 0-weight times non-finite can poison a sum
        delta = torch.where(kmask[:, :, None], delta, 0.0)
        d2 = torch.sum(delta * delta, dim=-1)

        c = basis(delta, dimension, NO)
        w = neighbor_weights(d2, kmask, weighting)
        active, known, unknown = dof_masks(order, knowns, dimension, NO)

        # A[j,m] = sum_k w_k c[k,j] c[k,m] over unknown DOFs; identity elsewhere
        # (reference: wlsqm/fitter/impl.pyx:566-602 make_A)
        A_full = torch.einsum("bkj,bkm->bjm", c * w[..., None], c)
        unk2 = unknown[:, :, None] & unknown[:, None, :]
        eye = torch.eye(NO, dtype=xk.dtype, device=xk.device)
        A = (torch.where(unk2, A_full, 0.0)
             + torch.where(unknown, 0.0, 1.0)[:, :, None] * eye)

    with profiling.span("engine.ruiz"):
        if scaling == "jacobi":
            row_scale, col_scale, ruiz_iters = ruiz_ops.jacobi_scale(A)
        elif scaling == "ruiz":
            row_scale, col_scale, ruiz_iters = ruiz_ops.ruiz_scale(
                A, max_iter=ruiz_max_iter, eps=ruiz_eps)
        else:
            raise ValueError("scaling must be 'ruiz' or 'jacobi'; got %r" % (scaling,))
        A_scaled = ruiz_ops.apply_scaling(A, row_scale, col_scale)

    if debug:
        cond_orig = solve_ops.cond_2norm(A)
        cond_scaled = solve_ops.cond_2norm(A_scaled)
    else:
        cond_orig = torch.full((B,), torch.nan, dtype=xk.dtype, device=xk.device)
        cond_scaled = cond_orig

    with profiling.span("engine.factor"):
        fac = solve_ops.factor(A_scaled, solver)
    return Prepared(
        c=c, w=w, fac=fac,
        row_scale=row_scale, col_scale=col_scale,
        active=active, known=known, unknown=unknown, xi=xi,
        cond_orig=cond_orig, cond_scaled=cond_scaled, ruiz_iters=ruiz_iters,
        dimension=dimension, solver=solver,
    )


# -----------------------------------------------------------------------------
# Solving
# -----------------------------------------------------------------------------

def _rhs(prep: Prepared, resid: torch.Tensor) -> torch.Tensor:
    """Row-scaled, masked RHS b_j = rs_j * sum_k w_k resid_k c[k,j];
    resid (B, K) or, for F fields, (F, B, K)."""
    b = torch.einsum("bkj,...bk->...bj", prep.c * prep.w[..., None], resid)
    return torch.where(prep.unknown, b * prep.row_scale, 0.0)


def _matvec_scaled(prep: Prepared, x: torch.Tensor) -> torch.Tensor:
    """A_scaled @ x through the basis rows (no stored A), x (B, NO, m).

    A_scaled = diag(rs)·(CᵀWC masked to unknowns)·diag(cs) + I on the rest:
    two O(K·NO) contractions per right-hand side instead of a stored matrix.
    """
    xs = torch.where(prep.unknown[..., :, None], x * prep.col_scale[..., :, None], 0.0)
    t = torch.einsum("bkj,bjm->bkm", prep.c, xs) * prep.w[..., :, None]
    y = torch.einsum("bkj,bkm->bjm", prep.c, t) * prep.row_scale[..., :, None]
    return torch.where(prep.unknown[..., :, None], y, x)


def cond_estimate(prep: Prepared, iters: int = 20) -> torch.Tensor:
    """Cheap per-case 2-norm condition estimates of the scaled matrices.

    Port of the JAX package's ``engine.cond_estimate``: ``iters`` rounds of
    batched power iteration for λmax (through the basis rows,
    :func:`_matvec_scaled`) and of inverse iteration for 1/λmin (through the
    stored factor), from the same deterministic start vector, so it needs no
    debug mode and no SVD (reference: the debug-mode SVD conditions,
    wlsqm/fitter/impl.pyx:661-682).  An estimate from below, typically
    within a few percent for SPD spectra.  Returns (B,) estimates of
    cond₂(A_scaled).
    """
    B, n = prep.active.shape
    dtype, device = prep.row_scale.dtype, prep.row_scale.device
    # a dense start vector, unlikely to be orthogonal to the extremal
    # eigenvectors
    v0 = torch.cos(torch.arange(n, dtype=dtype, device=device) * 0.7) + 0.3
    v0 = v0.expand(B, n)[..., None]

    def norm(x):
        return torch.sqrt(torch.sum(x * x, dim=(-2, -1), keepdim=True))

    v = v0
    for _ in range(iters):
        w = _matvec_scaled(prep, v)
        v = w / norm(w).clamp_min(1e-300)
    lmax = norm(_matvec_scaled(prep, v))[..., 0, 0]
    u = v0
    for _ in range(iters):
        w = solve_ops.solve_factored(prep.fac, u, prep.solver)
        u = w / norm(w).clamp_min(1e-300)
    inv_lmin = norm(solve_ops.solve_factored(prep.fac, u, prep.solver))[..., 0, 0]
    return lmax * inv_lmin


def _solve(prep: Prepared, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for b (B, NO), or (F, B, NO) as ONE multi-RHS solve."""
    if b.ndim == 2:
        return solve_ops.solve_factored(prep.fac, b[..., None], prep.solver)[..., 0]
    x = solve_ops.solve_factored(prep.fac, b.permute(1, 2, 0), prep.solver)
    return x.permute(2, 0, 1)


def solve_prepared(prep: Prepared, fk: torch.Tensor, fi: torch.Tensor,
                   do_sens: bool = False):
    """Fit the model against data ``fk`` using prepared geometry.

    fk (B, K) with fi (B, NO), or F fields at once: fk (F, B, K) with fi
    (F, B, NO), solved as one multi-RHS solve against the one factor.
    Returns (fi_out, sens).  ``sens[b,k,j] = d fi[b,j] / d fk[b,k]`` for
    unknown DOFs, NaN for known DOFs, 0 for inactive padding
    (reference: wlsqm/fitter/impl.pyx:768-846); None unless ``do_sens``.
    It depends on the geometry alone, so F fields share one (B, K, NO)
    array, expanded (a view) to (F, B, K, NO).  Adds F (1 for fk (B, K))
    to the counter ``engine.solve_fields``; the iterative solve counts
    through its first call here.
    """
    profiling.count("engine.solve_fields", fk.shape[0] if fk.ndim == 3 else 1)
    with profiling.span("engine.solve"):
        known_vals = torch.where(prep.known, fi, 0.0)
        model_known = torch.einsum("bkj,...bj->...bk", prep.c, known_vals)
        # mask padded-neighbor slots (w == 0) so non-finite fk padding is inert
        resid = torch.where(prep.w > 0, fk - model_known, 0.0)
        x = _solve(prep, _rhs(prep, resid))
        fi_out = torch.where(prep.unknown, x * prep.col_scale, fi)

        sens = None
        if do_sens:
            # all-nk multi-RHS triangular solves in one shot
            S = (prep.c * prep.w[..., None]).transpose(-1, -2)        # (B, NO, K)
            S = torch.where(prep.unknown[..., None], S * prep.row_scale[..., None], 0.0)
            X = solve_ops.solve_factored(prep.fac, S, prep.solver)    # (B, NO, K)
            sens = X.transpose(-1, -2) * prep.col_scale[..., None, :]  # (B, K, NO)
            sens = torch.where(prep.unknown[..., None, :], sens, 0.0)
            sens = torch.where(prep.known[..., None, :], torch.nan, sens)
            if fk.ndim == 3:
                sens = sens.expand(fk.shape[0], *sens.shape)
    return fi_out, sens


def solve_iterative_prepared(prep: Prepared, fk: torch.Tensor, fi: torch.Tensor,
                             max_iter: int, do_sens: bool = False,
                             fixed_trip: bool = False):
    """Fit with iterative refinement (ALGO_ITERATIVE).

    Follows the reference (reference: wlsqm/fitter/impl.pyx:986-1083
    ``solve_iterative``): before each corrective fit, evaluate the model at
    the data points, take the l∞ residual norm over valid neighbors, and stop
    on *exact* norm stagnation (norm == previous norm) or after ``max_iter``
    corrective fits.  Sensitivities come from the initial solve only.

    The loop form reads ``done.all()`` on the host after every trip and
    stops when every case has stagnated.  ``fixed_trip=True`` runs exactly
    ``max_iter`` masked trips with no host read (the JAX package's
    ``lax.scan`` form): stagnated cases are masked, so the DOFs and counts
    are bit-identical to the loop form, and trips past all-stagnation are
    no-ops.  Autograd differentiates either form here.

    Returns (fi_out, sens, iterations) with per-case iteration counts; fk
    (F, B, K) solves F fields as :func:`solve_prepared` does, with counts
    (F, B).
    """
    fi_cur, sens = solve_prepared(prep, fk, fi, do_sens)
    with profiling.span("engine.solve"):
        kmask = prep.w > 0
        shape = fk.shape[:-1]
        done = torch.zeros(shape, dtype=torch.bool, device=fk.device)
        prev_norm = torch.full(shape, -1.0, dtype=fk.dtype, device=fk.device)
        iters = torch.zeros(shape, dtype=torch.int32, device=fk.device)
        for _ in range(max_iter):
            if not fixed_trip and bool(done.all()):
                break
            coeffs = torch.where(prep.active, fi_cur, 0.0)
            model = torch.einsum("bkj,...bj->...bk", prep.c, coeffs)
            resid = torch.where(kmask, fk - model, 0.0)
            norm = resid.abs().amax(dim=-1)
            done = done | (norm == prev_norm)

            dx = _solve(prep, _rhs(prep, resid))
            fi_new = torch.where(prep.unknown, fi_cur + dx * prep.col_scale, fi_cur)
            fi_cur = torch.where(done[..., None], fi_cur, fi_new)
            iters = iters + (~done).to(torch.int32)
            prev_norm = norm
    return fi_cur, sens, iters


# -----------------------------------------------------------------------------
# One-shot fit (prepare + solve)
# -----------------------------------------------------------------------------

def fit_batch(
    xk: torch.Tensor,
    fk: torch.Tensor,
    nk: torch.Tensor,
    xi: torch.Tensor,
    fi: torch.Tensor,
    order: torch.Tensor,
    knowns: torch.Tensor,
    weighting: torch.Tensor,
    *,
    dimension: int,
    NO: int,
    do_sens: bool = False,
    iterative: bool = False,
    max_iter: int = 10,
    solver: str = solve_ops.SOLVER_CHOLESKY,
    debug: bool = False,
    ruiz_max_iter: int = ruiz_ops.RUIZ_MAX_ITER,
    ruiz_eps: float = ruiz_ops.RUIZ_EPS,
    scaling: str = "ruiz",
    fixed_trip: bool = False,
):
    """Fit a batch of local models end to end, in float64.

    Returns (fi_out, sens, iterations, cond_scaled); ``sens`` is an empty
    tensor unless ``do_sens``.  ``fixed_trip`` as for
    :func:`solve_iterative_prepared`.  The batched equivalent of the reference's
    ``generic_fit_{basic,iterative}_many_parallel`` call stacks (reference:
    wlsqm/fitter/simple.pyx:953-1171): the OpenMP prange becomes the batch axis.
    """
    prep = prepare(
        xk, nk, xi, order, knowns, weighting,
        dimension=dimension, NO=NO, solver=solver, debug=debug,
        ruiz_max_iter=ruiz_max_iter, ruiz_eps=ruiz_eps, scaling=scaling,
    )
    if iterative:
        fi_out, sens, iters = solve_iterative_prepared(prep, fk, fi, max_iter, do_sens,
                                                       fixed_trip=fixed_trip)
    else:
        fi_out, sens = solve_prepared(prep, fk, fi, do_sens)
        iters = torch.zeros(fk.shape[0], dtype=torch.int32, device=fk.device)
    if sens is None:
        sens = fk.new_zeros((0,))
    return fi_out, sens, iters, prep.cond_scaled
