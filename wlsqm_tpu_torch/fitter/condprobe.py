"""Accuracy probe and certification gates for automatic kernel routing.

Port of :mod:`wlsqm_tpu.fitter.condprobe`.  The fit kernels solve the
radius-prescaled, Jacobi-scaled normal equations; their worst-case relative
DOF error against a correct f64 fit follows

    err_max  ~=  unit * cond2(A_jacobi) * inv_s**order

where ``inv_s = 2**-e`` is the kernels' power-of-two radius prescale (> 1
for sub-unit neighborhoods).  ``cond2(A_jacobi)`` is what the Jacobi
preconditioner cannot remove (it is invariant under the radius prescale, so
it can be probed on the raw geometry); ``inv_s**order`` is the exact DOF
de-scaling, which multiplies the solve's absolute error in the scaled space.
The model does not depend on the arithmetic: the TPU package certifies three
emulated arithmetics with it, this package one, FP64, whose ``unit`` is
measured per device kind (:mod:`wlsqm_tpu_torch.fitter.calibration`).

Two sources feed the gates:

* the sampled probe (:func:`probe`): the exact ``cond2`` on a
  deterministic sample of cases, whose normal matrices are assembled and
  whose eigenvalues are taken in FP64 where the geometry lies; only the
  sample's (cond, amp) reach the host, in one copy;
* the per-case key ``est >= cond2 * amp`` that the CUDA kernels emit with
  ``emit_cond=True`` for EVERY case (:func:`est_certified_edges`,
  :func:`split_partition_choice`).  :func:`cond_key` computes the same key
  with library calls; it is the kernels' yardstick and the tests' oracle,
  and nothing on a fit's path calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import defs, engine
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows
from wlsqm_tpu_torch.utils import profiling

#: routing bar: predicted error above this is not certified
AUTO_TOL = 1e-10

#: multiplier on the predicted error to absorb the scatter around the model
SAFETY = 4.0

#: default number of sampled cases per probe
SAMPLE = 256

#: number of screen-selected worst cases appended to the probe sample
#: (per screen criterion)
SCREEN_TOP = 64

#: unit roundoff of the factor that preconditions the kernels' residual
#: sweeps: each sweep contracts the error by ~F32_UNIT * cond.  The name is
#: the JAX package's, whose factor is f32; here the factor is FP64.
F32_UNIT = 2.0 ** -53

#: in-kernel residual sweeps of every kernel route.  One sweep is converged
#: at any certifiable conditioning: (F32_UNIT * cond)**2 is under 1e-16 up
#: to cond 1e8, far past every certified edge.
REFINE_STEPS = fit_kernel.DEFAULT_REFINE_STEPS


def _sample_idx(B: int, sample: int) -> np.ndarray:
    """Deterministic sample covering the batch (first/last included).

    For large batches the sample grows with B (up to 4x the default) so the
    coverage density does not collapse; the worst-case screen
    (:func:`_screen_math`) separately pins outliers that any spaced sample
    could miss.
    """
    if B <= sample:
        return np.arange(B)
    sample = max(sample, min(4 * SAMPLE, B // 64))
    return np.unique(np.linspace(0, B - 1, sample).astype(np.int64))


def _screen_math(xk, nk, xi, order_b, dimension: int):
    """Full-batch O(B*K) screen on the device: per-case (amp, aniso).

    ``amp = max(inv_s, 1)**order`` is the exact radius de-scale
    amplification of the kernel's error (tiny neighborhoods are the #1
    accuracy hazard); ``aniso = det(M) / (trace(M)/dim)**dim`` of the
    mask-normalized neighbor second-moment matrix ``M`` is a scale-free
    degeneracy proxy that approaches 0 for collinear/coplanar neighborhoods
    (which make A near-singular at any radius).  Closed-form determinants.
    """
    B, K, dim = xk.shape
    delta = xk - xi[:, None, :]
    kmask = torch.arange(K, device=xk.device)[None, :] < nk[:, None]
    delta = torch.where(kmask[:, :, None], delta, 0.0)
    h2 = (delta ** 2).sum(-1).amax(-1)
    inv_s, _ = engine.radius_pow2_scale((delta ** 2).sum(-1), kmask)
    amp = torch.clamp_min(inv_s, 1.0) ** order_b
    # degenerate-radius cases (all neighbors on top of xi) are caught by
    # the aniso channel: force them to the worst ranking
    u = delta / torch.sqrt(torch.where(h2 > 0, h2, 1.0))[:, None, None]
    denom = nk.clamp_min(1).to(xk.dtype)[:, None, None]
    M = (u[:, :, :, None] * u[:, :, None, :]).sum(dim=1) / denom   # (B, d, d)
    if dim == 1:
        det = tr = M[:, 0, 0]
    elif dim == 2:
        det = M[:, 0, 0] * M[:, 1, 1] - M[:, 0, 1] * M[:, 1, 0]
        tr = (M[:, 0, 0] + M[:, 1, 1]) / 2.0
    else:
        det = (M[:, 0, 0] * (M[:, 1, 1] * M[:, 2, 2] - M[:, 1, 2] * M[:, 2, 1])
               - M[:, 0, 1] * (M[:, 1, 0] * M[:, 2, 2] - M[:, 1, 2] * M[:, 2, 0])
               + M[:, 0, 2] * (M[:, 1, 0] * M[:, 2, 1] - M[:, 1, 1] * M[:, 2, 0]))
        tr = (M[:, 0, 0] + M[:, 1, 1] + M[:, 2, 2]) / 3.0
    aniso = det / tr.clamp_min(1e-300) ** dim
    return amp, torch.where(h2 > 0, aniso, 0.0)


def _screened_idx(xk, nk, xi, order, dimension: int, sample: int) -> np.ndarray:
    """Probe sample = spaced coverage + the screened worst cases.

    The spaced sample alone can miss a sparse subset of pathological cases
    (tiny radius, degenerate geometry) in a large batch; the O(B*K) screen
    ranks ALL cases by the two cheap hazard proxies on the device and
    appends the top :data:`SCREEN_TOP` of each, so the exact-cond gate always
    sees the worst candidates.  Only those indices reach the host.
    """
    B = xk.shape[0]
    base = _sample_idx(B, sample)
    if B <= len(base):
        return base
    with profiling.span("condprobe.screen"):
        order_b = config.as_tensor(order, xk.device).expand(B)
        amp, aniso = _screen_math(xk, nk, xi, order_b, dimension)
        ntop = min(SCREEN_TOP, B)
        worst_amp = torch.topk(amp, ntop).indices
        worst_deg = torch.topk(aniso, ntop, largest=False).indices
        return np.unique(np.concatenate([base, worst_amp.cpu().numpy(),
                                         worst_deg.cpu().numpy()]))


def _geometry(xk, nk, xi, device):
    """xk, nk, xi as tensors on ``device`` (None: where the tensor ``xk``
    lies); nk = K for every case if None."""
    if device is None:
        device = xk.device
    xk = config.as_tensor(xk, device)
    if xk.ndim == 2:
        xk = xk[..., None]
    B, K, _ = xk.shape
    xi = config.as_tensor(xi, device).reshape(B, -1)
    nk = (torch.full((B,), K, dtype=torch.int32, device=device) if nk is None
          else config.as_tensor(nk, device, torch.int32))
    return xk, nk, xi


def cond_key(xk, nk, xi, *, dimension: int, order: int, knowns: int = 0,
             weighting: int = defs.WEIGHT_UNIFORM, device=None):
    """Reference implementation of the per-case certification key.

    ``est_i = ||A_jac||_inf ||A_jac^{-1}||_F * amp_i  >=  cond_2(A_jac) *
    amp_i`` of case i's Jacobi-scaled normal system (known DOFs as identity
    rows and columns) — the formula the CUDA kernels emit per case with
    ``emit_cond=True`` — as batched FP64 library calls on the device
    (``torch.linalg.cholesky_ex`` and two ``solve_triangular``).  It exists
    for the tests and as the kernels' yardstick; a fit's path always takes
    the in-kernel value.  NaN for degenerate geometry (safe: NaN compares
    False against any threshold, so such cases never certify).  Tensors on
    their own device by default; NumPy input goes to ``device``.
    """
    if device is not None or not isinstance(xk, torch.Tensor):
        device = config.resolve_device(device, xk)
    xk, nk, xi = _geometry(xk, nk, xi, device)
    delta, kmask, _, inv_s = fit_kernel._prescale(xk, nk, xi)
    d = delta * inv_s[:, None, None]
    C = fit_rows.basis_rows(d, dimension, order)
    w = engine.neighbor_weights((d * d).sum(-1), kmask,
                                torch.tensor(int(weighting), device=xk.device))
    A = (C * w[..., None]).mT @ C
    KN = fit_rows.known_dofs(knowns, dimension, order)
    if KN:
        A[:, KN, :] = 0.0
        A[:, :, KN] = 0.0
        A[:, KN, KN] = 1.0
    dg = torch.rsqrt(torch.diagonal(A, dim1=-2, dim2=-1).clamp_min(1e-30))
    As = A * dg[:, :, None] * dg[:, None, :]
    L, info = torch.linalg.cholesky_ex(As)
    key = fit_kernel.cond_key_from_factor(As, L)
    key = torch.where(info == 0, key, torch.nan)
    return key * fit_kernel.cond_amp_factor(inv_s, order)


def _sampled_int(v, idx, sel, device):
    """A per-case int (order or weighting; scalar or (B,)) at the sampled
    cases, as an int32 tensor on ``device``, and its maximum as an int.

    A host value is indexed on the host and sent without a wait; a device
    tensor is gathered where it lies, and its maximum costs one read."""
    n = len(idx)
    if isinstance(v, torch.Tensor) and v.device.type != "cpu":
        v = v.to(device=device, dtype=torch.int32)
        v = v.expand(n) if v.ndim == 0 else v[sel]
        return v, None
    a = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.int32)
    if a.ndim == 0:
        return torch.full((n,), int(a), dtype=torch.int32, device=device), int(a)
    a = np.ascontiguousarray(a[idx])
    return torch.from_numpy(a).to(device, non_blocking=True), int(a.max())


def _cond2(As):
    """(b,) spectral condition numbers of a batch of symmetric matrices (the
    lower triangle read), as ``np.linalg.cond`` gives them: the extreme
    eigenvalue magnitudes' ratio, inf for a singular matrix (0/0 included),
    NaN for one that is not finite (the solver refuses such input).  The
    symmetric eigensolver, not the SVD: on the H100 it takes the probe's
    1,152 matrices of 15 x 15 in a third of the time, with one host check
    of its flags where the SVD makes two."""
    finite = torch.isfinite(As).all(-1).all(-1)
    lam = torch.linalg.eigvalsh(torch.where(finite[:, None, None], As, 0.0)).abs()
    cond = lam.amax(-1) / lam.amin(-1)
    cond = torch.where(torch.isnan(cond), torch.inf, cond)
    return torch.where(finite, cond, torch.nan)


def _cond_amp(xk, nk, xi, order, weighting, *, dimension: int,
              knowns: int = 0, sample: int = SAMPLE):
    """Per-sampled-case (cond2(A_jacobi), inv_s**order) NumPy arrays.

    xk (B, K, dim) | nk (B,) or None | xi (B, dim) | order scalar or (B,) |
    weighting scalar or (B,).  The sample is the spaced coverage plus the
    full-batch screen's worst candidates (:func:`_screened_idx`), so sparse
    pathological cases in a large batch cannot fall between sample points.
    The sample is gathered, its Jacobi-scaled normal matrices assembled and
    their cond2 taken in FP64 where the geometry lies (NumPy input: on the
    CPU); the two results reach the host in one copy.  The matrices are
    those of the prescaled plain-monomial basis (as :func:`cond_key`): the
    Jacobi scaling removes every column scale, the power-of-two prescale and
    the 1/m! factors alike.  Raises ``np.linalg.LinAlgError`` when a sampled
    case's matrix is not finite.
    """
    xk, nk, xi = _geometry(xk, nk, xi,
                           None if isinstance(xk, torch.Tensor) else "cpu")
    idx = _screened_idx(xk, nk, xi, order, dimension, sample)
    device = xk.device

    with profiling.span("condprobe.host_copy"):
        sel = torch.from_numpy(idx).to(device, non_blocking=True)
        xk_s, xi_s, nk_s = xk[sel], xi[sel], nk[sel]
        order_s, omax = _sampled_int(order, idx, sel, device)
        weighting_s, _ = _sampled_int(weighting, idx, sel, device)
        if omax is None:
            omax = int(order_s.max())

    with profiling.span("condprobe.assemble"):
        NO = defs.number_of_dofs(dimension, omax)
        delta, kmask, _, inv_s = fit_kernel._prescale(xk_s, nk_s, xi_s)
        d = delta * inv_s[:, None, None]
        C = fit_rows.basis_rows(d, dimension, omax)
        w = engine.neighbor_weights((d * d).sum(-1), kmask, weighting_s)
        A = (C * w[..., None]).mT @ C
        # inactive (lower order) and known DOFs: identity rows and columns
        kn = torch.full((len(idx),), int(knowns), dtype=torch.int64, device=device)
        live = engine.dof_masks(order_s, kn, dimension, NO)[2]
        A = (torch.where(live[:, :, None] & live[:, None, :], A, 0.0)
             + torch.diag_embed((~live).to(A.dtype)))
        diag = torch.diagonal(A, dim1=-2, dim2=-1)
        s = 1.0 / torch.sqrt(torch.where(diag > 0, diag, 1.0))
        As = A * s[:, :, None] * s[:, None, :]

    with profiling.span("condprobe.svd"):
        cond = _cond2(As)
        amp = fit_kernel.cond_amp_factor(inv_s, order_s.to(inv_s.dtype))
        cond, amp = torch.stack((cond, amp)).cpu().numpy()
    if np.isnan(cond).any():
        raise np.linalg.LinAlgError("the probe's sample holds non-finite geometry")
    return cond, amp


def probe(xk, nk, xi, order, weighting, *, dimension: int,
          knowns: int = 0, sample: int = SAMPLE):
    """Run the geometry probe once; returns (cond, amp) sample arrays.

    Feed the result to :func:`accuracy_ok_from` / :func:`pick_from` so one
    sampled pass serves both the routing gate and the sweep-count
    choice.  Returns None on degenerate geometry (singular samples) —
    treat as "route to the engine".
    """
    try:
        return _cond_amp(xk, nk, xi, order, weighting, dimension=dimension,
                         knowns=knowns, sample=sample)
    except (ValueError, np.linalg.LinAlgError):
        return None


def _units():
    """Active per-device calibration record (units + regime thresholds).

    Routing decisions go through the calibration store so each device kind
    uses ITS measured units — or, uncalibrated, gets the certification gates
    refused (:mod:`wlsqm_tpu_torch.fitter.calibration`).
    """
    from wlsqm_tpu_torch.fitter import calibration

    return calibration.active()


def accuracy_ok_from(cond_amp, tol: float = AUTO_TOL,
                     assembly: str = "rows") -> bool:
    """Certification gate on a precomputed :func:`probe` result.

    True means EVERY sampled case's kernel error is predicted under ``tol``
    by the worst-case per-case envelope of that kernel body (``assembly``:
    "rows" or "moments"), with :data:`SAFETY` applied.  Always False on
    hardware without an accuracy calibration record.
    """
    if cond_amp is None:
        return False
    u = _units()
    if not u.certified:
        return False
    _, cert = u.units_for(assembly)
    cond, amp = cond_amp
    return float(cert * (cond * amp).max()) * SAFETY <= tol


def predicted_error(cond, amp, refine_steps: int, assembly: str = "rows"):
    """Kernel error model at ``refine_steps`` sweeps after the solve.

    Two regimes: the converged floor ``unit * cond`` (the device's central
    unit for that body), and the not-yet-converged refinement term
    ``(F32_UNIT * cond)**(n+1)`` (the factor contracts the error by
    ~F32_UNIT*cond per sweep, from an initial solve error of the same size).
    The radius de-scale amplifies whichever dominates.
    """
    unit, _ = _units().units_for(assembly)
    rate = F32_UNIT * cond
    return np.maximum(unit * cond, rate ** (refine_steps + 1)) * amp


def kernel_accuracy_ok(xk, nk, xi, order, weighting, *, dimension: int,
                       knowns: int = 0, tol: float = AUTO_TOL,
                       sample: int = SAMPLE) -> bool:
    """Whether auto routing may send this batch to a kernel with a
    CERTIFIED ≤``tol`` result, in either body.  The ladder picks which."""
    cond_amp = probe(xk, nk, xi, order, weighting, dimension=dimension,
                     knowns=knowns, sample=sample)
    return (accuracy_ok_from(cond_amp, tol=tol, assembly="moments")
            or accuracy_ok_from(cond_amp, tol=tol, assembly="rows"))


def pick_from(cond_amp, tol: float = AUTO_TOL, assembly: str = "rows") -> int:
    """Sweep-count choice on a precomputed :func:`probe` result: the
    kernels' default (:data:`REFINE_STEPS` says why one count serves)."""
    return REFINE_STEPS


def pick_refine_steps(xk, nk, xi, order, weighting, *, dimension: int,
                      knowns: int = 0, tol: float = AUTO_TOL,
                      sample: int = SAMPLE) -> int:
    """Sweep count for a batch: :func:`pick_from`, which needs no probe."""
    return pick_from(None, tol=tol)


def pick_steps_at_edge(ca_edge: float, tol: float = AUTO_TOL,
                       assembly: str = "moments") -> int:
    """Sweep count converged for every case under ``ca_edge``: :func:`pick_from`."""
    return pick_from(None, tol=tol, assembly=assembly)


def pick_ts_from(cond_amp, tol: float = AUTO_TOL, assembly: str = "rows") -> int:
    """The JAX package's sweep count of its triple-single rung; the port has
    one arithmetic, so this is :func:`pick_from`."""
    return pick_from(cond_amp, tol=tol, assembly=assembly)


def est_certified_edges(tol: float = AUTO_TOL) -> dict:
    """Per-case key certification edges of the two kernel bodies.

    ``{"moments": edge, "rows": edge}`` — the largest per-case key (the
    kernel's ``emit_cond`` output; :func:`cond_key` is the same formula) at
    which that body's calibrated envelope stays under ``tol`` with
    :data:`SAFETY` applied; ``None`` entries for uncalibrated bodies, ``{}``
    when the device record is uncertified.  A batch whose exact key maximum
    sits under an edge is per-case certified for that body as a whole —
    which the sampled probe cannot give (it can miss the true maximum).
    """
    u = _units()
    if not u.certified:
        return {}
    return {name: (tol / (SAFETY * unit) if unit else None)
            for name, unit in (("moments", u.est_f64_cert_unit_m),
                               ("rows", u.est_f64_cert_unit))}


def data_edges(tol: float = AUTO_TOL) -> dict:
    """Per-case edges of the data gate, ``{"moments": edge, "rows": edge}``.

    A case certifies when its kernel-emitted key times its data scale
    (:func:`wlsqm_tpu_torch.fitter.calibration.data_ratio`: max|fk| over
    max(|fi|, 1)) is at most the body's edge: the record's data-scale unit
    bounds err / max(|fi|, 1) by ``unit * key * max|fk| / max(|fi|, 1)`` over
    every field of its sweep, where the key alone (:func:`est_certified_edges`)
    holds only for fields whose DOFs are large beside their values.
    ``None`` entries for a body without a data unit, ``{}`` when the device
    record is uncertified.
    """
    u = _units()
    if not u.certified:
        return {}
    return {name: (tol / (SAFETY * unit) if unit else None)
            for name, unit in (("moments", u.data_unit_m), ("rows", u.data_unit))}


def split_partition_choice(tol: float = AUTO_TOL, assembly: str = "moments"):
    """The certified partition of the per-case split, or None.

    Returns ``(kernel_precision, est_edge)``: the arithmetic (always "f64")
    and the per-case key threshold ``est <= est_edge`` below which the
    ``assembly`` body's error is certified under ``tol``.  None when the
    device record carries no key calibration for that body (split route
    disabled) or is uncertified.
    """
    edge = est_certified_edges(tol).get(assembly)
    return ("f64", edge) if edge else None
