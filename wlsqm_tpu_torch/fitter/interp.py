"""Interpolation of a fitted surrogate model and its derivatives.

Port of :mod:`wlsqm_tpu.fitter.interp`.  Because the baked basis satisfies
``∂^m (d**e/e!) = d**(e-m)/(e-m)!``, the ``diff``-th derivative of the model
is the baked basis contracted with a 0/1-projected coefficient vector
(:func:`wlsqm_tpu_torch.fitter.tables.diff_projection`; reference:
wlsqm/fitter/interp.pyx:316-932).  Derivatives of order higher than the
model order are identically zero (reference: wlsqm/fitter/interp.pyx:686-692).

``interpolate_fit`` / ``lambdify_fit`` mirror the reference's Python API
(reference: wlsqm/fitter/interp.pyx:34-239) and return NumPy arrays;
``eval_fit``, ``interpolate_many`` and ``interpolate_continuous`` return
float64 tensors.  Every function computes on ``device``: the card unless
``device="cpu"`` (:func:`config.resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import defs, tables
from wlsqm_tpu_torch.fitter.engine import basis

__all__ = ["interpolate_fit", "lambdify_fit", "eval_fit", "interpolate_many",
           "interpolate_continuous"]


def _projected(fi, dimension, order, diff, device):
    """The baked coefficients of the ``diff``-th derivative, (..., no)."""
    no = defs.number_of_dofs(dimension, order)
    P = torch.as_tensor(tables.diff_projection(dimension, diff)[:no, :no], device=device)
    return config.as_tensor(fi, device)[..., :no] @ P.T


def eval_fit(fi, xi, x, *, dimension: int, order: int, diff: int = 0, device=None):
    """Evaluate the ``diff``-th derivative of a fitted model at points ``x``.

    fi: (..., no) baked coefficients; xi: (..., dim) origin; x: (..., n, dim)
    query points.  Batch axes of fi/xi/x broadcast.  Returns (..., n).
    """
    device = config.resolve_device(device, fi, xi, x)
    no = defs.number_of_dofs(dimension, order)
    coeff = _projected(fi, dimension, order, diff, device)
    delta = config.as_tensor(x, device) - config.as_tensor(xi, device)[..., None, :]
    c = basis(delta, dimension, no)                                  # (..., n, no)
    return torch.einsum("...nj,...j->...n", c, coeff)


def interpolate_many(fi, xi, x, *, dimension: int, order: int, diff: int = 0,
                     device=None):
    """Batched per-case interpolation: case b's model evaluated at x[b].

    fi (B, no), xi (B, dim), x (B, n, dim) -> (B, n).
    """
    return eval_fit(fi, xi, x, dimension=dimension, order=order, diff=diff,
                    device=device)


def interpolate_continuous(fi, xi, x, r, *, dimension: int, order: int,
                           diff: int = 0, valid=None, block_q: int = 256,
                           block_b: int = 2048, device=None):
    """Continuous patched-model interpolation on the device.

    Blends every local model whose origin lies within radius ``r`` of the
    query point, weighted by ``(1 - sqrt(d²/r²))²`` (zero at r), the
    reference's 'continuous' mode (reference: wlsqm/fitter/expert.pyx:898-986),
    with the radius test a mask over a blocked brute-force distance sweep.

    fi (B, no) | xi (B, dim) | x (Q, dim) | r scalar.
    valid: optional (B,) bool — models to include.
    Returns (num, den): the weighted sum and total weight per query; the
    blended value is ``num / den`` (NaN where no model is in range).
    """
    device = config.resolve_device(device, fi, xi, x)
    no = defs.number_of_dofs(dimension, order)
    coeff = _projected(fi, dimension, order, diff, device)           # (B, no)
    xi = config.as_tensor(xi, device)
    x = config.as_tensor(x, device)
    B, Q = xi.shape[0], x.shape[0]
    vmask = (torch.ones((B,), dtype=torch.bool, device=device) if valid is None
             else config.as_tensor(valid, device, torch.bool))
    r2 = torch.as_tensor(r, dtype=x.dtype, device=device) ** 2
    nums, dens = [], []
    for q0 in range(0, Q, block_q):
        xq = x[q0:q0 + block_q]
        num = x.new_zeros(xq.shape[0])
        den = x.new_zeros(xq.shape[0])
        for b0 in range(0, B, block_b):
            sl = slice(b0, b0 + block_b)
            delta = xq[:, None, :] - xi[None, sl, :]
            vals = torch.einsum("qbj,bj->qb", basis(delta, dimension, no), coeff[sl])
            d2 = torch.sum(delta * delta, -1)
            t = 1.0 - torch.sqrt(torch.clamp(d2 / r2, max=1.0))
            w = torch.where(vmask[None, sl], t * t, 0.0)
            num = num + torch.sum(w * vals, -1)
            den = den + torch.sum(w, -1)
        nums.append(num)
        dens.append(den)
    empty = x.new_zeros(0)
    return torch.cat(nums) if nums else empty, torch.cat(dens) if dens else empty


def interpolate_fit(xi, fi, dimension: int, order: int, x, diff: int = 0, *,
                    device=None):
    """Interpolate the fit (or one of its derivatives) to given points.

    Drop-in equivalent of the reference API
    (reference: wlsqm/fitter/interp.pyx:34-143).

    xi   : fit origin — (x0,y0[,z0]) array in 2D/3D, scalar in 1D
    fi   : fit coefficients as output by the fitting functions
    order: surrogate polynomial order used in the fit
    x    : query points, (n, dim) in 2D/3D or (n,)/scalar in 1D
    diff : i1_*/i2_*/i3_* DOF constant selecting which derivative to evaluate

    Returns a rank-1 NumPy array of values at each x.
    """
    if dimension not in (1, 2, 3):
        raise ValueError("dimension must be 1, 2 or 3; got %s" % (dimension,))
    if order not in (0, 1, 2, 3, 4):
        raise ValueError("order must be 0, 1, 2, 3 or 4; got %s" % (order,))
    size = tables.EXPONENTS[dimension].shape[0]
    if not (0 <= diff < size):
        raise ValueError("invalid diff %s for dimension %d" % (diff, dimension))

    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    if dimension == 1:
        xq = x.reshape(-1, 1)
        xi_arr = np.array([np.float64(xi)])
    else:
        xq = x.reshape(-1, dimension)
        xi_arr = np.asarray(xi, dtype=np.float64)[:dimension]
    vals = eval_fit(np.asarray(fi, dtype=np.float64), xi_arr, xq,
                    dimension=dimension, order=order, diff=diff, device=device)
    return vals.cpu().numpy()


def lambdify_fit(xi, fi, dimension, order, diff=0, *, device=None):
    """Create a vectorized Python lambda interpolating a fitted model.

    Mirrors the reference API (reference: wlsqm/fitter/interp.pyx:146-239):
    3D -> model(x, y, z); 2D -> model(x, y); 1D -> model(x).  Arguments may
    be scalars or same-shaped arrays (scalars broadcast).
    """
    if dimension not in (1, 2, 3):
        raise ValueError("dimension must be 1, 2 or 3; got %s" % (dimension,))
    if order not in (0, 1, 2, 3, 4):
        raise ValueError("order must be 0, 1, 2, 3 or 4; got %s" % (order,))

    if dimension == 1:
        def model(x):
            return interpolate_fit(xi, fi, 1, order, np.atleast_1d(x), diff,
                                   device=device)
        return model

    def model(*coords):
        if len(coords) != dimension:
            raise ValueError("model() expects %d coordinate arguments, got %d"
                             % (dimension, len(coords)))
        arrs = np.broadcast_arrays(*[np.atleast_1d(c) for c in coords])
        shp = arrs[0].shape
        pts = np.stack([a.reshape(-1) for a in arrs], axis=-1)
        return np.reshape(interpolate_fit(xi, fi, dimension, order, pts, diff,
                                          device=device), shp)

    return model
