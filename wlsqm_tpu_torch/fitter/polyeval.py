"""Polynomial surrogate evaluation.

Port of :mod:`wlsqm_tpu.fitter.polyeval` (reference: the hand-unrolled
Horner evaluators of wlsqm/fitter/polyeval.pyx).  Evaluation is a dot
product of the coefficient vector with the monomial basis row, the same
contraction the fitting matrix uses (reference: wlsqm/fitter/interp.pyx:34-41).

Two coefficient conventions:

* ``taylor``: "partially baked" coefficients — entries are the derivative
  values of the surrogate at xi; the 1/m! normalization lives in the basis
  (reference: wlsqm/fitter/polyeval.pyx:58-74).
* ``general``: plain polynomial coefficients of (x - xi) monomials
  (reference: wlsqm/fitter/polyeval.pyx general_*).

Inputs may be tensors or NumPy arrays; results are float64 tensors on
``device`` (the card unless ``device="cpu"``, :func:`config.resolve_device`).
"""

from __future__ import annotations

import torch

from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import defs, tables
from wlsqm_tpu_torch.fitter.engine import basis

__all__ = [
    "taylor", "general",
    "taylor_1D", "taylor_2D", "taylor_3D",
    "general_1D", "general_2D", "general_3D",
]


def _delta(x, xi, dimension, device):
    x = config.as_tensor(x, device)
    xi = config.as_tensor(xi, device)
    if dimension == 1:
        x = x.reshape(-1, 1)
        xi = xi.reshape(1)
    return x - xi


def taylor(dimension: int, order: int, fi, xi, x, *, device=None) -> torch.Tensor:
    """Evaluate the surrogate with partially-baked coefficients ``fi`` at ``x``.

    x: (n, dim) points (or (n,) in 1D).  Returns (n,) values.
    """
    device = config.resolve_device(device, fi, xi, x)
    no = defs.number_of_dofs(dimension, order)
    c = basis(_delta(x, xi, dimension, device), dimension, no)   # (n, no)
    return c @ config.as_tensor(fi, device)[:no]


def general(dimension: int, order: int, fi, xi, x, *, device=None) -> torch.Tensor:
    """Evaluate a plain polynomial (coefficients of (x-xi) monomials) at ``x``."""
    device = config.resolve_device(device, fi, xi, x)
    no = defs.number_of_dofs(dimension, order)
    c = basis(_delta(x, xi, dimension, device), dimension, no)   # baked basis
    # un-bake: the plain monomial is baked_c / invfact, so fold the factor
    # into the coefficient vector instead of the (larger) basis matrix
    invfact = torch.as_tensor(tables.INV_FACT[dimension][:no], device=device)
    return c @ (config.as_tensor(fi, device)[:no] / invfact)


def taylor_1D(order, fi, xi, x, *, device=None):
    """1D partially-baked evaluation (reference: wlsqm/fitter/polyeval.pyx:874)."""
    return taylor(1, order, fi, xi, x, device=device)


def taylor_2D(order, fi, xi, x, *, device=None):
    """2D partially-baked evaluation (reference: wlsqm/fitter/polyeval.pyx:550)."""
    return taylor(2, order, fi, xi, x, device=device)


def taylor_3D(order, fi, xi, x, *, device=None):
    """3D partially-baked evaluation (reference: wlsqm/fitter/polyeval.pyx:82)."""
    return taylor(3, order, fi, xi, x, device=device)


def general_1D(order, fi, xi, x, *, device=None):
    """1D plain-coefficient evaluation (reference: wlsqm/fitter/polyeval.pyx:955)."""
    return general(1, order, fi, xi, x, device=device)


def general_2D(order, fi, xi, x, *, device=None):
    """2D plain-coefficient evaluation (reference: wlsqm/fitter/polyeval.pyx:741)."""
    return general(2, order, fi, xi, x, device=device)


def general_3D(order, fi, xi, x, *, device=None):
    """3D plain-coefficient evaluation (reference: wlsqm/fitter/polyeval.pyx:361)."""
    return general(3, order, fi, xi, x, device=device)
