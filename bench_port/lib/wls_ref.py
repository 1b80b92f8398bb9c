"""The plain reference: weighted least squares, one case after another in
a batch dimension, in plain torch.

For each case the local polynomial of the configuration's order in the
offsets from xi, with the monomials divided by their factorials so that
the coefficients are the value and the partial derivatives at xi (the
package's DOF definition, python-wlsqm's ``defs.pyx``), fitted to the
neighbours by weighted least squares.  Weights: 1 (uniform), or python-
wlsqm's centre weighting alpha + (1 - alpha)(1 - d/d_max)^2 with alpha =
1e-4.  The offsets are divided by each case's largest neighbour distance,
and the scaled problem is solved by a Householder QR of √w·C written out
here (never the normal equations, and no library factorisation), so its
error follows the conditioning of C, not that of CᵀWC.  The coefficients
are then scaled back by h^-degree.

With ``cond=True`` a fit also gives each case's componentwise (Skeel)
condition of its weighted normal equations in the DOF convention,
‖ |N⁻¹| (|A|ᵀ|A| |y| + |A|ᵀ|b|) ∘ h^-degree ‖∞ / max(‖fi‖∞, 1), with A =
√w·C and b = √w·f of the scaled problem, N = AᵀA = RᵀR from the QR above
and y the scaled solution: to first order, a solve of the normal equations
(the port's f64 engine; a kernel's moment sums) whose sums and factor each
carry a few roundings lies u times this from the exact fit.

Imports nothing of the port: its exponent table is a copy of the one the
package documents.
"""

from __future__ import annotations

import math

import torch

ALPHA = 1e-4

#: DOF exponents in the package's DOF order (python-wlsqm's defs.pyx)
EXPONENTS = {
    1: [(0,), (1,), (2,), (3,), (4,)],
    2: [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2), (3, 0), (2, 1), (1, 2), (0, 3),
        (4, 0), (3, 1), (2, 2), (1, 3), (0, 4)],
    3: [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 0, 0), (1, 1, 0), (0, 2, 0),
        (0, 1, 1), (0, 0, 2), (1, 0, 1), (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0),
        (0, 2, 1), (0, 1, 2), (0, 0, 3), (1, 0, 2), (2, 0, 1), (1, 1, 1), (4, 0, 0),
        (3, 1, 0), (2, 2, 0), (1, 3, 0), (0, 4, 0), (0, 3, 1), (0, 2, 2), (0, 1, 3),
        (0, 0, 4), (1, 0, 3), (2, 0, 2), (3, 0, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2)],
}
_DOFS = {1: (1, 2, 3, 4, 5), 2: (1, 3, 6, 10, 15), 3: (1, 4, 10, 20, 35)}


def dofs(dim: int, order: int) -> int:
    return _DOFS[dim][order]


def fit(xk, fk, xi, *, order: int, center: bool, sens: bool = False,
        dtype=torch.float64, cond: bool = False):
    """Fit every case of a batch.

    xk (B, K, dim), fk (B, K), xi (B, dim), all full (no padded
    neighbours).  Computes in ``dtype``.  Returns fi (B, NO) and, with
    ``sens``, d fi / d fk (B, K, NO), in ``dtype``; with ``cond`` a third
    item, each case's condition (B,) (see the module's docstring).
    """
    xk, fk, xi = xk.to(dtype), fk.to(dtype), xi.to(dtype)
    dim = xk.shape[-1]
    exps = EXPONENTS[dim][:dofs(dim, order)]
    d = xk - xi[:, None, :]
    d2 = (d * d).sum(-1)
    d2max = d2.amax(-1, keepdim=True)
    h = d2max.sqrt()
    if center:
        t = 1.0 - torch.sqrt(d2 / d2max)
        w = ALPHA + (1.0 - ALPHA) * t * t
    else:
        w = torch.ones_like(d2)
    s = d / h[..., None]
    cols = []
    for e in exps:
        c = torch.ones_like(d2)
        for a, p in enumerate(e):
            for _ in range(p):
                c = c * s[..., a]
        cols.append(c / math.prod(math.factorial(p) for p in e))
    sw = w.sqrt()
    A = torch.stack(cols, -1) * sw[..., None]                        # (B, K, NO)
    no = A.shape[-1]
    rhs = [(sw * fk)[..., None]]
    if sens:
        rhs.append(torch.diag_embed(sw))                             # d(√w f)/d f
    qtb, r = householder(A, torch.cat(rhs, -1))
    deg = torch.tensor([sum(e) for e in exps], dtype=dtype, device=xk.device)
    unscale = h ** -deg                                              # (B, NO)
    ys = torch.linalg.solve_triangular(r, qtb[:, :no], upper=True)
    y = ys * unscale[..., None]
    out = (y[..., 0], (y[..., 1:].transpose(1, 2) if sens else None))
    if not cond:
        return out
    eye = torch.eye(no, dtype=dtype, device=xk.device).expand_as(r)
    rinv = torch.linalg.solve_triangular(r, eye, upper=True)
    ninv = (rinv @ rinv.transpose(1, 2)).abs()                       # |N⁻¹|
    aa = A.abs()
    v = aa.transpose(1, 2) @ (aa @ ys[..., :1].abs() + rhs[0].abs())  # (B, NO, 1)
    v = (ninv @ v)[..., 0] * unscale
    return out + (v.amax(1) / y[..., 0].abs().amax(1).clamp_min(1.0),)


def householder(A, b):
    """Qᵀb and R of A = QR (A (B, K, NO) with K >= NO), by Householder
    reflections applied column by column to the whole batch at once."""
    A, b = A.clone(), b.clone()
    no = A.shape[2]
    for j in range(no):
        x = A[:, j:, j]
        alpha = torch.linalg.vector_norm(x, dim=1)
        alpha = torch.where(x[:, 0] >= 0, -alpha, alpha)             # no cancellation
        v = x.clone()
        v[:, 0] -= alpha
        vn = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        v = v / torch.where(vn > 0, vn, 1.0)
        A[:, j:, j:] -= 2 * v[:, :, None] * (v[:, None, :] @ A[:, j:, j:])
        b[:, j:] -= 2 * v[:, :, None] * (v[:, None, :] @ b[:, j:])
    return b, torch.triu(A[:, :no, :])


def fit_blocks(xk, fk, xi, *, order: int, center: bool, sens: bool = False,
               dtype=torch.float64, cond: bool = False, block: int = 1 << 16):
    """:func:`fit` over a large batch in blocks of ``block`` cases."""
    parts = [fit(xk[lo:lo + block], fk[lo:lo + block], xi[lo:lo + block], order=order,
                 center=center, sens=sens, dtype=dtype, cond=cond)
             for lo in range(0, xk.shape[0], block)]
    out = (torch.cat([p[0] for p in parts]),
           torch.cat([p[1] for p in parts]) if sens else None)
    return out + ((torch.cat([p[2] for p in parts]),) if cond else ())


def gap(got, ref) -> torch.Tensor:
    """Per case: the largest |got - ref| over the case's values, relative to
    max(max |ref|, 1); NaN or inf in ``got`` reads inf."""
    got = got.reshape(got.shape[0], -1).to(torch.float64)
    ref = ref.reshape(ref.shape[0], -1).to(torch.float64)
    err = (got - ref).abs().amax(1) / ref.abs().amax(1).clamp_min(1.0)
    return torch.where(torch.isfinite(got).all(1), err, torch.inf)
