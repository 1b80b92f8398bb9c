"""The plain reference of ``heat2d_o2_k28``: one explicit Euler step of
u_t = nu (u_xx + u_yy) at chosen points, in plain torch.

For each point: its k nearest points of the cloud by brute force (the
point itself included), an exact weighted least-squares fit of order 2 to
the state's values there (``bench_port/lib/wls_ref.py``), and u + dt nu
(u_xx + u_yy) from the fit's X2 and Y2 DOFs on interior points; edge
points keep their value.  It works the neighbours, weights and factors out
again from the points alone.
"""

from __future__ import annotations

import torch

from bench_port.lib.wls_ref import EXPONENTS, fit_blocks, gap  # noqa: F401

#: the DOFs whose sum is the Laplacian
LAPLACIAN = (EXPONENTS[2].index((2, 0)), EXPONENTS[2].index((0, 2)))


def knn(pts: torch.Tensor, queries: torch.Tensor, k: int, block: int = 8) -> torch.Tensor:
    """Indices (M, k) of the k nearest points of ``pts`` to each query,
    nearest first, by comparing every distance."""
    out = []
    for lo in range(0, queries.shape[0], block):
        q = queries[lo:lo + block]
        d2 = ((pts[None, :, 0] - q[:, None, 0]) ** 2
              + (pts[None, :, 1] - q[:, None, 1]) ** 2)
        out.append(torch.topk(d2, k, dim=1, largest=False, sorted=True).indices)
    return torch.cat(out)


def step(xk, xi, uk, ui, inner, dt_nu, *, order: int, center: bool, dtype=torch.float64):
    """The fit and the next state at M points from the state's values:
    xk (M, k, 2) the points' neighbours, xi (M, 2) the points, uk (M, k)
    or (M, k, F) the state there, ui (M,) or (M, F) the state at the points,
    inner (M,) whether a point moves.  Returns fi (M, NO) or (F, M, NO), and
    u_next (M,) or (M, F), in ``dtype``."""
    fields_k = uk[..., None] if uk.ndim == 2 else uk
    fields_i = ui[:, None] if ui.ndim == 1 else ui
    fis, nxt = [], []
    for f in range(fields_k.shape[-1]):
        fi, _ = fit_blocks(xk, fields_k[..., f], xi, order=order, center=center, dtype=dtype)
        lap = fi[:, LAPLACIAN[0]] + fi[:, LAPLACIAN[1]]
        uf = fields_i[:, f].to(dtype)
        nxt.append(torch.where(inner, uf + float(dt_nu[f]) * lap, uf))
        fis.append(fi)
    if uk.ndim == 2:
        return fis[0], nxt[0]
    return torch.stack(fis), torch.stack(nxt, 1)
