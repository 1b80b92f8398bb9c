"""The plain reference of ``euler2d_o3_k24``: one SSP-RK3 stage of the 2D
compressible Euler equations U_t + F(U)_x + G(U)_y = 0, U = (rho, rho u,
rho v, E), at chosen points of a periodic cloud, in plain torch.

For each point: its k nearest periodic neighbours by brute force (the
minimal-image offset to every point of the cloud, the point itself
excluded), the 8 flux components F(W), G(W) of the stage's state at the
neighbours' owners, an exact weighted least-squares fit of order 3 of
each at the neighbours' ghost positions (``bench_port/lib/wls_ref.py``),
r = -(F_x + G_y) from the fits' X and Y DOFs, and the stage's SSP-RK3
combination (Shu-Osher form):

    stage 0: U + dt r
    stage 1: 3/4 U + 1/4 (W + dt r)
    stage 2: 1/3 U + 2/3 (W + dt r)

with U the step's input state and W the stage's.  It works the
neighbours, weights and fits out again from the points alone.

Departures from ``examples/euler_flow.py``: the fits are a Householder QR
of the weighted basis (the example solves the Ruiz-scaled normal
equations by Cholesky: the same fit in exact arithmetic), and the
neighbours come from the minimal image rather than a k-d tree over a
band of ghost tiles (the same sets wherever the k-th neighbour lies
within half the period).
"""

from __future__ import annotations

import torch

from bench_port.lib.wls_ref import EXPONENTS, fit_blocks, gap  # noqa: F401

GAMMA = 1.4
L = 10.0
#: the DOFs of d/dx and d/dy
DX, DY = EXPONENTS[2].index((1, 0)), EXPONENTS[2].index((0, 1))


def knn_periodic(pts: torch.Tensor, queries: torch.Tensor, k: int, block: int = 8):
    """The k nearest periodic neighbours of each query, a point of ``pts``
    (the query itself excluded), nearest first, by comparing every
    minimal-image distance on the period ``L``.

    Returns (ghost positions (M, k, 2): each neighbour translated by the
    whole periods that bring it nearest the query, owners (M, k) int64:
    the neighbours' indices in ``pts``)."""
    ghosts, owners = [], []
    for lo in range(0, queries.shape[0], block):
        q = queries[lo:lo + block]
        # whole periods to add to each point, per axis, to bring it nearest q
        shift = torch.round((q[:, None, :] - pts[None, :, :]) / L) * L
        g = pts[None, :, :] + shift
        d2 = ((g - q[:, None, :]) ** 2).sum(-1)
        idx = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True).indices[:, 1:]
        owners.append(idx)
        ghosts.append(torch.gather(g, 1, idx[..., None].expand(-1, -1, 2)))
    return torch.cat(ghosts), torch.cat(owners)


def flux(U: torch.Tensor) -> torch.Tensor:
    """F(U) then G(U), (..., 8) from U (..., 4)."""
    rho, mx, my, E = U.unbind(-1)
    u, v = mx / rho, my / rho
    p = (GAMMA - 1) * (E - 0.5 * rho * (u * u + v * v))
    return torch.stack([mx, mx * u + p, my * u, (E + p) * u,
                        my, mx * v, my * v + p, (E + p) * v], -1)


def stage(xk, xi, W_k, W_i, U_i, dt, stage, *, order: int = 3, center: bool = True,
          dtype=torch.float64):
    """One stage at M points: xk (M, k, 2) the neighbours' ghost positions,
    xi (M, 2) the points, W_k (M, k, 4) the stage's state at the owners,
    W_i (M, 4) and U_i (M, 4) the stage's and the step's state at the
    points, ``stage`` 0, 1 or 2.  Returns r (M, 4) = -(F_x + G_y) and the
    stage's next state (M, 4), in ``dtype``."""
    fl = flux(W_k.to(dtype))
    d = [fit_blocks(xk, fl[..., f], xi, order=order, center=center, dtype=dtype)[0]
         for f in range(8)]
    r = -torch.stack([d[f][:, DX] + d[4 + f][:, DY] for f in range(4)], -1)
    W, U = W_i.to(dtype), U_i.to(dtype)
    if stage == 0:
        return r, U + dt * r
    if stage == 1:
        return r, 0.75 * U + 0.25 * (W + dt * r)
    return r, U / 3.0 + 2.0 / 3.0 * (W + dt * r)
