"""Adjoint data recovery: backpropagate through the rows kernel.

Counterpart of the JAX package's ``examples/adjoint_data_recovery.py``.  We
observe a noisy field ``u_obs`` at scattered points and know the PDE source
it must satisfy (a manufactured Poisson problem, lap u = g).  WLSQM gives
the Laplacian at every point, a batched local fit of the nodal values, so
recovering the field is a smooth optimisation over the nodal values:

    min_u   mean( (lap_wlsqm(u) - g)^2 ) + lam * mean( (u - u_obs)^2 )

The gradient of the first term needs the adjoint of the fit with respect to
the data.  :func:`wlsqm_tpu_torch.ops.fit_rows.fit_rows_diffable` gives it:
the basic fit is linear in the data, so its forward pass is one ``do_sens``
launch of the rows kernel (its plain version on the CPU) and its backward
pass an einsum with the sensitivities.  ``torch.autograd`` carries the
gradient through the plain neighbour gather ``u[idx]`` back to the nodal
values; the gather kernel refuses grad, and the original indexes plainly
too.  The reference computes the same sensitivities
(wlsqm/fitter/impl.pyx:768-846) but cannot chain them into an optimiser.

Run: python -m wlsqm_tpu_torch.examples.adjoint_data_recovery [--cpu]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import defs
from wlsqm_tpu_torch.ops.fit_rows import fit_rows_diffable
from wlsqm_tpu_torch.utils import neighbors

N_SIDE = 32                 # 32 x 32 grid: B = 1024
K = 12                      # neighbours per case (nearest, self excluded)
LAM = 2e-3                  # data-fidelity weight
STEPS = 60
LR = 4e-3
SIGMA = 0.02                # observation noise
#: the bar: the recovered field's relative error under this share of the noisy data's
GAIN = 0.6


@dataclasses.dataclass
class Problem:
    """A manufactured Poisson problem on an n_side x n_side grid of [0, 1]^2."""

    pts: np.ndarray
    idx: torch.Tensor          # (B, K) neighbour indices
    xk: torch.Tensor           # (B, K, 2)
    xi: torch.Tensor           # (B, 2)
    nk: torch.Tensor           # (B,)
    g: torch.Tensor            # (B,) the exact Laplacian
    u_true: np.ndarray
    u_obs: torch.Tensor


def dense_neighbours(pts: np.ndarray, k: int) -> np.ndarray:
    """The original's K nearest (self excluded) by a dense argsort (l.61-65)."""
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.argsort(d2, axis=1)[:, :k]


def problem(n_side: int = N_SIDE, k: int = K, *, device=None, dense: bool = True) -> Problem:
    """The grid, its noisy observation (seed 3) and its neighbourhoods:
    the original's dense argsort, or (``dense=False``, for grids too large
    for a dense distance matrix) the host k-d tree of
    :func:`wlsqm_tpu_torch.utils.neighbors.knn`."""
    device = config.resolve_device(device)
    g1 = np.linspace(0.0, 1.0, n_side)
    X, Y = np.meshgrid(g1, g1, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    u_true = np.sin(np.pi * X) * np.sin(np.pi * Y)
    lap_true = -2.0 * np.pi ** 2 * u_true
    rng = np.random.default_rng(3)
    u_obs = (u_true + SIGMA * rng.standard_normal(u_true.shape)).ravel()
    if dense:
        idx = dense_neighbours(pts, k)
    else:
        idx = neighbors.knn(pts, pts, k + 1, backend="host")[0][:, 1:]
    idx_t = torch.as_tensor(idx, device=device)
    pts_t = torch.as_tensor(pts, device=device)
    B = len(pts)
    return Problem(pts=pts, idx=idx_t, xk=pts_t[idx_t], xi=pts_t,
                   nk=torch.full((B,), k, dtype=torch.int32, device=device),
                   g=torch.as_tensor(lap_true.ravel(), device=device),
                   u_true=u_true.ravel(), u_obs=torch.as_tensor(u_obs, device=device))


def wlsqm_lap(p: Problem, u: torch.Tensor) -> torch.Tensor:
    """The WLSQM Laplacian at every point, from the nodal values."""
    fi = fit_rows_diffable(p.xk, u[p.idx], p.nk, p.xi, dimension=2, order=2,
                           weighting=defs.WEIGHT_CENTER)
    return fi[:, defs.i2_X2] + fi[:, defs.i2_Y2]


def loss_of(p: Problem, lap: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    r = lap - p.g
    return (r ** 2).mean() + LAM * ((u - p.u_obs) ** 2).mean()


def loss_and_grad(p: Problem, u: torch.Tensor):
    """(loss, d loss / d u): one rows-kernel launch forward, one einsum back."""
    u = u.detach().requires_grad_(True)
    loss = loss_of(p, wlsqm_lap(p, u), u)
    (grad,) = torch.autograd.grad(loss, u)
    return loss.detach(), grad


def update(u: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The original's scale-free fixed step."""
    return u - LR * grad / (grad.abs().max() + 1e-30) * u.abs().max()


def rel(p: Problem, u) -> float:
    u = u.detach().cpu().numpy() if isinstance(u, torch.Tensor) else u
    return float(np.linalg.norm(u - p.u_true) / np.linalg.norm(p.u_true))


def run(device=None, log=None) -> dict:
    """Recover the field on ``device`` (the card unless ``device="cpu"``).

    Returns the noisy and the recovered relative errors and the first and
    last loss.  ``log(it, loss, rel)`` is called where
    the original prints.  Raises unless the recovered error is under
    :data:`GAIN` times the noisy one.
    """
    p = problem(device=device)
    u = p.u_obs.clone()
    base = rel(p, p.u_obs)
    losses = []
    for it in range(STEPS):
        val, grad = loss_and_grad(p, u)
        u = update(u, grad)
        losses.append(float(val))
        if log is not None and (it % 10 == 0 or it == STEPS - 1):
            log(it, float(val), rel(p, u))
    final = rel(p, u)
    out = {"device": str(p.idx.device), "B": len(p.pts), "k": K, "steps": STEPS,
           "noisy_rel_error": base, "recovered_rel_error": final,
           "first_loss": losses[0], "last_loss": losses[-1], "gain": GAIN}
    if not final < GAIN * base:
        raise RuntimeError("adjoint recovery should beat the raw data: %s" % (out,))
    return out


if __name__ == "__main__":
    def _log(it, val, r):
        print("step %3d  loss %.5e  rel err %.4f" % (it, val, r))

    res = run(device="cpu" if "--cpu" in sys.argv[1:] else None, log=_log)
    print("noisy observation rel error: %.4f" % res["noisy_rel_error"])
    print("recovered rel error %.4f vs noisy %.4f (%.1fx reduction)"
          % (res["recovered_rel_error"], res["noisy_rel_error"],
             res["noisy_rel_error"] / res["recovered_rel_error"]))
    print("OK")
