"""Meshless heat equation: prepare once, then gather + solve every step.

Counterpart of the JAX package's ``examples/ibvp_heat.py``.  Solves
u_t = nu (u_xx + u_yy) on a scattered 2D point cloud with explicit Euler
steps, WLSQM as the meshless spatial discretization (reference:
README.md:29-34).  Dirichlet boundary values are pinned; the Laplacian at
every point comes from the X2 + Y2 DOFs of its local fit.  The geometry
never changes, so the normal matrices are prepared and factored once
(:func:`wlsqm_tpu_torch.prepare`), and every step is

    fk = gather_rows(u, idx, plan)    # the gather kernel on the card
    fi, _ = solve(prep, fk)           # one batched solve
    u = u + dt * nu * (fi[:, X2] + fi[:, Y2]) on the interior

Then three species diffuse on the same cloud (nu = 0.02, 0.035, 0.05):
ONE gather of u (n, 3) and one multi-field solve per step.  Each run is
held to the manufactured solution exp(-2 pi² nu t) sin(pi x) sin(pi y):
max error < 5e-3.

The cloud is Morton-ordered and the window plan must exist: there is no
quiet fallback to ``u[idx]``.  On the card the gather is the CUDA kernel;
with ``device="cpu"`` it is the plain version.

Run: python -m wlsqm_tpu_torch.examples.ibvp_heat [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.ops import gather as gth
from wlsqm_tpu_torch.utils import neighbors

#: the bar on each run's max error against the exact solution
TOL = 5e-3

N_INTERIOR, N_BOUNDARY_PER_SIDE = 2000, 40
K = 16            # neighbours per fit, self excluded
DT, NSTEPS = 2e-5, 500
NU = 0.05         # the single-field run
NUS = (0.02, 0.035, 0.05)   # the three-field run, within the dt-stability envelope


def _exact(p, nu, t):
    return np.exp(-2 * np.pi**2 * nu * t) * np.sin(np.pi * p[..., 0]) * np.sin(np.pi * p[..., 1])


def run(device=None) -> dict:
    """Run both heat solves on ``device`` (the card unless ``device="cpu"``).

    Returns the max and rms errors of the single-field run, the max error of
    each field of the three-field run, the gather plan's coverage and its
    overflow block count, and the gather kernel launches made (0 on the
    CPU).  Raises if any max error reaches :data:`TOL`.
    """
    device = config.resolve_device(device)
    rng = np.random.default_rng(42)
    interior = rng.uniform(0.02, 0.98, (N_INTERIOR, 2))
    t = np.linspace(0, 1, N_BOUNDARY_PER_SIDE)
    boundary = np.concatenate([
        np.stack([t, np.zeros_like(t)], -1),
        np.stack([t, np.ones_like(t)], -1),
        np.stack([np.zeros_like(t), t], -1),
        np.stack([np.ones_like(t), t], -1),
    ])
    pts = np.concatenate([interior, boundary])
    # Morton order: neighbour indices become spatially local
    perm = gth.morton_order(pts)
    pts = pts[perm]
    n = len(pts)
    is_interior = torch.as_tensor(perm < N_INTERIOR, device=device)

    # neighbourhoods over the full cloud, self excluded (F stays a fit DOF)
    idx, _ = neighbors.knn(pts, pts, K + 1, backend="device", device=device)
    idx = idx[:, 1:].to(torch.int32).contiguous()
    plan = gth.plan_window_gather(idx, n)
    if plan is None:
        raise RuntimeError("the Morton-ordered cloud gave no window plan")
    pts_t = torch.as_tensor(pts, device=device)
    prep = wtt.prepare(pts_t[idx.long()], pts_t, order=2, weighting=wtt.WEIGHT_CENTER,
                       device=device)
    lap_idx = [wtt.i2_X2, wtt.i2_Y2]
    launches = gth.LAUNCHES

    u = torch.as_tensor(_exact(pts, NU, 0.0), device=device)
    for _ in range(NSTEPS):
        fk = gth.gather_rows(u, idx, plan)
        fi, _ = wtt.solve(prep, fk)
        u = torch.where(is_interior, u + DT * NU * fi[:, lap_idx].sum(1), u)
    t_final = DT * NSTEPS
    err = np.abs(u.cpu().numpy() - _exact(pts, NU, t_final))

    nus_t = torch.as_tensor(NUS, dtype=torch.float64, device=device)
    um = torch.as_tensor(_exact(pts, 0.0, 0.0), device=device)[:, None].repeat(1, len(NUS))
    for _ in range(NSTEPS):
        fk = gth.gather_rows(um, idx, plan)                        # (B, K, F): one gather
        fi, _ = wtt.solve(prep, fk.permute(2, 0, 1))               # (F, B, NO)
        lap = fi[..., lap_idx].sum(-1)                             # (F, B)
        um = torch.where(is_interior[:, None], um + DT * nus_t[None, :] * lap.T, um)
    um = um.cpu().numpy()
    field_err = [float(np.abs(um[:, f] - _exact(pts, v, t_final)).max())
                 for f, v in enumerate(NUS)]

    out = {"device": str(device), "n": n, "k": K, "steps": NSTEPS, "dt": DT,
           "t_final": t_final, "max_error": float(err.max()),
           "rms_error": float(np.sqrt((err**2).mean())), "nus": list(NUS),
           "field_max_errors": field_err, "coverage": plan.coverage,
           "bad_blocks": len(plan.bad_blocks),
           "gather_launches": gth.LAUNCHES - launches, "tol": TOL}
    if max(out["max_error"], *field_err) >= TOL:
        raise RuntimeError("heat solution drifted from the exact solution: %s" % (out,))
    return out


if __name__ == "__main__":
    res = run(device="cpu" if "--cpu" in sys.argv[1:] else None)
    print("window gather: coverage %.1f%%, %d launches"
          % (100 * res["coverage"], res["gather_launches"]))
    print("steps: %d, dt=%g, t_final=%g" % (res["steps"], res["dt"], res["t_final"]))
    print("max error vs exact solution: %.3e" % res["max_error"])
    print("rms error:                   %.3e" % res["rms_error"])
    for nu_f, e in zip(res["nus"], res["field_max_errors"]):
        print("field nu=%g: max error %.3e" % (nu_f, e))
    print("OK")
