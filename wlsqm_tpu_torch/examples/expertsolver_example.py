"""ExpertSolver: project scattered data onto a regular grid.

Counterpart of the JAX package's ``examples/expertsolver_example.py``, an
analogue of the reference's ExpertSolver example
(examples/expertsolver_example.py): fit local models at scattered sample
sites (neighbourhoods from :func:`wlsqm_tpu_torch.utils.neighbors.knn` on
the device), then evaluate the patched global surrogate on a uniform grid by
nearest-model and by continuous blending.  ``ExpertSolver.solve``
back-substitutes the factor it prepared on the device; it launches no fit
kernel (``wlsqm_tpu_torch.fitter.expert`` says why).

Run: python -m wlsqm_tpu_torch.examples.expertsolver_example [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.utils import neighbors

NPTS, K = 3000, 20


def field(xy):
    x, y = xy[..., 0], xy[..., 1]
    return np.sin(2 * x) * np.cos(3 * y) + 0.25 * x * y


def run(device=None) -> dict:
    """Prepare, solve and project on ``device`` (the card unless
    ``device="cpu"``).  Returns the prepared bytes and the max errors of the
    nearest, continuous and d/dx projections on a 61 x 61 grid."""
    device = config.resolve_device(device)
    rng = np.random.default_rng(42)
    pts = rng.uniform(-1, 1, (NPTS, 2))
    vals = field(pts)

    # every sample site is also a fit origin; neighbours from the cloud
    idx, _ = neighbors.knn(pts, pts, K + 1, backend="device", device=device)
    idx = idx[:, 1:].cpu().numpy()
    xk, fk = pts[idx], vals[idx]

    solver = wtt.ExpertSolver(
        dimension=2, nk=np.full(NPTS, K, np.int32), order=np.full(NPTS, 2, np.int32),
        knowns=np.zeros(NPTS, np.int64),
        weighting_method=np.full(NPTS, wtt.WEIGHT_CENTER, np.int32), device=device)
    solver.prepare(xi=pts, xk=xk)
    fi = np.zeros((NPTS, wtt.number_of_dofs(2, 2)))
    solver.solve(fk=fk, fi=fi)

    g = np.linspace(-0.9, 0.9, 61)
    gx, gy = np.meshgrid(g, g)
    grid = np.stack([gx.ravel(), gy.ravel()], -1)
    solver.prep_interpolate()
    near, nidx = solver.interpolate(grid, mode="nearest")
    cont, _ = solver.interpolate(grid, mode="continuous", r=0.25)
    truth = field(grid)
    ddx, _ = solver.interpolate(grid, mode="nearest", diff=wtt.i2_X, I=nidx)
    ddx_true = 2 * np.cos(2 * grid[:, 0]) * np.cos(3 * grid[:, 1]) + 0.25 * grid[:, 1]
    return {"device": str(solver.device), "npts": NPTS, "k": K,
            "memory_bytes": solver.memory_used()[0], "fi": fi,
            "nearest_max_error": float(np.abs(near - truth).max()),
            "continuous_max_error": float(np.abs(cont - truth).max()),
            "ddx_max_error": float(np.abs(ddx - ddx_true).max())}


if __name__ == "__main__":
    res = run(device="cpu" if "--cpu" in sys.argv[1:] else None)
    print("prepared+solved %d local models; device memory used: %.1f MB"
          % (res["npts"], res["memory_bytes"] / 1e6))
    print(f"nearest    projection: max err {res['nearest_max_error']:.3e}")
    print(f"continuous projection: max err {res['continuous_max_error']:.3e}")
    print(f"d/dx       projection: max err {res['ddx_max_error']:.3e}")
