"""Response-surface modelling: WLSQM as a noise-robust surrogate builder.

Counterpart of the JAX package's ``examples/response_surface.py``.  The
reference names response-surface modelling as a primary use case
(README.md:29-34): fit a low-order polynomial surrogate to noisy
evaluations of an expensive black box over a parameter domain, then work
with the surrogate (query it anywhere, read gradients off the DOFs,
optimise on it).  This example

  1. samples a noisy 2D objective on a space-filling design (the
     sudoku-LHS sampler, :mod:`wlsqm_tpu_torch.examples.sudoku_lhs`);
  2. fits one global order-4 surrogate centred mid-domain with the compat
     surface's ``fit_2D`` (``fit_many(backend="auto", gate="data")``: the
     moment kernel on the card, its plain version on the CPU, a case past
     the data edge solved again by the f64 engine);
  3. Newton-descends to the surrogate's minimum with the gradient and
     Hessian from ``interpolate_fit``;
  4. checks the result against the noiseless minimiser.

Run: python -m wlsqm_tpu_torch.examples.response_surface [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.examples.sudoku_lhs import sample as sudoku_sample

NOISE = 0.01
#: the bar on the distance between the surrogate's and the true minimiser
TOL = 0.05


def objective(xy):
    """A smooth bowl with mild asymmetry; minimum near (0.35, -0.2)."""
    x, y = xy[..., 0], xy[..., 1]
    return ((x - 0.35) ** 2 + 1.5 * (y + 0.2) ** 2
            + 0.3 * (x - 0.35) * (y + 0.2) + 0.1 * np.sin(x + y))


def run(device=None) -> dict:
    """Fit, query and descend on ``device`` (the card unless
    ``device="cpu"``).  Returns the surrogate's max error on a fresh grid,
    the Newton iterate and step count, the true minimiser and their
    distance.  Raises if the distance reaches :data:`TOL`."""
    device = config.resolve_device(device)
    rng = np.random.default_rng(123)

    design, _bins = sudoku_sample(dim=2, m=4, n_per_block=15, rng=rng)
    n = len(design)                              # 240 points in [0,1)^2
    pts = 2.0 * design - 1.0                     # parameter domain [-1,1]^2
    fvals = objective(pts) + NOISE * rng.standard_normal(n)

    xi = np.zeros(2)
    fi = np.zeros(wtt.number_of_dofs(2, 4))
    wtt.fit_2D(xk=pts, fk=fvals, xi=xi, fi=fi, sens=None, do_sens=False,
               order=4, knowns=0, weighting_method=wtt.WEIGHT_UNIFORM, debug=False,
               device=device)

    def at(x, diff):
        return wtt.interpolate_fit(xi, fi, dimension=2, order=4, x=x, diff=diff,
                                   device=device)

    g = np.stack(np.meshgrid(np.linspace(-0.9, 0.9, 25),
                             np.linspace(-0.9, 0.9, 25)), -1).reshape(-1, 2)
    surrogate_err = float(np.abs(at(g, wtt.i2_F) - objective(g)).max())

    p = np.array([-0.5, 0.6])
    for it in range(20):
        q = p[None, :]
        gx, gy, hxx, hyy, hxy = (at(q, d)[0] for d in (wtt.i2_X, wtt.i2_Y, wtt.i2_X2,
                                                       wtt.i2_Y2, wtt.i2_XY))
        step = np.linalg.solve(np.array([[hxx, hxy], [hxy, hyy]]), np.array([gx, gy]))
        p = p - step
        if np.linalg.norm(step) < 1e-12:
            break

    # the sin term shifts the true minimiser slightly; refine it numerically
    from scipy.optimize import minimize

    true_min = minimize(lambda z: objective(z[None, :])[0], np.array([0.35, -0.2])).x
    dist = float(np.linalg.norm(p - true_min))
    out = {"device": str(device), "n": n, "noise": NOISE, "surrogate_max_error": surrogate_err,
           "fi": fi.tolist(), "newton_steps": it + 1, "minimizer": p.tolist(),
           "true_minimizer": true_min.tolist(), "distance": dist, "tol": TOL}
    if not dist < TOL:
        raise RuntimeError("surrogate minimum drifted from the true minimum: %s" % (out,))
    return out


if __name__ == "__main__":
    res = run(device="cpu" if "--cpu" in sys.argv[1:] else None)
    p, t = res["minimizer"], res["true_minimizer"]
    print(f"surrogate max |err| on a fresh grid: {res['surrogate_max_error']:.3e} "
          f"(noise level {res['noise']})")
    print(f"surrogate minimizer after {res['newton_steps']} Newton steps: "
          f"({p[0]:+.4f}, {p[1]:+.4f})")
    print(f"true minimizer:                              ({t[0]:+.4f}, {t[1]:+.4f})")
    print(f"distance: {res['distance']:.2e}")
    print("OK")
