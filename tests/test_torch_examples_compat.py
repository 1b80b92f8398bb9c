"""The port's compat-surface examples against their JAX originals.

Each ``run(device="cpu")`` of ``wlsqm_tpu_torch/examples`` returns its
schema and meets its original's bar, and where the original's numbers can
be recomputed, the JAX package computes them here on the same inputs:

* ``response_surface``: the sudoku-LHS copy draws the original sampler's
  points, and the order-4 surrogate's DOFs are ``wt.fit_2D``'s within
  1e-10 relative to max(|ref|, 1) (one well-conditioned 240-point fit);
* ``wlsqm_tour``: each stage's DOFs, sensitivities and autograd gradients
  against the JAX package's calls on the same draws, within 1e-10; the 2D
  stage's ALGO_ITERATIVE count is an exact-stagnation tie on data the
  quartic fits to roundoff, so only its DOFs are compared;
* ``expertsolver_example``: the DOFs against the JAX ``ExpertSolver`` on the
  same neighbourhoods, within 1e-10, and the projection errors the same.

The sharding and driver examples are in ``test_torch_examples_sharding.py``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import defs as jdefs, engine as jengine
from wlsqm_tpu_torch.examples import (expertsolver_example as ex, response_surface as rs,
                                      sudoku_lhs, wlsqm_tour as tour)
from wlsqm_tpu_torch.utils import neighbors

torch.set_num_threads(1)

TOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def original(name):
    """The JAX package's ``examples/<name>.py`` as a module (main() not run)."""
    spec = importlib.util.spec_from_file_location(
        "original_" + name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel_max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1.0))


def test_response_surface_matches_fit_2d_and_meets_its_bar():
    """The copied sampler draws the original's design; the surrogate is
    wt.fit_2D's within 1e-10; the Newton iterate lands within 0.05 of the
    true minimiser."""
    rng_a, rng_b = np.random.default_rng(123), np.random.default_rng(123)
    got = sudoku_lhs.sample(dim=2, m=4, n_per_block=15, rng=rng_a)
    ref = original("sudoku_lhs").sample(dim=2, m=4, n_per_block=15, rng=rng_b)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    pts = 2.0 * got[0] - 1.0
    fvals = rs.objective(pts) + rs.NOISE * rng_a.standard_normal(len(pts))
    fi_ref = np.zeros(15)
    wt.fit_2D(xk=pts, fk=fvals, xi=np.zeros(2), fi=fi_ref, sens=None, do_sens=False,
              order=4, knowns=0, weighting_method=wt.WEIGHT_UNIFORM, debug=False)

    res = rs.run(device="cpu")
    assert res["device"] == "cpu" and res["n"] == 240
    assert rel_max(res["fi"], fi_ref) <= TOL
    assert res["distance"] < rs.TOL and res["surrogate_max_error"] < 0.05


def _tour_reference():
    """The JAX package's calls of the original tour on its draws (seed 42),
    routing stage included for its draws."""
    rng = np.random.default_rng(42)
    out = {}
    xk = rng.uniform(-1, 1, 25)
    fi = np.zeros(4)
    wt.fit_1D(xk=xk, fk=2.0 + xk - 3.0 * xk**2 + 0.5 * xk**3, xi=0.0, fi=fi, sens=None,
              do_sens=False, order=3, knowns=0, weighting_method=wt.WEIGHT_UNIFORM)
    out["tour_1d"] = fi
    xk = rng.uniform(-1, 1, (60, 2))
    x, y = xk[:, 0], xk[:, 1]
    fi = np.zeros(15)
    wt.fit_2D_iterative(xk=xk, fk=x**4 - 2 * x**3 * y + 3 * x * y**3 + x * y - y**2,
                        xi=np.zeros(2), fi=fi, sens=None, do_sens=False, order=4, knowns=0,
                        weighting_method=wt.WEIGHT_UNIFORM, max_iter=10)
    out["tour_2d"] = fi
    rng.uniform(-0.5, 0.5, (5, 2))
    xk = rng.uniform(-1, 1, (20, 2))
    fi = np.zeros(6)
    fi[wt.i2_Y] = 3.0
    wt.fit_2D(xk=xk, fk=1.0 + 2.0 * xk[:, 0] + 3.0 * xk[:, 1] + 0.5 * xk[:, 0] * xk[:, 1],
              xi=np.zeros(2), fi=fi, sens=None, do_sens=False, order=2, knowns=wt.b2_Y,
              weighting_method=wt.WEIGHT_UNIFORM)
    out["tour_knowns"] = fi
    xk = rng.uniform(-1, 1, (15, 2))
    fk = rng.standard_normal(15)
    fi, sens = np.zeros(6), np.zeros((15, 6))
    wt.fit_2D(xk=xk, fk=fk, xi=np.zeros(2), fi=fi, sens=sens, do_sens=True, order=2,
              knowns=0, weighting_method=wt.WEIGHT_CENTER)
    out["tour_sensitivity"] = (fi, sens.sum(0))
    centers = rng.uniform(-1, 1, (10_000, 2))
    xk = centers[:, None, :] + rng.uniform(-0.1, 0.1, (10_000, 20, 2))
    res = wt.fit_many(xk, np.sin(xk[..., 0]) * np.cos(xk[..., 1]), centers, order=2,
                      weighting=wt.WEIGHT_CENTER, backend="xla", precision="f64")
    dx = np.cos(centers[:, 0]) * np.cos(centers[:, 1])
    out["tour_batch"] = float(np.abs(np.asarray(res.fi)[:, wt.i2_X] - dx).max())
    for radius in (1.0, 0.05):
        rng.uniform(-1, 1, (2048, 2))
        rng.uniform(-radius, radius, (2048, 30, 2))
    B, K, NO = 8, 18, 6
    xk = jnp.asarray(rng.uniform(-1, 1, (B, K, 2)))
    fk = jnp.sin(xk[..., 0]) * jnp.cos(xk[..., 1])
    args = (jnp.full((B,), K, jnp.int32), jnp.zeros((B, 2)), jnp.zeros((B, NO)),
            jnp.full((B,), 2, jnp.int32), jnp.zeros((B,), jnp.int64),
            jnp.full((B,), jdefs.WEIGHT_CENTER, jnp.int32))

    def x_deriv_sum(x, f):
        return jengine.fit_batch(x, f, *args, dimension=2, NO=NO)[0][:, wt.i2_X].sum()

    out["tour_autodiff"] = (np.asarray(jax.grad(x_deriv_sum, 1)(xk, fk)),
                            np.asarray(jax.grad(x_deriv_sum, 0)(xk, fk)))
    return out


def test_tour_stages_match_the_jax_calls():
    """Every stage against the JAX package on the original's draws: DOFs,
    the knowns pinned to their bits, the sensitivity column sums, the batch's
    derivative error, and the autograd gradients (data and geometry), each
    within 1e-10; the routing stage reports a verdict and a route per
    radius, the wide radius certified."""
    res = tour.run(device="cpu")
    ref = _tour_reference()
    assert res["device"] == "cpu"
    assert rel_max(res["tour_1d"]["fi"], ref["tour_1d"]) <= TOL
    assert rel_max(res["tour_2d"]["fi"], ref["tour_2d"]) <= TOL
    assert res["tour_2d"]["max_dof_error"] < 1e-12 and res["tour_2d"]["iterations"] >= 1
    assert rel_max(res["tour_knowns"]["fi"], ref["tour_knowns"]) <= TOL
    assert res["tour_knowns"]["fi"][wt.i2_Y] == 3.0
    assert rel_max(res["tour_sensitivity"]["fi"], ref["tour_sensitivity"][0]) <= TOL
    np.testing.assert_allclose(res["tour_sensitivity"]["colsum"], ref["tour_sensitivity"][1],
                               rtol=0, atol=TOL)
    assert abs(res["tour_batch"]["max_dx_error"] - ref["tour_batch"]) <= TOL
    g_fk, g_xk = ref["tour_autodiff"]
    assert rel_max(res["tour_autodiff"]["g_fk"], g_fk) <= TOL
    assert rel_max(res["tour_autodiff"]["g_xk"], g_xk) <= TOL
    assert res["tour_autodiff"]["grad_vs_sens"] < 1e-13
    routing = res["tour_routing"]
    assert set(routing) == {1.0, 0.05} and routing[1.0]["kernel_accuracy_ok"]
    assert all(r["route"] in ("kernel", "kernel-split", "xla") for r in routing.values())


def test_expert_example_matches_the_jax_expert_solver():
    """The DOFs against the JAX ExpertSolver prepared on the same
    neighbourhoods (the host tree's, equal to the device kNN's here), within
    1e-10, and the projection errors within 1e-10 of its own."""
    res = ex.run(device="cpu")
    assert res["device"] == "cpu" and res["npts"] == ex.NPTS
    rng = np.random.default_rng(42)
    pts = rng.uniform(-1, 1, (ex.NPTS, 2))
    idx = neighbors.knn(pts, pts, ex.K + 1, backend="host")[0][:, 1:]
    n = ex.NPTS
    s = wt.ExpertSolver(dimension=2, nk=np.full(n, ex.K, np.int32), order=np.full(n, 2, np.int32),
                        knowns=np.zeros(n, np.int64),
                        weighting_method=np.full(n, wt.WEIGHT_CENTER, np.int32))
    s.prepare(xi=pts, xk=pts[idx])
    fi = np.zeros((n, 6))
    s.solve(fk=ex.field(pts)[idx], fi=fi)
    assert rel_max(res["fi"], fi) <= TOL
    g = np.linspace(-0.9, 0.9, 61)
    grid = np.stack([a.ravel() for a in np.meshgrid(g, g)], -1)
    s.prep_interpolate()
    near, _ = s.interpolate(grid, mode="nearest")
    cont, _ = s.interpolate(grid, mode="continuous", r=0.25)
    truth = ex.field(grid)
    assert abs(res["nearest_max_error"] - np.abs(near - truth).max()) <= TOL
    assert abs(res["continuous_max_error"] - np.abs(cont - truth).max()) <= TOL
