"""The port's time-stepping and gradient examples against their JAX originals.

Each example of ``wlsqm_tpu_torch/examples`` runs with ``device="cpu"`` on
the inputs of its original in ``examples/`` (loaded from its file; nothing
of ``examples/`` is a package), and is held to the original or to the JAX
f64 engine on the same inputs (never to an interpreted Pallas kernel):

* ``euler_flow``: the port's cloud is the original's recipe, its boundary
  band gives the full 3x3 tiling's neighbours bit for bit, and U after
  three SSP-RK3 steps is within 1e-10 of a JAX step built as the original
  builds it (``wt.prepare`` / ``wt.solve`` and ``fl[own]``), relative to
  max(|U|, 1).  Two f64 solves of one system differ by ~cond * eps, and a
  step adds the fluxes' rounding (measured ~1e-14);
* ``adjoint_data_recovery``: the loss gradient at the first two steps
  against ``jax.grad`` through ``engine.fit_batch(precision="f64")``,
  within 1e-10 of its largest entry (the rows body's plain version and the
  engine solve one well-conditioned order-2 system each);
* ``gradient_stencil_design``: the amplification and its geometry gradient
  at the start against the original's ``jax.grad``, within 1e-10 relative.

Every ``run(device="cpu")`` meets its original's bar.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import defs as jdefs, engine as jengine
from wlsqm_tpu.ops import gather as jgather
from wlsqm_tpu.utils import neighbors as jneighbors
from wlsqm_tpu_torch.examples import (adjoint_data_recovery as ad, euler_flow as ef,
                                      gradient_stencil_design as sd)
from wlsqm_tpu_torch.utils import neighbors

torch.set_num_threads(1)

TOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def original(name):
    """The JAX example ``examples/<name>.py`` as a module (main() not run)."""
    spec = importlib.util.spec_from_file_location(
        "original_" + name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel_max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1.0))


# ---------------------------------------------------------------------------
# euler_flow
# ---------------------------------------------------------------------------

def test_euler_cloud_and_band_are_the_originals():
    """The Morton-ordered jittered cloud is the original's (l.80-85, the JAX
    package's Morton order), and the boundary band's neighbourhoods (ghost
    positions and owners) equal the full 3x3 tiling's, which equal the JAX
    package's host kNN on that tiling (l.87-95)."""
    n = ef.NSIDE ** 2
    rng = np.random.default_rng(42)
    g = (np.arange(ef.NSIDE) + 0.5) * (ef.L / ef.NSIDE)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    pts += rng.uniform(-0.25, 0.25, pts.shape) * (ef.L / ef.NSIDE)
    pts %= ef.L
    pts = pts[jgather.morton_order(pts)]
    np.testing.assert_array_equal(ef.cloud(ef.NSIDE), pts)

    xk_b, own_b, width = ef.periodic_neighbours(pts, ef.K, band=True)
    xk_f, own_f, none = ef.periodic_neighbours(pts, ef.K, band=False)
    assert none is None and 0 < width < ef.L / 2
    np.testing.assert_array_equal(xk_b, xk_f)
    np.testing.assert_array_equal(own_b, own_f)

    shifts = np.array([(i, j) for i in (-ef.L, 0.0, ef.L) for j in (-ef.L, 0.0, ef.L)])
    tiled = (pts[None, :, :] + shifts[:, None, :]).reshape(-1, 2)
    idx = np.asarray(jneighbors.knn(tiled, pts, ef.K + 1, backend="host")[0])[:, 1:]
    np.testing.assert_array_equal(xk_f, tiled[idx])
    np.testing.assert_array_equal(own_f, idx % n)


def _jax_euler_steps(orig, pts, xk, own, dt, nsteps):
    """The original's step (l.98-141): wt.prepare once, fl[own], one
    multi-field wt.solve per stage."""
    prep = wt.prepare(jnp.asarray(xk), jnp.asarray(pts), order=3, weighting=wt.WEIGHT_CENTER)
    own_j = jnp.asarray(own)
    gamma = orig.GAMMA

    def flux_fields(U):
        rho, mx, my, E = U[:, 0], U[:, 1], U[:, 2], U[:, 3]
        u, v = mx / rho, my / rho
        p = (gamma - 1) * (E - 0.5 * rho * (u * u + v * v))
        F = jnp.stack([mx, mx * u + p, my * u, (E + p) * u], -1)
        G = jnp.stack([my, mx * v, my * v + p, (E + p) * v], -1)
        return jnp.concatenate([F, G], -1)

    def rhs(U):
        fi, _ = wt.solve(prep, jnp.moveaxis(flux_fields(U)[own_j], -1, 0))
        return -(fi[:4, :, wt.i2_X] + fi[4:, :, wt.i2_Y]).T

    @jax.jit
    def step(U):
        U1 = U + dt * rhs(U)
        U2 = 0.75 * U + 0.25 * (U1 + dt * rhs(U1))
        return U / 3.0 + 2.0 / 3.0 * (U2 + dt * rhs(U2))

    U = jnp.asarray(orig.conservative(*orig.vortex_primitive(pts, 0.0)))
    for _ in range(nsteps):
        U = step(U)
    return np.asarray(U)


def test_euler_three_steps_match_the_jax_step():
    """U after three SSP-RK3 steps at nside 48 (the gather's plain version
    on the CPU): within 1e-10 of the original's step relative to
    max(|U|, 1); the initial state is the original's exact vortex."""
    orig = original("euler_flow")
    flow = ef.setup(ef.NSIDE, ef.K, device="cpu")
    dt = ef.cfl_dt(ef.NSIDE)
    U0 = flow.initial()
    np.testing.assert_array_equal(
        U0.numpy(), orig.conservative(*orig.vortex_primitive(flow.pts, 0.0)))
    U = U0
    for _ in range(3):
        U = flow.step(U, dt)
    xk, own, _ = ef.periodic_neighbours(flow.pts, ef.K)
    ref = _jax_euler_steps(orig, flow.pts, xk, own, dt, 3)
    assert rel_max(U.numpy(), ref) <= TOL
    assert rel_max(U.numpy(), U0.numpy()) > 1e-4      # the state did move


def test_euler_run_meets_its_bar():
    """The example's own configuration to t_end = 1 (42 steps): the density
    error under the original's 2e-2, every gather through gather_rows'
    plain version (no launch on the CPU), the plan's coverage reported."""
    res = ef.run(device="cpu")
    assert res["device"] == "cpu" and res["steps"] == 42 and res["finite"]
    assert res["t_final"] == pytest.approx(1.0) and res["max_error"] < ef.TOL
    assert res["gather_launches"] == 0 and 0.5 < res["coverage"] <= 1.0
    assert set(res["setup_s"]) == {"cloud_morton_s", "neighbours_s", "plan_s", "prepare_s"}


# ---------------------------------------------------------------------------
# adjoint_data_recovery
# ---------------------------------------------------------------------------

def _jax_grad(p, u):
    B, K = p.idx.shape
    idx = jnp.asarray(p.idx.numpy())
    args = (jnp.asarray(p.xk.numpy()), None, jnp.full((B,), K, jnp.int32),
            jnp.asarray(p.xi.numpy()), jnp.zeros((B, 6)), jnp.full((B,), 2, jnp.int32),
            jnp.zeros((B,), jnp.int64), jnp.full((B,), jdefs.WEIGHT_CENTER, jnp.int32))
    g, u_obs = jnp.asarray(p.g.numpy()), jnp.asarray(p.u_obs.numpy())

    def loss(u):
        a = list(args)
        a[1] = u[idx]
        fi, _, _, _ = jengine.fit_batch(*a, dimension=2, NO=6, precision="f64")
        r = fi[:, jdefs.i2_X2] + fi[:, jdefs.i2_Y2] - g
        return (r ** 2).mean() + ad.LAM * ((u - u_obs) ** 2).mean()

    return np.asarray(jax.grad(loss)(jnp.asarray(u.numpy())))


def test_adjoint_gradients_match_jax_grad_through_the_engine():
    """The loss gradient at the first two steps of the recovery (at u_obs,
    then at the port's first update) against jax.grad through the JAX f64
    engine on the same inputs: within 1e-10 of its largest entry.  The
    neighbourhoods are the original's dense argsort."""
    p = ad.problem(device="cpu")
    u = p.u_obs.clone()
    for _ in range(2):
        _, grad = ad.loss_and_grad(p, u)
        ref = _jax_grad(p, u)
        assert np.abs(grad.numpy() - ref).max() <= TOL * np.abs(ref).max()
        u = ad.update(u, grad)


def test_adjoint_host_knn_on_the_grid_is_the_dense_shell():
    """On the 32 x 32 grid the host k-d tree (what the 2^20 grid uses) finds
    the dense argsort's neighbour distances; the sets are equal wherever the
    12th distance is not tied with the 13th (a regular grid's shells tie,
    so orders and a cut shell may differ)."""
    pts = ad.problem(device="cpu").pts
    dense = ad.dense_neighbours(pts, ad.K)
    idx, d2 = neighbors.knn(pts, pts, ad.K + 2, backend="host")
    d2_dense = np.sort(((pts[dense] - pts[:, None, :]) ** 2).sum(-1), axis=1)
    np.testing.assert_allclose(d2[:, 1:ad.K + 1], d2_dense, rtol=0, atol=1e-15)
    untied = ~np.isclose(d2[:, ad.K], d2[:, ad.K + 1], rtol=1e-12, atol=0)
    assert untied.mean() > 0.5
    for b in np.nonzero(untied)[0]:
        assert set(idx[b, 1:ad.K + 1]) == set(dense[b]), b


def test_adjoint_run_meets_its_bar():
    """60 steps on the 32 x 32 grid: the recovered error under 0.6 times the
    noisy data's (measured 0.0160 against 0.0415, the original's numbers)."""
    res = ad.run(device="cpu")
    assert res["device"] == "cpu" and res["B"] == 1024 and res["steps"] == ad.STEPS
    assert res["recovered_rel_error"] < ad.GAIN * res["noisy_rel_error"]
    assert res["last_loss"] < res["first_loss"]


# ---------------------------------------------------------------------------
# gradient_stencil_design
# ---------------------------------------------------------------------------

def test_stencil_amplification_and_its_gradient_match_jax():
    """At the starting stencil: the X DOF's noise amplification and the
    objective's gradient in the neighbour positions against the original's
    engine call under jax.grad, within 1e-10 relative."""
    orig = original("gradient_stencil_design")
    xk0 = sd.start_stencil()
    ref_amp = float(orig.amplification(jnp.asarray(xk0)))
    ref_grad = np.asarray(jax.grad(orig.objective)(jnp.asarray(xk0)))
    t = torch.as_tensor(xk0)
    assert abs(float(sd.amplification(t)) - ref_amp) <= TOL * ref_amp
    assert rel_max(sd.grad_objective(t).numpy(), ref_grad) <= TOL


def test_stencil_run_meets_its_bars():
    """200 descent steps: the amplification under 0.55 of its start, and
    Monte Carlo within 15% of the prediction (the original's two asserts)."""
    res = sd.run(device="cpu")
    assert res["device"] == "cpu" and res["steps"] == sd.STEPS
    assert res["amp_optimized"] < sd.GAIN * res["amp_initial"]
    assert abs(res["mc_optimized"] - res["amp_optimized"]) < sd.MC_TOL * res["amp_optimized"]
