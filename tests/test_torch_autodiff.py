"""Autograd through the port against JAX autodiff through the reference.

The cases of tests/test_autodiff.py that concern the engine, on the same
seeded NumPy inputs: every gradient and Jacobian of the port's f64 engine is
held against ``jax.grad`` / ``jax.jacrev`` of the JAX f64 engine to 1e-10
relative to its largest entry (both are f64 roundoff on moderately
conditioned clouds; measured ~1e-13).  The kernel adjoint cases hold
``fit_rows_diffable``'s plain version to the JAX engine's gradient, never to
the interpreted Pallas kernel (ROADMAP, "Oracle").

The fault these tests pin: the CUDA kernels write their outputs through raw
pointers, so a kernel route under autograd returns a gradient that is
missing or partial.  ``fit_many`` therefore never launches a kernel under
autograd: ``backend="auto"`` runs the engine with a warning, a kernel route
raises, and the wrappers themselves refuse a CUDA input that requires grad.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wlsqm_tpu as wt
import wlsqm_tpu_torch as wtt
from wlsqm_tpu.fitter import defs
from wlsqm_tpu.fitter import engine as jengine
from wlsqm_tpu.fitter import interp as jinterp
from wlsqm_tpu.utils import neighbors as jneighbors
from wlsqm_tpu_torch.fitter import engine, interp
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows, gather, ruiz

torch.set_num_threads(1)

TOL = 1e-10     # relative to the largest entry of the reference's gradient
NO4 = defs.number_of_dofs(2, 4)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _batch(rng, B=4, K=24, dim=2):
    xk = rng.uniform(-1.0, 1.0, (B, K, dim))
    fk = np.sin(1.1 * xk[..., 0]) * np.cos(0.9 * xk[..., 1])
    return xk, fk


def _args(B, K, order, knowns=0, weighting=defs.WEIGHT_CENTER, fi0=None):
    return dict(nk=np.full(B, K, np.int32), xi=np.zeros((B, 2)),
                fi0=np.zeros((B, NO4)) if fi0 is None else fi0,
                order=np.full(B, order, np.int32), knowns=np.full(B, knowns, np.int64),
                weighting=np.full(B, weighting, np.int32))


_KEYS = ("nk", "xi", "fi0", "order", "knowns", "weighting")


def _jfit(xk, fk, a, **kw):
    return jengine.fit_batch(xk, fk, *(jnp.asarray(a[k]) for k in _KEYS), dimension=2,
                             NO=NO4, precision="f64", **kw)


def _tfit(xk, fk, a, **kw):
    return engine.fit_batch(xk, fk, *(torch.as_tensor(a[k]) for k in _KEYS), dimension=2,
                            NO=NO4, **kw)


def test_jacrev_fk_matches_do_sens_and_jax():
    """d fi / d fk by autograd equals the JAX jacrev and the port's own
    do_sens array, and cases are independent (tests/test_autodiff.py:60)."""
    rng = np.random.default_rng(60)
    B, K = 4, 24
    xk, fk = _batch(rng, B, K)
    a = _args(B, K, order=4)
    J = torch.autograd.functional.jacobian(
        lambda f: _tfit(torch.as_tensor(xk), f, a)[0], torch.as_tensor(fk))
    Jj = jax.jacrev(lambda f: _jfit(jnp.asarray(xk), f, a)[0])(jnp.asarray(fk))
    _close(J, Jj)
    _, sens, _, _ = _tfit(torch.as_tensor(xk), torch.as_tensor(fk), a, do_sens=True)
    diag = torch.stack([J[b, :, b, :] for b in range(B)])
    off = sum(float(J[b, :, c, :].abs().max()) for b in range(B) for c in range(B) if b != c)
    assert off == 0.0
    _close(diag, sens.transpose(1, 2).numpy())


def test_grad_wrt_geometry_matches_jax_and_fd():
    """d loss / d xk, which the reference cannot give (tests/test_autodiff.py:76)."""
    rng = np.random.default_rng(76)
    B, K = 3, 24
    xk, fk = _batch(rng, B, K)
    a = _args(B, K, order=3)
    xt = torch.tensor(xk, requires_grad=True)
    (_tfit(xt, torch.as_tensor(fk), a)[0] ** 2).sum().backward()
    gj = jax.grad(lambda x: (_jfit(x, jnp.asarray(fk), a)[0] ** 2).sum())(jnp.asarray(xk))
    _close(xt.grad, gj)

    def loss(x):
        return float((_tfit(torch.as_tensor(x), torch.as_tensor(fk), a)[0] ** 2).sum())

    eps = 1e-6
    for b, k, d in [(0, 0, 0), (1, 5, 1), (2, 17, 0)]:
        pert = np.zeros(xk.shape)
        pert[b, k, d] = eps
        fd = (loss(xk + pert) - loss(xk - pert)) / (2 * eps)
        assert abs(float(xt.grad[b, k, d]) - fd) <= 1e-6 * max(abs(fd), 1.0)


def test_grad_through_fit_many_warns_and_matches_jax():
    """fit_many under autograd runs the engine with a warning naming
    autograd, and its gradient is the JAX traced fit_many's
    (tests/test_autodiff.py:97)."""
    rng = np.random.default_rng(97)
    B, K = 4, 20
    xk, fk = _batch(rng, B, K)
    ft = torch.tensor(fk, requires_grad=True)
    with pytest.warns(UserWarning, match="autograd"):
        res = wtt.fit_many(xk, ft, order=2, weighting=wtt.WEIGHT_CENTER, device="cpu")
    (res.fi ** 2).sum().backward()
    with pytest.warns(UserWarning, match="trac"):
        gj = jax.grad(lambda f: (wt.fit_many(jnp.asarray(xk), f, order=2,
                                             weighting=defs.WEIGHT_CENTER).fi ** 2).sum())(
            jnp.asarray(fk))
    _close(ft.grad, gj)
    # fit() takes the same rule
    f1 = torch.tensor(fk[0], requires_grad=True)
    with pytest.warns(UserWarning, match="autograd"):
        (wtt.fit(xk[0], f1, order=2, weighting=wtt.WEIGHT_CENTER,
                 device="cpu").fi ** 2).sum().backward()
    _close(f1.grad, gj[0])


def test_grad_fk_with_knowns():
    """Known DOFs are constants: zero Jacobian rows; the rest match JAX
    (tests/test_autodiff.py:119)."""
    rng = np.random.default_rng(119)
    B, K = 3, 24
    xk, fk = _batch(rng, B, K)
    fi0 = np.zeros((B, NO4))
    fi0[:, defs.i2_F] = 0.7
    a = _args(B, K, order=2, knowns=int(defs.b2_F), fi0=fi0)
    J = torch.autograd.functional.jacobian(
        lambda f: _tfit(torch.as_tensor(xk), f, a)[0], torch.as_tensor(fk))
    Jj = jax.jacrev(lambda f: _jfit(jnp.asarray(xk), f, a)[0])(jnp.asarray(fk))
    assert float(J[:, defs.i2_F].abs().max()) == 0.0
    _close(J, Jj)


def _noisy(rng, B, K):
    xk, fk = _batch(rng, B, K)
    return xk, fk + 1e-3 * rng.standard_normal(fk.shape)


def test_fixed_trip_iterative_matches_loop_form():
    """fixed_trip=True runs max_iter masked trips with no host read and is
    bit-identical to the loop form, DOFs and counts, on noisy data where
    refinement takes steps; the DOFs match JAX's (tests/test_autodiff.py:172)."""
    rng = np.random.default_rng(172)
    B, K = 8, 24
    xk, fk = _noisy(rng, B, K)
    a = _args(B, K, order=4)
    xt, ft = torch.as_tensor(xk), torch.as_tensor(fk)
    fi_w, _, it_w, _ = _tfit(xt, ft, a, iterative=True, max_iter=5)
    fi_s, _, it_s, _ = _tfit(xt, ft, a, iterative=True, max_iter=5, fixed_trip=True)
    assert torch.equal(fi_w, fi_s) and torch.equal(it_w, it_s)
    assert int(it_w.max()) >= 1
    jfi = _jfit(jnp.asarray(xk), jnp.asarray(fk), a, iterative=True, max_iter=5,
                fixed_trip=True)[0]
    _close(fi_s, jfi)
    # prepared form, F fields at once
    prep = wtt.prepare(xk, np.zeros((B, 2)), order=4, device="cpu")
    fk3 = torch.stack([ft, 2 * ft])
    zero = torch.zeros((2, B, NO4), dtype=torch.float64)
    loop = engine.solve_iterative_prepared(prep, fk3, zero, 4)
    fixed = engine.solve_iterative_prepared(prep, fk3, zero, 4, fixed_trip=True)
    assert torch.equal(loop[0], fixed[0]) and torch.equal(loop[2], fixed[2])


def test_fixed_trip_takes_no_host_read(monkeypatch):
    """The fixed-trip form never asks whether every case is done."""
    rng = np.random.default_rng(173)
    xk, fk = _noisy(rng, 8, 24)
    a = _args(8, 24, order=2)
    prep = engine.prepare(torch.as_tensor(xk), torch.as_tensor(a["nk"]),
                          torch.as_tensor(a["xi"]), torch.as_tensor(a["order"]),
                          torch.as_tensor(a["knowns"]), torch.as_tensor(a["weighting"]),
                          dimension=2, NO=NO4)
    calls = []
    real_all = torch.Tensor.all
    monkeypatch.setattr(torch.Tensor, "all", lambda self, *a, **k: calls.append(1) or
                        real_all(self, *a, **k))
    engine.solve_iterative_prepared(prep, torch.as_tensor(fk), torch.zeros((8, NO4),
                                    dtype=torch.float64), 3, fixed_trip=True)
    assert calls == []
    engine.solve_iterative_prepared(prep, torch.as_tensor(fk), torch.zeros((8, NO4),
                                    dtype=torch.float64), 3)
    assert calls


def test_grad_iterative_fixed_trip_matches_jax():
    """Reverse mode through ALGO_ITERATIVE: the port's gradient (either
    form) equals JAX's through its scan form (tests/test_autodiff.py:207)."""
    rng = np.random.default_rng(207)
    B, K = 3, 24
    xk, fk = _noisy(rng, B, K)
    a = _args(B, K, order=3)
    gj = jax.grad(lambda f: (_jfit(jnp.asarray(xk), f, a, iterative=True, max_iter=3,
                                   fixed_trip=True)[0] ** 2).sum())(jnp.asarray(fk))
    for fixed in (True, False):
        ft = torch.tensor(fk, requires_grad=True)
        (_tfit(torch.as_tensor(xk), ft, a, iterative=True, max_iter=3,
               fixed_trip=fixed)[0] ** 2).sum().backward()
        assert bool(torch.isfinite(ft.grad).all())
        _close(ft.grad, gj)


def test_grad_through_model_evaluation():
    """The gradient of the evaluated model in x is the model's own first
    derivatives, and equals JAX's (tests/test_autodiff.py:247)."""
    rng = np.random.default_rng(247)
    xk = rng.uniform(-0.5, 0.5, (1, 24, 2))
    fk = np.sin(1.1 * xk[..., 0]) * np.cos(0.9 * xk[..., 1])
    a = _args(1, 24, order=4)
    fi = _tfit(torch.as_tensor(xk), torch.as_tensor(fk), a)[0][0]
    xi0 = torch.zeros(2, dtype=torch.float64)
    x = torch.tensor([0.07, -0.04], dtype=torch.float64, requires_grad=True)
    interp.eval_fit(fi, xi0, x[None], dimension=2, order=4, diff=defs.i2_F,
                    device="cpu")[0].backward()
    kw = dict(dimension=2, order=4, device="cpu")
    dx = interp.eval_fit(fi, xi0, x.detach()[None], diff=defs.i2_X, **kw)[0]
    dy = interp.eval_fit(fi, xi0, x.detach()[None], diff=defs.i2_Y, **kw)[0]
    assert abs(float(x.grad[0] - dx)) < 1e-10 and abs(float(x.grad[1] - dy)) < 1e-10
    gj = jax.grad(lambda x_: jinterp.eval_fit(jnp.asarray(fi.numpy()), jnp.zeros(2), x_[None],
                                              dimension=2, order=4, diff=defs.i2_F)[0])(
        jnp.asarray([0.07, -0.04]))
    _close(x.grad, gj)


def test_grad_through_prepared_solve():
    """Reverse mode through prepare / solve, the IBVP inner step
    (tests/test_autodiff.py:269)."""
    rng = np.random.default_rng(269)
    B, K = 8, 20
    xk = rng.uniform(-1.0, 1.0, (B, K, 2))
    fk = np.sin(xk[..., 0])
    prep = wtt.prepare(xk, np.zeros((B, 2)), order=3, device="cpu")
    ft = torch.tensor(fk, requires_grad=True)
    (wtt.solve(prep, ft)[0] ** 2).sum().backward()
    jprep = wt.prepare(xk, np.zeros((B, 2)), order=3, precision="f64")
    gj = jax.grad(lambda f: (wt.solve(jprep, f)[0] ** 2).sum())(jnp.asarray(fk))
    _close(ft.grad, gj)


def test_adjoint_through_time_stepping():
    """The adjoint of a 3-step explicit heat stepper (prepared WLSQM
    Laplacian, neighbours gathered by u[idx]) in the initial condition,
    against JAX (tests/test_autodiff.py:288).  The gather kernel's wrapper
    refuses a u that requires grad: it has no backward."""
    rng = np.random.default_rng(288)
    n, K = 64, 12
    pts = rng.uniform(-1.0, 1.0, (n, 2))
    idx, _ = jneighbors.knn(pts, pts, K + 1, backend="host")
    idx = np.asarray(idx)[:, 1:].astype(np.int32)
    xk = pts[idx]
    lap = [defs.i2_X2, defs.i2_Y2]
    dt = 1e-3
    u0 = np.exp(-4.0 * (pts ** 2).sum(-1))

    prep = wtt.prepare(xk, pts, order=2, device="cpu")
    it = torch.as_tensor(idx).long()
    u = torch.tensor(u0, requires_grad=True)
    uN = u
    for _ in range(3):
        uN = uN + dt * wtt.solve(prep, uN[it])[0][:, lap].sum(-1)
    (uN ** 2).sum().backward()

    jprep = wt.prepare(xk, pts, order=2, precision="f64")
    jidx = jnp.asarray(idx)

    def step(v, _):
        return v + dt * wt.solve(jprep, v[jidx])[0][:, jnp.asarray(lap)].sum(-1), None

    gj = jax.grad(lambda v: (jax.lax.scan(step, v, None, length=3)[0] ** 2).sum())(
        jnp.asarray(u0))
    _close(u.grad, gj)
    plan = gather.plan_window_gather(idx, n)
    with pytest.raises(ValueError, match="no backward"):
        gather.gather_rows(torch.tensor(u0, requires_grad=True), idx, plan)
    with pytest.raises(ValueError, match="no backward"):
        gather.gather_rows_pair((torch.tensor(u0, dtype=torch.float32, requires_grad=True),
                                 torch.zeros(n)), idx, plan)
    with torch.no_grad():
        out = gather.gather_rows(torch.tensor(u0, requires_grad=True), idx, plan)
    assert torch.equal(out, torch.as_tensor(u0)[it])


def _adjoint_case(rng, B, K, order, knowns, gi0):
    xk = rng.uniform(-1.0, 1.0, (B, K, 2))
    fk = np.sin(1.1 * xk[..., 0]) * np.cos(0.9 * xk[..., 1])
    nk = np.full(B, K, np.int32)
    NO = defs.number_of_dofs(2, order)
    gi = np.zeros((B, NO))
    gi[:, defs.i2_F] = gi0
    full = np.zeros((B, NO4))
    full[:, :NO] = gi
    a = _args(B, K, order=order, knowns=knowns, weighting=defs.WEIGHT_UNIFORM, fi0=full)
    gj = jax.grad(lambda f: (_jfit(jnp.asarray(xk), f, a)[0][:, :NO] ** 2).sum())(
        jnp.asarray(fk))
    xt = torch.tensor(xk, requires_grad=True)
    ft = torch.tensor(fk, requires_grad=True)
    fi = fit_rows.fit_rows_diffable(xt, ft, torch.as_tensor(nk), torch.zeros((B, 2),
                                    dtype=torch.float64), torch.as_tensor(gi),
                                    dimension=2, order=order,
                                    weighting=defs.WEIGHT_UNIFORM, knowns=knowns)
    (fi ** 2).sum().backward()
    return ft.grad, xt.grad, gj


def test_kernel_adjoint_matches_engine_grad():
    """fit_rows_diffable (its plain version here) against the JAX engine's
    gradient; geometry gradients are stopped (tests/test_autodiff.py:321)."""
    gk, gx, gj = _adjoint_case(np.random.default_rng(321), 256, 16, 2, 0, 0.0)
    _close(gk, gj)
    assert gx is None


def test_kernel_adjoint_with_knowns():
    """Known DOFs are constants under the adjoint: their NaN sens columns
    add nothing (tests/test_autodiff.py:352)."""
    gk, _, gj = _adjoint_case(np.random.default_rng(352), 256, 16, 2,
                              int(defs.b2_F), 0.3)
    assert bool(torch.isfinite(gk).all())
    _close(gk, gj)


def test_ruiz_scales_carry_no_history():
    """The scale factors are detached, as the reference's stop_gradient
    has them (wlsqm_tpu/ops/ruiz.py:101, 127)."""
    A = torch.eye(4, dtype=torch.float64).expand(3, 4, 4) * torch.tensor(
        [2.0, 3.0, 5.0, 7.0], dtype=torch.float64)
    A = A.clone().requires_grad_(True)
    for fn in (ruiz.ruiz_scale, ruiz.jacobi_scale):
        r, c, _ = fn(A)
        assert r.grad_fn is None and c.grad_fn is None and not r.requires_grad


def _raise(*a, **k):
    raise AssertionError("a kernel wrapper was reached under autograd")


@pytest.mark.parametrize("order,do_sens", [(4, False), (2, False), (4, True)])
def test_fit_many_under_autograd_never_reaches_a_kernel(monkeypatch, order, do_sens):
    """The CPU-side test of the gradient fault: with the kernel wrappers
    made to raise, fit_many with fk.requires_grad reaches neither of them,
    warns, and returns the engine's gradient; a kernel route raises; under
    torch.no_grad() the route is the kernel again."""
    rng = np.random.default_rng(400 + order)
    B, K = 64, 30
    xk, fk = _batch(rng, B, K)
    kw = dict(order=order, weighting=wtt.WEIGHT_CENTER, do_sens=do_sens, device="cpu")
    plan = wtt.plan_fit_many(xk, order=order, weighting=wtt.WEIGHT_CENTER,
                             do_sens=do_sens, device="cpu")
    assert plan.route.path == "kernel"
    calls = []
    for mod, name in ((fit_kernel, "fit_kernel"), (fit_rows, "fit_rows")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: calls.append(1) or _r(*a, **k))
    with torch.no_grad():
        wtt.fit_many(xk, torch.tensor(fk, requires_grad=True), plan=plan, **kw)
    assert calls          # the route launches a kernel when nothing is recorded
    for mod, name in ((fit_kernel, "fit_kernel"), (fit_rows, "fit_rows")):
        monkeypatch.setattr(mod, name, _raise)

    ft = torch.tensor(fk, requires_grad=True)
    with pytest.warns(UserWarning, match="autograd"):
        res = wtt.fit_many(xk, ft, **kw)
    (res.fi ** 2).sum().backward()
    NO = defs.number_of_dofs(2, order)
    ft2 = torch.tensor(fk, requires_grad=True)
    a = _args(B, K, order=order)
    (_tfit(torch.as_tensor(xk), ft2, a)[0][:, :NO] ** 2).sum().backward()
    _close(ft.grad, ft2.grad.numpy(), 1e-13)
    for bad in (dict(backend="kernel"), dict(plan=plan)):
        with pytest.raises(ValueError, match="fit_rows_diffable"):
            wtt.fit_many(xk, ft, **kw, **bad)
    # geometry that autograd records: the same rule, and the engine's gradient
    xt = torch.tensor(xk, requires_grad=True)
    with pytest.warns(UserWarning, match="autograd"):
        (wtt.fit_many(xt, fk, **kw).fi ** 2).sum().backward()
    assert bool(torch.isfinite(xt.grad).all()) and float(xt.grad.abs().max()) > 0
    with pytest.warns(UserWarning, match="autograd"):
        p = wtt.plan_fit_many(xt, order=order, weighting=wtt.WEIGHT_CENTER,
                              do_sens=do_sens, device="cpu")
    assert p.route.path == "xla"
    # an integer nk, and backend="engine", raise nothing and warn nothing
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        wtt.fit_many(xk, ft, nk=np.full(B, K, np.int32), backend="engine", **kw)


def test_kernel_wrappers_refuse_grad():
    """The wrappers' own rule, checked before any launch on a CUDA input:
    an input autograd would record raises; under no_grad, or with no input
    requiring grad, nothing does."""
    from wlsqm_tpu_torch import config

    with pytest.raises(ValueError, match="no backward"):
        config.refuse_grad("fit_kernel", "hint", torch.zeros(2, requires_grad=True))
    config.refuse_grad("fit_kernel", "hint", torch.zeros(2), None)
    with torch.no_grad():
        config.refuse_grad("fit_kernel", "hint", torch.zeros(2, requires_grad=True))
