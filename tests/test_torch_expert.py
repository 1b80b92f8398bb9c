"""The port's ExpertSolver against the JAX package's, case by case.

The cases of tests/test_expert.py, each run through both packages on the
same NumPy inputs: fi and sens are held to 1e-10 relative to max(|ref|, 1)
per case (``torch_port_cases.rel_err``), and the port also to the test's
own exact answer.  ALGO_ITERATIVE counts: the port's equals the largest
count its own f64 engine gives the same batch; against the JAX package's,
the per-case counts agree only at the rate their histograms imply (the
last bits of the residual norm decide them; tests/test_torch_simple.py
holds the histograms), so no per-call bar is set.  On the CPU the JAX
package never routes through a kernel (Pallas is interpreted there); the
port's solve always back-substitutes the prepared factor, and the tests
at B = 1024 check that no kernel and no plan is touched.
"""

import numpy as np
import pytest
import torch

import wlsqm_tpu as wt
import wlsqm_tpu_torch as wtt
from conftest import quadratic_2d, quadratic_3d
from torch_port_cases import rel_err
from wlsqm_tpu_torch import api
from wlsqm_tpu_torch import config as tconfig
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

torch.set_num_threads(1)

TOL = 1e-10


@pytest.fixture(autouse=True)
def _restore_knobs():
    """The compat knobs are module globals in both packages."""
    from wlsqm_tpu import config as jconfig

    saved = [(m, m._COMPAT_PRECISION, m._ITER_COUNT_FIDELITY)
             for m in (jconfig, tconfig)]
    yield
    for m, cp, fid in saved:
        m._COMPAT_PRECISION, m._ITER_COUNT_FIDELITY = cp, fid


def _kw(ncases, npts, order=2, dimension=2, weighting=None, **extra):
    return dict(dimension=dimension, nk=np.full(ncases, npts, np.int32),
                order=np.full(ncases, order, np.int32),
                knowns=np.zeros(ncases, np.int64),
                weighting_method=np.full(
                    ncases, wt.WEIGHT_UNIFORM if weighting is None else weighting,
                    np.int32), **extra)


def _pair(kw, xi, xk, **extra):
    """Prepared solvers of both packages on the same geometry."""
    j = wt.ExpertSolver(**kw, **extra)
    j.prepare(xi=xi, xk=xk)
    t = wtt.ExpertSolver(**kw, **extra, device="cpu")
    t.prepare(xi=xi, xk=xk)
    return j, t


def _solve_both(j, t, fk, NO, K=None, fi0=None, do_sens=False):
    out = []
    for s in (j, t):
        fi = np.zeros((s.ncases, NO)) if fi0 is None else fi0.copy()
        sens = np.zeros((s.ncases, K, NO)) if do_sens else None
        it = s.solve(fk=fk, fi=fi, sens=sens)
        out.append((fi, sens, it))
    return out


def _cloud(rng, B, K, dim=2, spread=0.6):
    xi = rng.uniform(-1, 1, (B, dim))
    return xi, xi[:, None, :] + rng.uniform(-spread, spread, (B, K, dim))


def test_single_case_matches_fit_2d(rng):
    f, expected = quadratic_2d()
    xk = rng.uniform(-1, 1, (30, 2))
    fk = f(xk)
    fi_ref = np.zeros(6)
    wtt.fit_2D(xk=xk, fk=fk, xi=np.zeros(2), fi=fi_ref, sens=None, do_sens=False,
               order=2, knowns=0, weighting_method=wt.WEIGHT_UNIFORM, debug=False,
               device="cpu")
    j, t = _pair(_kw(1, 30), np.zeros((1, 2)), xk[None])
    (jfi, _, _), (tfi, _, _) = _solve_both(j, t, fk[None], 6)
    np.testing.assert_allclose(tfi[0], fi_ref, atol=1e-13)
    np.testing.assert_allclose(tfi[0], expected, atol=1e-10)
    assert rel_err(tfi, jfi) <= TOL


def test_prepare_once_solve_twice(rng):
    f1, e1 = quadratic_2d()
    xk = rng.uniform(-1, 1, (1, 30, 2))
    j, t = _pair(_kw(1, 30), np.zeros((1, 2)), xk)
    for shift in (0.0, 7.5):
        (jfi, _, _), (tfi, _, _) = _solve_both(j, t, (f1(xk[0]) + shift)[None], 6)
        e = e1.copy()
        e[wt.i2_F] += shift
        np.testing.assert_allclose(tfi[0], e, atol=1e-10)
        assert rel_err(tfi, jfi) <= TOL


def test_iterative_matches_basic(rng):
    f, expected = quadratic_2d()
    xi, xk = np.zeros((16, 2)), rng.uniform(-1, 1, (16, 30, 2))
    fk = f(xk)
    out = {}
    for algo in (wt.ALGO_BASIC, wt.ALGO_ITERATIVE):
        j, t = _pair(_kw(16, 30, algorithm=algo), xi, xk)
        out[algo] = _solve_both(j, t, fk, 6)
    (jb, _, _), (tb, _, tib) = out[wt.ALGO_BASIC]
    (ji, _, jit), (ti, _, tit) = out[wt.ALGO_ITERATIVE]
    assert tib == 0
    np.testing.assert_allclose(ti, tb, atol=1e-12)
    np.testing.assert_allclose(ti, np.tile(expected, (16, 1)), atol=1e-9)
    assert rel_err(ti, ji) <= TOL and rel_err(tb, jb) <= TOL
    # the count is the largest of the port's f64 engine on the same batch
    # (exact-stagnation ties decide it, in each package differently)
    eng = api.fit_many(xk, fk, xi, order=2, iterative=True, backend="engine",
                       device="cpu")
    assert tit == int(eng.iterations.max()) and 1 <= jit <= 10


def test_3d_case(rng):
    f, expected = quadratic_3d()
    xk = rng.uniform(-1, 1, (1, 40, 3))
    j, t = _pair(_kw(1, 40, dimension=3), np.zeros((1, 3)), xk)
    (jfi, _, _), (tfi, _, _) = _solve_both(j, t, f(xk[0])[None], 10)
    np.testing.assert_allclose(tfi[0], expected, atol=1e-10)
    assert rel_err(tfi, jfi) <= TOL


def test_guest_mode_shares_geometry(rng):
    f, expected = quadratic_2d()
    xk = rng.uniform(-1, 1, (4, 25, 2))
    fk = f(xk)
    host = wtt.ExpertSolver(**_kw(4, 25), device="cpu")
    host.prepare(xi=np.zeros((4, 2)), xk=xk)
    guest = wtt.ExpertSolver(**_kw(4, 25), host=host, device="cpu")
    guest.prepare(xi=np.zeros((4, 2)), xk=xk)
    assert guest.prepared is host.prepared     # shared, not recomputed
    fi = np.zeros((4, 6))
    guest.solve(fk=fk, fi=fi)
    np.testing.assert_allclose(fi, np.tile(expected, (4, 1)), atol=1e-10)
    jfi = np.zeros((4, 6))
    jh = wt.ExpertSolver(**_kw(4, 25))
    jh.prepare(xi=np.zeros((4, 2)), xk=xk)
    jg = wt.ExpertSolver(**_kw(4, 25), host=jh)
    jg.prepare(xi=np.zeros((4, 2)), xk=xk)
    jg.solve(fk=fk, fi=jfi)
    assert rel_err(fi, jfi) <= TOL


@pytest.mark.parametrize("pkg", [wt, wtt], ids=["jax", "torch"])
def test_guest_mode_validation(rng, pkg):
    """The same exceptions in both packages: an unprepared host, then a
    ncases (RuntimeError) and an order (ValueError) mismatch."""
    dev = {} if pkg is wt else {"device": "cpu"}
    host = pkg.ExpertSolver(**_kw(2, 10), **dev)
    with pytest.raises(RuntimeError, match="ready state"):
        pkg.ExpertSolver(**_kw(2, 10), host=host, **dev)
    host.prepare(xi=np.zeros((2, 2)), xk=rng.uniform(-1, 1, (2, 10, 2)))
    with pytest.raises(RuntimeError, match="number of cases"):
        pkg.ExpertSolver(**_kw(3, 10), host=host, **dev)
    with pytest.raises(ValueError, match="'order' must match"):
        pkg.ExpertSolver(**_kw(2, 10, order=3), host=host, **dev)
    with pytest.raises(ValueError, match="debug flag"):
        pkg.ExpertSolver(**_kw(2, 10), host=host, debug=True, **dev)


@pytest.mark.parametrize("pkg", [wt, wtt], ids=["jax", "torch"])
def test_constructor_validation(pkg):
    nk = np.full(4, 10, np.int64)
    with pytest.raises(ValueError, match="order must be a 1D per-case array"):
        pkg.ExpertSolver(dimension=2, nk=nk, order=2, knowns=np.zeros(4, np.int64),
                         weighting_method=np.full(4, 1, np.int32))
    with pytest.raises(ValueError, match="knowns must be a 1D per-case array"):
        pkg.ExpertSolver(dimension=2, nk=nk, order=np.full(4, 2, np.int32), knowns=0,
                         weighting_method=np.full(4, 1, np.int32))
    with pytest.raises(ValueError, match="same length"):
        pkg.ExpertSolver(dimension=2, nk=nk, order=np.full(3, 2, np.int32),
                         knowns=np.zeros(4, np.int64),
                         weighting_method=np.full(4, 1, np.int32))
    mk = dict(nk=nk, order=np.full(4, 2, np.int32), knowns=np.zeros(4, np.int64),
              weighting_method=np.full(4, 1, np.int32))
    with pytest.raises(ValueError, match="Dimension must be 1, 2 or 3"):
        pkg.ExpertSolver(dimension=4, **mk)
    with pytest.raises(TypeError, match="single ALGO_"):
        pkg.ExpertSolver(dimension=2, algorithm=np.full(4, wt.ALGO_BASIC), **mk)
    pkg.ExpertSolver(dimension=2, algorithm=np.int32(wt.ALGO_ITERATIVE), **mk)
    pkg.ExpertSolver(dimension=2, algorithm=np.array([wt.ALGO_BASIC]), **mk)
    with pytest.raises(ValueError, match="Unknown algorithm"):
        pkg.ExpertSolver(dimension=2, algorithm=7, **mk)
    with pytest.raises(ValueError, match="ntasks"):
        pkg.ExpertSolver(dimension=2, ntasks=0, **mk)


def test_port_refuses_unknown_precision_and_solver():
    mk = _kw(4, 10)
    with pytest.raises(ValueError, match="precision"):
        wtt.ExpertSolver(precision="bogus", **mk)
    with pytest.raises(ValueError, match="unknown solver"):
        wtt.ExpertSolver(solver="qr", **mk)


def test_conds_requires_debug_and_matches_jax(rng):
    xi, xk = _cloud(rng, 8, 20)
    j, t = _pair(_kw(8, 20), xi, xk)
    for s in (j, t):
        with pytest.raises(RuntimeError, match="debug"):
            s.conds()
    j, t = _pair(_kw(8, 20), xi, xk, debug=True)
    tc, jc = t.conds(), j.conds()
    assert tc.shape == (8,) and np.isfinite(tc).all() and (tc >= 1.0).all()
    np.testing.assert_allclose(tc, jc, rtol=1e-9)


@pytest.mark.parametrize("pkg", [wt, wtt], ids=["jax", "torch"])
def test_calls_before_prepare_raise(pkg):
    s = pkg.ExpertSolver(**_kw(1, 20), **({} if pkg is wt else {"device": "cpu"}))
    for call in (lambda: s.solve(fk=np.zeros((1, 20)), fi=np.zeros((1, 6))),
                 lambda: s.conds(), lambda: s.prep_interpolate(),
                 lambda: s.solve_device(np.zeros((1, 20)))):
        with pytest.raises(RuntimeError, match="prepare"):
            call()
    with pytest.raises(RuntimeError, match="prepare"):
        next(s.solve_stream(iter([np.zeros((1, 20))])))


def test_interpolate_nearest_and_continuous(rng):
    f, _ = quadratic_2d()
    gx, gy = np.meshgrid(np.linspace(-1, 1, 3), np.linspace(-1, 1, 3))
    xi = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (9, 25, 2))
    j, t = _pair(_kw(9, 25), xi, xk)
    _solve_both(j, t, f(xk), 6)
    for s in (j, t):
        s.prep_interpolate()
    q = rng.uniform(-0.9, 0.9, (40, 2))
    out, idx = t.interpolate(q, mode="nearest")
    jout, jidx = j.interpolate(q, mode="nearest")
    np.testing.assert_allclose(out, f(q), atol=1e-9)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-12)
    out2, _ = t.interpolate(q, mode="nearest", I=idx)
    np.testing.assert_array_equal(out2, out)
    outc, idxc = t.interpolate(q, mode="continuous", r=1.5)
    assert idxc is None
    np.testing.assert_allclose(outc, f(q), atol=1e-9)
    np.testing.assert_allclose(outc, j.interpolate(q, mode="continuous", r=1.5)[0],
                               rtol=0, atol=1e-12)
    ddx, _ = t.interpolate(q, mode="nearest", diff=wt.i2_X)
    np.testing.assert_allclose(ddx, 2 + 4 * q[:, 1] + 10 * q[:, 0], atol=1e-9)
    with pytest.raises(ValueError, match="mode"):
        t.interpolate(q, mode="bogus")
    with pytest.raises(ValueError, match="r must be specified"):
        t.interpolate(q, mode="continuous")
    with pytest.raises(ValueError, match="same length"):
        t.interpolate(q, I=idx[:3])


def test_interpolate_needs_index_and_solve(rng):
    xi, xk = _cloud(rng, 4, 20)
    s = wtt.ExpertSolver(**_kw(4, 20), device="cpu")
    s.prepare(xi=xi, xk=xk)
    with pytest.raises(RuntimeError, match="prep_interpolate"):
        s.interpolate(xi)
    s.prep_interpolate()
    with pytest.raises(RuntimeError, match="solve"):
        s.interpolate(xi)
    with pytest.raises(RuntimeError, match="solve"):
        s.interpolate(xi, mode="continuous", r=0.5, device=True)


def test_memory_used_reports_the_prepared_bytes(rng):
    xi, xk = _cloud(rng, 3, 20)
    s = wtt.ExpertSolver(**_kw(3, 20), device="cpu")
    assert s.memory_used() == (0, 0)
    s.prepare(xi=xi, xk=xk)
    used, total = s.memory_used()
    p = s.prepared
    c_bytes = 3 * 20 * 6 * 8
    assert used == total and used > c_bytes + p.fac[0].numel() * 8
    assert used == sum(t.numel() * t.element_size() for t in (
        p.c, p.w, *p.fac, p.row_scale, p.col_scale, p.active, p.known, p.unknown,
        p.xi, p.cond_orig, p.cond_scaled, p.ruiz_iters))


def test_conds_estimate_matches_debug_and_jax(rng):
    """Power-iteration estimates track the SVD conditions (the band of
    tests/test_expert.py) and the JAX package's estimates."""
    B, K = 32, 18
    xi, xk = _cloud(rng, B, K, spread=0.3)
    kw = _kw(B, K)
    exact = wtt.ExpertSolver(**kw, debug=True, device="cpu")
    exact.prepare(xi=xi, xk=xk)
    j, t = _pair(kw, xi, xk)
    est = t.conds(estimate=True)
    assert est.shape == (B,)
    assert np.all(est <= exact.conds() * 1.01)
    assert np.all(est >= exact.conds() * 0.5)
    np.testing.assert_allclose(est, j.conds(estimate=True), rtol=1e-9)


def test_interpolate_continuous_device_mode(rng):
    B, K = 48, 14
    xi, xk = _cloud(rng, B, K, spread=0.3)
    f, _ = quadratic_2d()
    j, t = _pair(_kw(B, K), xi, xk)
    _solve_both(j, t, f(xk), 6)
    q = rng.uniform(-0.9, 0.9, (31, 2))
    got, idx = t.interpolate(q, mode="continuous", r=0.5, device=True)
    assert idx is None
    jgot, _ = j.interpolate(q, mode="continuous", r=0.5, device=True)
    t.prep_interpolate()
    ref, _ = t.interpolate(q, mode="continuous", r=0.5)
    mask = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), mask)
    np.testing.assert_allclose(got[mask], ref[mask], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[mask], jgot[mask], rtol=1e-12, atol=1e-12)


def _eligible(rng, B=1024, order=2, **extra):
    xi, xk = _cloud(rng, B, 30, spread=0.5)
    return xi, xk, _kw(B, 30, order=order, weighting=wt.WEIGHT_CENTER, **extra)


def _no_kernel(monkeypatch):
    """Make every kernel wrapper and the planner fail the test when called."""
    for mod, name in ((fit_kernel, "fit_kernel"), (fit_rows, "fit_rows"),
                      (api, "plan_fit_many"), (api, "fit_many")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: pytest.fail(
            "ExpertSolver.solve called %s" % _n))


def test_solve_at_1024_cases_stays_on_the_prepared_path(rng, monkeypatch):
    """A default-precision solver at B = 1024 (the JAX package's kernel
    tile) back-substitutes its prepared factor: no kernel, no plan; it
    agrees with the JAX package's prepared path and writes the active DOFs."""
    xi, xk, kw = _eligible(rng)
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])
    j, t = _pair(kw, xi, xk)
    _no_kernel(monkeypatch)
    fi0 = np.full((t.ncases, 6), 5.0)
    (jfi, _, _), (tfi, _, it) = _solve_both(j, t, fk, 6, fi0=fi0)
    assert it == 0
    assert rel_err(tfi, jfi) <= TOL


def test_sens_solve_at_1024_cases_matches_jax(rng, monkeypatch):
    xi, xk, kw = _eligible(rng, do_sens=True)
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])
    j, t = _pair(kw, xi, xk)
    _no_kernel(monkeypatch)
    (jfi, jsens, _), (tfi, tsens, _) = _solve_both(j, t, fk, 6, K=30, do_sens=True)
    assert rel_err(tfi, jfi) <= TOL and rel_err(tsens, jsens) <= TOL


@pytest.mark.parametrize("how", ["precision_f64", "compat_f64", "iter_fidelity",
                                 "small_batch", "heterogeneous"])
def test_what_keeps_solves_on_the_prepared_path(rng, monkeypatch, how):
    """An explicit precision='f64', set_compat_precision('f64'), ALGO_ITERATIVE
    under count fidelity (the compat default), fewer than 1024 cases and a
    heterogeneous batch all solve on the prepared path, as the default does."""
    extra = {}
    B = 1024
    if how == "precision_f64":
        extra = dict(precision="f64")
    elif how == "iter_fidelity":
        extra = dict(algorithm=wt.ALGO_ITERATIVE)
    elif how == "small_batch":
        B -= 1
    xi, xk, kw = _eligible(rng, B=B, **extra)
    if how == "heterogeneous":
        kw["order"][::2] = 1
    if how == "compat_f64":
        wtt.set_compat_precision("f64")
    t = wtt.ExpertSolver(**kw, device="cpu")
    t.prepare(xi=xi, xk=xk)
    _no_kernel(monkeypatch)
    fi = np.zeros((B, 6))
    t.solve(np.sin(xk[..., 0]), fi)
    assert np.isfinite(fi).all()


def test_iterative_with_fidelity_off_matches_jax(rng, monkeypatch):
    """With count fidelity off the JAX package may take its kernel on an
    accelerator; the port's solve stays on the prepared path."""
    xi, xk, kw = _eligible(rng, algorithm=wt.ALGO_ITERATIVE)
    tconfig.set_iter_count_fidelity(False)
    wt.config.set_iter_count_fidelity(False)
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])
    j, t = _pair(kw, xi, xk)
    eng = api.fit_many(xk, fk, xi, order=2, weighting=wt.WEIGHT_CENTER, iterative=True,
                       backend="engine", device="cpu")
    _no_kernel(monkeypatch)
    (jfi, _, jit), (tfi, _, tit) = _solve_both(j, t, fk, 6)
    assert rel_err(tfi, jfi) <= TOL
    assert tit == int(eng.iterations.max()) and 1 <= jit <= 10


def test_precision_f64_bit_identical_under_compat_knob(rng):
    B, K = 8, 30
    xk = rng.uniform(-1, 1, (B, K, 2))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])

    def run():
        s = wtt.ExpertSolver(**_kw(B, K, order=4, weighting=wt.WEIGHT_CENTER),
                             precision="f64", device="cpu")
        s.prepare(xi=np.zeros((B, 2)), xk=xk)
        fi = np.zeros((B, 15))
        s.solve(fk=fk, fi=fi)
        return fi

    wtt.set_compat_precision("ds")
    a = run()
    wtt.set_compat_precision("f64")
    np.testing.assert_array_equal(a, run())


def test_iterative_with_sens_matches_basic_sens(rng):
    f, expected = quadratic_2d()
    xk = rng.uniform(-1, 1, (6, 26, 2))
    fk = f(xk)
    out = {}
    for algo in (wt.ALGO_BASIC, wt.ALGO_ITERATIVE):
        j, t = _pair(_kw(6, 26, algorithm=algo, do_sens=True), np.zeros((6, 2)), xk)
        out[algo] = _solve_both(j, t, fk, 6, K=26, do_sens=True)
    (_, _, _), (fi_b, sens_b, _) = out[wt.ALGO_BASIC]
    (jfi_i, jsens_i, jit), (fi_i, sens_i, it) = out[wt.ALGO_ITERATIVE]
    np.testing.assert_array_equal(sens_i, sens_b)
    np.testing.assert_allclose(fi_i, fi_b, atol=1e-12)
    np.testing.assert_allclose(fi_i, np.tile(expected, (6, 1)), atol=1e-9)
    assert rel_err(fi_i, jfi_i) <= TOL and rel_err(sens_i, jsens_i) <= TOL
    assert abs(it - jit) <= 1


def test_solve_device_matches_solve(rng):
    f, _ = quadratic_2d()
    B, K = 24, 30
    xi, xk = _cloud(rng, B, K)
    fk = f(xk)
    j, t = _pair(_kw(B, K), xi, xk)
    (jfi, _, _), (fi, _, _) = _solve_both(j, t, fk, 6)
    fi_d, sens_d, iters_d = t.solve_device(torch.as_tensor(fk))
    assert isinstance(fi_d, torch.Tensor) and sens_d is None
    np.testing.assert_array_equal(fi_d.numpy(), fi)
    assert int(iters_d.max()) == 0
    fks = torch.stack([torch.as_tensor(fk), 2.0 * torch.as_tensor(fk)])
    fi_m, _, it_m = t.solve_device(fks)
    assert tuple(fi_m.shape) == (2, B, 6) and tuple(it_m.shape) == (2, B)
    np.testing.assert_allclose(fi_m[0].numpy(), fi, rtol=0, atol=1e-12)
    np.testing.assert_allclose(fi_m[1].numpy(), 2.0 * fi, rtol=1e-11, atol=1e-11)
    jm, _, _ = j.solve_device(np.stack([fk, 2.0 * fk]))
    assert rel_err(fi_m.numpy().reshape(2 * B, 6), np.asarray(jm).reshape(2 * B, 6)) <= TOL


def test_solve_stream_is_bit_equal_to_sequential_solve_device(rng):
    f, _ = quadratic_2d()
    B, K = 20, 26
    xi, xk = _cloud(rng, B, K)
    j, t = _pair(_kw(B, K), xi, xk)
    steps = [f(xk) * (1.0 + 0.1 * s) for s in range(5)]
    got = list(t.solve_stream(iter(steps)))
    jgot = list(j.solve_stream(iter(steps)))
    assert len(got) == len(steps)
    for fk_s, (fi_s, it_s), (jfi_s, jit_s) in zip(steps, got, jgot):
        fi_ref, _, it_ref = t.solve_device(fk_s)
        np.testing.assert_array_equal(fi_s, fi_ref.numpy())
        assert it_s == int(it_ref.max()) == jit_s
        assert isinstance(fi_s, np.ndarray) and fi_s.dtype == np.float64
        assert rel_err(fi_s, jfi_s) <= TOL


def test_solve_stream_refuses_sens(rng):
    f, _ = quadratic_2d()
    xi, xk = _cloud(rng, 8, 20)
    s = wtt.ExpertSolver(**_kw(8, 20, do_sens=True), device="cpu")
    s.prepare(xi=xi, xk=xk)
    with pytest.raises(ValueError, match="do_sens"):
        next(s.solve_stream(iter([f(xk)])))
    with pytest.raises(ValueError, match="sens output"):
        s.solve(f(xk), np.zeros((8, 6)))


def test_solve_accepts_a_tensor_fk(rng):
    f, _ = quadratic_2d()
    xi, xk = _cloud(rng, 16, 25, spread=0.5)
    fk = f(xk)
    s = wtt.ExpertSolver(**_kw(16, 25), device="cpu")
    s.prepare(xi=xi, xk=xk)
    fi_np, fi_t = np.zeros((16, 6)), np.zeros((16, 6))
    s.solve(fk=fk, fi=fi_np)
    fk_t = torch.as_tensor(fk)
    s.solve(fk=fk_t, fi=fi_t)
    np.testing.assert_array_equal(fi_np, fi_t)
    np.testing.assert_array_equal(fk_t.numpy(), fk)      # not written


def test_solve_preserves_inactive_trailing_dofs(rng):
    f, _ = quadratic_2d()
    B, K = 12, 30
    xi, xk = _cloud(rng, B, K)
    kw = _kw(B, K)
    kw["order"][::2] = 1
    j, t = _pair(kw, xi, xk)
    fi0 = np.full((B, 6), 123.0)
    (jfi, _, _), (fi, _, _) = _solve_both(j, t, f(xk), 6, fi0=fi0)
    no1 = wt.number_of_dofs(2, 1)
    assert np.all(fi[::2, no1:] == 123.0)
    assert np.all(fi[1::2] != 123.0)
    np.testing.assert_array_equal(fi, np.where(fi == 123.0, jfi, fi))
    assert rel_err(fi, jfi) <= TOL


def test_knowns_and_lu_solver_match_jax(rng):
    """Known DOFs come in through fi; the reference-parity LU solver gives
    the Cholesky's answer."""
    f, expected = quadratic_2d()
    B, K = 10, 24
    xi, xk = _cloud(rng, B, K)
    kw = _kw(B, K)
    kw["knowns"][:] = wt.b2_F | wt.b2_Y
    fi0 = rng.standard_normal((B, 6))
    outs = []
    for solver in ("chol", "lu", "chol_unrolled"):
        j, t = _pair(kw, xi, xk, solver=solver)
        (jfi, _, _), (tfi, _, _) = _solve_both(j, t, f(xk), 6, fi0=fi0)
        assert rel_err(tfi, jfi) <= TOL
        outs.append(tfi)
    assert rel_err(outs[1], outs[0]) <= 1e-11
    np.testing.assert_array_equal(outs[2], outs[0])
    np.testing.assert_array_equal(outs[0][:, [wt.i2_F, wt.i2_Y]],
                                  fi0[:, [wt.i2_F, wt.i2_Y]])


def test_one_dimensional_solver(rng):
    B, K = 6, 12
    xi = rng.uniform(-1, 1, B)
    xk = xi[:, None] + rng.uniform(-0.5, 0.5, (B, K))
    fk = 1.0 + 2.0 * xk + 3.0 * xk ** 2
    j, t = _pair(_kw(B, K, dimension=1), xi, xk)
    (jfi, _, _), (tfi, _, _) = _solve_both(j, t, fk, 3)
    np.testing.assert_allclose(tfi[:, 0], 1 + 2 * xi + 3 * xi ** 2, atol=1e-10)
    assert rel_err(tfi, jfi) <= TOL
    t.prep_interpolate()
    j.prep_interpolate()
    q = rng.uniform(-1, 1, 7)
    np.testing.assert_allclose(t.interpolate(q)[0], j.interpolate(q)[0], atol=1e-12)
