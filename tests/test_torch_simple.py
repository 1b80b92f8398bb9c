"""The port's fit_* entries against the JAX package's, name by name.

The cases of tests/test_simple.py on both packages, and every one of the 18
``fit_{1D,2D,3D}[_iterative][_many][_many_parallel]`` entries on the same
NumPy inputs: fi and sens within 1e-10 relative to max(|ref|, 1) per case
(``torch_port_cases.rel_err``) and to the exact answer of polynomial data.

ALGO_ITERATIVE stops on exact stagnation of the l∞ residual norm, which the
last bits of each package's roundoff decide.  The returned count is held to
the port engine's own counts exactly, and the per-case counts to the JAX
package's stored ones on the seeded clouds of tests/iterative_counts.py
(:func:`test_iterative_counts_against_jax`): their histograms agree
closely, the per-case counts little beyond what the histograms imply, so no
per-call bar against the JAX package is set.
"""

import numpy as np
import pytest
import torch

import wlsqm_tpu as wt
import wlsqm_tpu_torch as wtt
from conftest import cubic_2d, quadratic_1d, quadratic_2d, quadratic_3d
from torch_port_cases import rel_err
from wlsqm_tpu_torch import api
from wlsqm_tpu_torch import config as tconfig
from wlsqm_tpu_torch.fitter import simple
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

torch.set_num_threads(1)

ATOL = 1e-10
TOL = 1e-10
CPU = dict(device="cpu")
POLY = {1: quadratic_1d, 2: quadratic_2d, 3: quadratic_3d}
KNOWNS_BIT = {1: wt.b1_F, 2: wt.b2_F, 3: wt.b3_F}


@pytest.fixture(autouse=True)
def _restore_knobs():
    """The compat knobs are module globals in both packages."""
    from wlsqm_tpu import config as jconfig

    saved = [(m, m._COMPAT_PRECISION, m._ITER_COUNT_FIDELITY)
             for m in (jconfig, tconfig)]
    yield
    for m, cp, fid in saved:
        m._COMPAT_PRECISION, m._ITER_COUNT_FIDELITY = cp, fid


def _points(rng, shape, dim):
    return rng.uniform(-1, 1, shape if dim == 1 else shape + (dim,))


# -- the cases of tests/test_simple.py ----------------------------------------

def _single(name, rng, npts, order, weighting=wt.WEIGHT_UNIFORM, knowns=0, f=None,
            do_sens=False, fk_noise=0.0):
    """One single-case entry on both packages; returns (jax fi, port fi,
    jax sens, port sens, jax count, port count)."""
    dim = int(name[4])
    f = f or POLY[dim]()[0]
    xk = _points(rng, (npts,), dim)
    fk = f(xk) + fk_noise * rng.standard_normal(npts)
    xi = 0.0 if dim == 1 else np.zeros(dim)
    NO = wt.number_of_dofs(dim, order)
    out = []
    for pkg, extra in ((wt, {}), (wtt, CPU)):
        fi = np.zeros(NO)
        sens = np.zeros((npts, NO)) if do_sens else None
        it = getattr(pkg, name)(xk=xk, fk=fk, xi=xi, fi=fi, sens=sens, do_sens=do_sens,
                                order=order, knowns=knowns, weighting_method=weighting,
                                debug=False, **extra)
        out.append((fi, sens, it))
    (jfi, jsens, jit), (tfi, tsens, tit) = out
    return jfi, tfi, jsens, tsens, jit, tit


@pytest.mark.parametrize("dim,npts", [(1, 15), (2, 30), (3, 40)])
def test_fit_order2(rng, dim, npts):
    _, expected = POLY[dim]()
    jfi, tfi, _, _, jit, tit = _single("fit_%dD" % dim, rng, npts, 2)
    assert jit == tit == 0
    np.testing.assert_allclose(tfi, expected, atol=ATOL)
    assert rel_err(tfi[None], jfi[None]) <= TOL


def test_fit_2d_order3(rng):
    f, expected = cubic_2d()
    jfi, tfi, *_ = _single("fit_2D", rng, 50, 3, f=f)
    np.testing.assert_allclose(tfi, expected, atol=ATOL)
    assert rel_err(tfi[None], jfi[None]) <= TOL


def test_weight_center_recovers_exact_polynomial(rng):
    _, expected = quadratic_2d()
    jfi, tfi, *_ = _single("fit_2D", rng, 30, 2, weighting=wt.WEIGHT_CENTER)
    np.testing.assert_allclose(tfi, expected, atol=ATOL)
    assert rel_err(tfi[None], jfi[None]) <= TOL


def test_iterative_matches_basic_on_exact_polynomial(rng):
    f, expected = quadratic_2d()
    xk = rng.uniform(-1, 1, (30, 2))
    kw = dict(xk=xk, fk=f(xk), xi=np.zeros(2), sens=None, do_sens=False, order=2,
              knowns=0, weighting_method=wt.WEIGHT_UNIFORM, debug=False, device="cpu")
    fi_b, fi_i = np.zeros(6), np.zeros(6)
    wtt.fit_2D(fi=fi_b, **kw)
    it = wtt.fit_2D_iterative(fi=fi_i, max_iter=10, **kw)
    assert 1 <= it <= 10
    np.testing.assert_allclose(fi_i, fi_b, atol=1e-12)
    np.testing.assert_allclose(fi_i, expected, atol=ATOL)


def _many_kw(xk, fk, order, nk=None, knowns=None, weighting=wt.WEIGHT_UNIFORM):
    B, K = xk.shape[:2]
    dim = 1 if xk.ndim == 2 else xk.shape[2]
    return dict(xk=xk, fk=fk, nk=np.full(B, K, np.int32) if nk is None else nk,
                xi=np.zeros(B) if dim == 1 else np.zeros((B, dim)),
                order=np.broadcast_to(np.asarray(order, np.int32), (B,)).copy(),
                knowns=np.zeros(B, np.int64) if knowns is None else knowns,
                weighting_method=np.full(B, weighting, np.int32))


def test_fit_2d_many_matches_single_loop(rng):
    f, expected = quadratic_2d()
    xk = rng.uniform(-1, 1, (8, 25, 2))
    fk = f(xk)
    fi_loop = np.zeros((8, 6))
    for j in range(8):
        wtt.fit_2D(xk=xk[j], fk=fk[j], xi=np.zeros(2), fi=fi_loop[j], sens=None,
                   do_sens=False, order=2, knowns=0,
                   weighting_method=wt.WEIGHT_UNIFORM, debug=False, device="cpu")
    fi_many, jfi = np.zeros((8, 6)), np.zeros((8, 6))
    kw = _many_kw(xk, fk, 2)
    wtt.fit_2D_many(fi=fi_many, sens=None, do_sens=False, debug=False, device="cpu", **kw)
    wt.fit_2D_many(fi=jfi, sens=None, do_sens=False, debug=False, **kw)
    np.testing.assert_allclose(fi_many, fi_loop, atol=1e-13)
    np.testing.assert_allclose(fi_many, np.tile(expected, (8, 1)), atol=ATOL)
    assert rel_err(fi_many, jfi) <= TOL


def test_ragged_nk_ignores_padding(rng):
    """Non-finite garbage in the padded tail must not reach the result."""
    f, expected = quadratic_2d()
    xk = rng.uniform(-1, 1, (4, 30, 2))
    fk = f(xk)
    nk = np.array([30, 22, 18, 25], np.int32)
    for j in range(4):
        xk[j, nk[j]:] = np.nan
        fk[j, nk[j]:] = np.inf
    fi, jfi = np.zeros((4, 6)), np.zeros((4, 6))
    kw = _many_kw(xk, fk, 2, nk=nk)
    wtt.fit_2D_many(fi=fi, sens=None, do_sens=False, device="cpu", **kw)
    wt.fit_2D_many(fi=jfi, sens=None, do_sens=False, **kw)
    np.testing.assert_allclose(fi, np.tile(expected, (4, 1)), atol=ATOL)
    assert rel_err(fi, jfi) <= TOL


def test_mixed_orders_in_one_batch(rng):
    f, expected = quadratic_2d()
    xk = rng.uniform(-1, 1, (6, 30, 2))
    order = np.array([2, 3, 4, 2, 3, 4], np.int32)
    fi, jfi = np.zeros((6, 15)), np.zeros((6, 15))
    kw = _many_kw(xk, f(xk), order)
    wtt.fit_2D_many(fi=fi, sens=None, do_sens=False, device="cpu", **kw)
    wt.fit_2D_many(fi=jfi, sens=None, do_sens=False, **kw)
    for j in range(6):
        no_j = wt.number_of_dofs(2, int(order[j]))
        full = np.zeros(no_j)
        full[:6] = expected
        np.testing.assert_allclose(fi[j, :no_j], full, atol=1e-8)
        np.testing.assert_array_equal(fi[j, no_j:], 0.0)
    assert rel_err(fi, jfi) <= TOL


def test_sensitivity_matches_finite_difference_and_jax(rng):
    f, _ = quadratic_2d()
    jfi, fi, jsens, sens, *_ = _single("fit_2D", rng, 20, 2, do_sens=True)
    assert rel_err(sens[None], jsens[None]) <= TOL
    xk = rng.uniform(-1, 1, (20, 2))
    kw = dict(xk=xk, xi=np.zeros(2), order=2, knowns=0,
              weighting_method=wt.WEIGHT_UNIFORM, debug=False, device="cpu")
    fk = f(xk)
    fi, sens = np.zeros(6), np.zeros((20, 6))
    wtt.fit_2D(fk=fk, fi=fi, sens=sens, do_sens=True, **kw)
    fk2 = fk.copy()
    fk2[7] += 1e-6
    fi2 = np.zeros(6)
    wtt.fit_2D(fk=fk2, fi=fi2, sens=None, do_sens=False, **kw)
    np.testing.assert_allclose(sens[7], (fi2 - fi) / 1e-6, atol=1e-6)


def test_sensitivity_nan_for_knowns(rng):
    f, _ = quadratic_2d()
    xk = rng.uniform(-1, 1, (20, 2))
    fi = np.zeros(6)
    fi[wt.i2_F] = 1.0
    sens = np.zeros((20, 6))
    wtt.fit_2D(xk=xk, fk=f(xk), xi=np.zeros(2), fi=fi, sens=sens, do_sens=True,
               order=2, knowns=wt.b2_F, weighting_method=wt.WEIGHT_UNIFORM,
               debug=False, device="cpu")
    assert fi[wt.i2_F] == 1.0
    assert np.isnan(sens[:, wt.i2_F]).all()
    assert np.isfinite(sens[:, wt.i2_X:]).all()


def test_sens_required_with_do_sens(rng):
    xk = rng.uniform(-1, 1, (20, 2))
    with pytest.raises(ValueError, match="sens output"):
        wtt.fit_2D(xk, xk[:, 0], np.zeros(2), np.zeros(6), None, True, device="cpu")


# -- all 18 entries, both packages ---------------------------------------------

NAMES = list(simple.__all__)


def _call(pkg, name, xk, fk, xi, fi, sens, do_sens, order, knowns, weighting, nk,
          **extra):
    fn = getattr(pkg, name)
    iterative = "_iterative" in name
    it_kw = dict(max_iter=4) if iterative else {}
    if "_many" not in name:
        return fn(xk, fk, xi, fi, sens, do_sens, order, knowns, weighting,
                  **it_kw, debug=0, **extra)
    if name.endswith("_parallel"):
        it_kw["ntasks"] = 3
    return fn(xk, fk, nk, xi, fi, sens, do_sens, order, knowns, weighting,
              **it_kw, debug=0, **extra)


def test_the_eighteen_names():
    assert len(NAMES) == 18
    for n in NAMES:
        assert getattr(wtt, n).__name__ == n and getattr(wt, n).__name__ == n


@pytest.mark.parametrize("name", NAMES)
def test_entry_matches_jax(name):
    """Each entry with a known DOF and sensitivities on polynomial data plus
    noise, as a single case or a ragged batch: fi, sens and the count."""
    rng = np.random.default_rng(sum(map(ord, name)))
    dim = int(name[4])
    f, _ = POLY[dim]()
    K = {1: 14, 2: 30, 3: 40}[dim]
    NO = wt.number_of_dofs(dim, 2)
    kbit = KNOWNS_BIT[dim]
    if "_many" in name:
        B = 6
        xi = _points(rng, (B,), dim) * 0.5
        off = xi[:, None] if dim == 1 else xi[:, None, :]
        xk = off + _points(rng, (B, K), dim) * 0.6
        fk = f(xk) + 0.01 * rng.standard_normal((B, K))
        nk = np.full(B, K, np.int32)
        nk[1::2] = K - 3
        fi0 = np.zeros((B, NO))
        fi0[:, 0] = 0.5
        args = (np.full(B, 2, np.int32), np.full(B, kbit, np.int64),
                np.full(B, wt.WEIGHT_CENTER, np.int32), nk)
        sens_shape = (B, K, NO)
    else:
        xi = 0.1 if dim == 1 else np.full(dim, 0.1)
        xk = xi + _points(rng, (K,), dim) * 0.6
        fk = f(xk) + 0.01 * rng.standard_normal(K)
        fi0 = np.zeros(NO)
        fi0[0] = 0.5
        args = (2, kbit, wt.WEIGHT_CENTER, None)
        sens_shape = (K, NO)
    out = []
    for pkg, extra in ((wt, {}), (wtt, CPU)):
        fi, sens = fi0.copy(), np.zeros(sens_shape)
        it = _call(pkg, name, xk, fk, xi, fi, sens, True, *args, **extra)
        out.append((fi, sens, it))
    (jfi, jsens, jit), (tfi, tsens, tit) = out
    assert np.array_equal(tfi[..., 0], fi0[..., 0])            # the known DOF
    assert rel_err(np.atleast_2d(tfi), np.atleast_2d(jfi)) <= TOL
    assert rel_err(tsens.reshape(-1, NO), jsens.reshape(-1, NO)) <= TOL
    if "_iterative" in name:
        # the largest count of the port's f64 engine on the same inputs
        one = "_many" not in name
        xk_b = np.asarray(xk)[None] if one else np.asarray(xk)
        eng = api.fit_many(
            xk_b[..., None] if dim == 1 else xk_b, np.atleast_2d(fk),
            np.reshape(xi, (-1, dim)), nk=None if one else args[3], order=2,
            knowns=kbit, weighting=wt.WEIGHT_CENTER, fi_init=np.atleast_2d(fi0),
            do_sens=True, iterative=True, max_iter=4, backend="engine", device="cpu")
        assert tit == int(eng.iterations.max()) and 1 <= jit <= 4
    else:
        assert tit == jit == 0


def test_fk_may_view_fi(rng):
    """The reference guarantees fk may be a view of the fi array
    (wlsqm/fitter/simple.pyx:1010-1016): every result is computed before
    any is written, and no tensor views the caller's fi."""
    f, _ = quadratic_2d()
    B, K, NO = 5, 20, 6
    xk = rng.uniform(-1, 1, (B, K, 2))
    buf = np.zeros((B, K + NO))
    buf[:, :K] = f(xk)
    ref = np.zeros((B, NO))
    kw = _many_kw(xk, f(xk), 2)
    wtt.fit_2D_many(fi=ref, sens=None, do_sens=False, device="cpu", **kw)
    # fi is the trailing columns of buf, fk its leading ones: same memory
    kw.update(fk=buf[:, :K])
    buf2 = buf.copy()
    wtt.fit_2D_many(fi=buf[:, K:], sens=None, do_sens=False, device="cpu", **kw)
    np.testing.assert_array_equal(buf[:, K:], ref)
    np.testing.assert_array_equal(buf[:, :K], buf2[:, :K])
    # fk aliasing fi itself, the first K columns of a (B, K) fi
    fi_alias = np.zeros((B, 15))
    fi_alias[:, :6] = f(xk)[:, :6]
    kw2 = _many_kw(xk[:, :6], fi_alias[:, :6], 1)
    expect = np.zeros((B, 3))
    wtt.fit_2D_many(fi=expect, sens=None, do_sens=False, device="cpu",
                    **dict(kw2, fk=fi_alias[:, :6].copy()))
    wtt.fit_2D_many(fi=fi_alias, sens=None, do_sens=False, device="cpu", **kw2)
    np.testing.assert_array_equal(fi_alias[:, :3], expect)


def test_iterative_counts_against_jax():
    """Per-case ALGO_ITERATIVE counts of the compat route under count
    fidelity (the f64 engine, ``fit_many(backend="engine")``) on the seeded
    clouds of tests/iterative_counts.py — dims 1-3, orders 2-4, both
    weightings: 36,864 cases of sin 3x cos 2y, ragged nk, random knowns and
    initial DOFs, max_iter 3 — against the JAX f64 engine's stored counts;
    and ``fit_*_iterative_many`` returns the largest of them.  Measured:
    equal 0.558, within one 0.907, histogram distance 0.023, where two
    independent draws from the two histograms would give 0.495 and 0.885
    equal and within one.  The histograms agree; the per-case counts agree
    only a little beyond chance.  The bars sit just under the measured
    shares."""
    import iterative_counts as ic

    stored = ic.load()
    got, ref, chance = [], [], [0.0, 0.0]
    names = {1: wtt.fit_1D_iterative_many, 2: wtt.fit_2D_iterative_many,
             3: wtt.fit_3D_iterative_many}
    for key, dim, order, w, B, K, seed in ic.configs():
        if not key.startswith("grid") or order < 2:
            continue
        xk, fk, nk, xi, fi0, kn = ic.cloud(dim, order, B, K, seed)
        c = api.fit_many(xk, fk, xi, nk=nk, order=order, knowns=kn, weighting=w,
                         fi_init=fi0, iterative=True, max_iter=ic.MAX_ITER,
                         backend="engine", device="cpu").iterations.numpy()
        r = stored[key]
        got.append(c.astype(np.int64))
        ref.append(r.astype(np.int64))
        pt, pj = (np.bincount(a.astype(np.int64), minlength=ic.MAX_ITER + 1) / B
                  for a in (c, r))
        joint = np.outer(pt, pj)
        gap = np.abs(np.subtract.outer(np.arange(ic.MAX_ITER + 1),
                                       np.arange(ic.MAX_ITER + 1)))
        chance[0] += joint[gap == 0].sum() * B
        chance[1] += joint[gap <= 1].sum() * B
        if order == 4 and w == wt.WEIGHT_CENTER:
            fi = fi0.copy()
            it = names[dim](xk[..., 0] if dim == 1 else xk, fk, nk,
                            xi[:, 0] if dim == 1 else xi, fi, None, False,
                            np.full(B, order, np.int32), np.full(B, kn, np.int64),
                            np.full(B, w, np.int32), ic.MAX_ITER, device="cpu")
            assert it == int(c.max())
    equal, within, hist = ic.shares(got, ref)
    n = sum(len(a) for a in ref)
    assert equal >= 0.54 and within >= 0.89 and hist <= 0.03
    assert equal - chance[0] / n >= 0.03 and within - chance[1] / n >= 0.01


# -- routing -------------------------------------------------------------------

def _spy_backend(monkeypatch):
    seen = []
    real = api.fit_many
    monkeypatch.setattr(api, "fit_many",
                        lambda *a, **k: seen.append(k["backend"]) or real(*a, **k))
    return seen


@pytest.mark.parametrize("how, want", [("default", "auto"), ("debug", "engine"),
                                       ("compat_f64", "engine"),
                                       ("iterative", "engine"),
                                       ("iterative_fidelity_off", "auto")])
def test_routing(rng, monkeypatch, how, want):
    """debug, strict compat and iterative under count fidelity (the compat
    default) run the engine; everything else the auto route."""
    seen = _spy_backend(monkeypatch)
    f, expected = quadratic_2d()
    xk = rng.uniform(-1, 1, (30, 2))
    name = "fit_2D_iterative" if how.startswith("iterative") else "fit_2D"
    if how == "compat_f64":
        wtt.set_compat_precision("f64")
    if how == "iterative_fidelity_off":
        tconfig.set_iter_count_fidelity(False)
    fi = np.zeros(6)
    getattr(wtt, name)(xk, f(xk), np.zeros(2), fi, None, 0, 2, 0, wt.WEIGHT_UNIFORM,
                       debug=int(how == "debug"), device="cpu")
    assert seen == [want]
    np.testing.assert_allclose(fi, expected, atol=ATOL)


def test_fit_2d_many_takes_the_moment_kernel_at_1024(rng, monkeypatch):
    B, K = 1024, 30
    xk = rng.uniform(-1, 1, (B, K, 2))
    fk = np.sin(3 * xk[..., 0]) * np.cos(2 * xk[..., 1])
    calls = []
    real = fit_kernel.fit_kernel
    monkeypatch.setattr(fit_kernel, "fit_kernel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = _many_kw(xk, fk, 4, weighting=wt.WEIGHT_CENTER)
    fi, jfi = np.zeros((B, 15)), np.zeros((B, 15))
    wtt.fit_2D_many(fi=fi, sens=None, do_sens=False, device="cpu", **kw)
    wt.fit_2D_many(fi=jfi, sens=None, do_sens=False, **kw)
    assert len(calls) == 1
    assert rel_err(fi, jfi) <= TOL


def test_fit_3d_many_with_sens_takes_the_rows_kernel(rng, monkeypatch):
    B, K = 256, 40
    xi = rng.uniform(-1, 1, (B, 3))
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (B, K, 3))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 2])
    calls = []
    real = fit_rows.fit_rows
    monkeypatch.setattr(fit_rows, "fit_rows",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = _many_kw(xk, fk, 2, knowns=np.full(B, wt.b3_F, np.int64),
                  weighting=wt.WEIGHT_CENTER)
    kw["xi"] = xi
    fi0 = np.zeros((B, 10))
    fi0[:, 0] = fk[:, 0]
    out = []
    for pkg, extra in ((wt, {}), (wtt, CPU)):
        fi, sens = fi0.copy(), np.full((B, K, 10), 9.0)
        pkg.fit_3D_many(fi=fi, sens=sens, do_sens=True, **kw, **extra)
        out.append((fi, sens))
    assert len(calls) == 1
    (jfi, jsens), (tfi, tsens) = out
    assert rel_err(tfi, jfi) <= TOL and rel_err(tsens, jsens) <= TOL


def test_data_gate_holds_a_low_frequency_field(rng):
    """ROADMAP C4: on a field whose DOFs are of the size of its values, the
    geometry-only edge certifies cases that miss the bar; the compat route's
    data gate keeps a case on the kernel only when its key times
    max|fk| / max(|fi|, 1) is under the record's data edge.  Every case it
    keeps holds 1e-10 of the long-double oracle, and every other case is the
    f64 engine's."""
    from wlsqm_tpu_torch.fitter import calibration, condprobe

    B, K = 1024, 30
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (B, K, 2))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])
    kw = _many_kw(xk, fk, 4, weighting=wt.WEIGHT_CENTER)
    kw["xi"] = xi
    fi = np.zeros((B, 15))
    wtt.fit_2D_many(fi=fi, sens=None, do_sens=False, device="cpu", **kw)
    t = lambda a: torch.as_tensor(a)
    nk = torch.full((B,), K, dtype=torch.int32)
    fi_k, key = fit_kernel.fit_kernel(t(xk), t(fk), nk, t(xi), dimension=2, order=4,
                                      weighting=wt.WEIGHT_CENTER, emit_cond=True)
    sure = (key * calibration.data_ratio(fi_k, t(fk), nk)
            <= condprobe.data_edges()["moments"]).numpy()
    geometry = (key <= condprobe.est_certified_edges()["moments"]).numpy()
    assert 0.1 < sure.mean() < 0.9 and geometry.mean() > 0.99
    orc = calibration._strong_oracle(xk, xi, fk, wt.WEIGHT_CENTER, 2)
    err = np.abs(fi - orc).max(1) / np.maximum(np.abs(orc).max(1), 1)
    assert err[sure].max() <= TOL
    np.testing.assert_array_equal(fi[sure], fi_k.numpy()[sure])
    eng = api.fit_many(xk, fk, xi, order=4, weighting=wt.WEIGHT_CENTER,
                       backend="engine", device="cpu").fi.numpy()
    assert rel_err(fi[~sure], eng[~sure]) <= 1e-13
