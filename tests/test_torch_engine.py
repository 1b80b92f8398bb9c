"""The port's f64 engine against the JAX f64 engine on the same inputs.

Same algorithm, so only roundoff differs, measured relative to max(|ref|, 1)
per case on moderately conditioned clouds (radius 0.3-1, nk >= 1.5 NO):
sensitivities and the refined (ALGO_ITERATIVE) DOFs agree to 1e-12; the
unrefined basic DOFs to 1e-11, because one f64 Cholesky solve at a scaled
condition number of ~1e3 carries ~cond * NO * eps ≈ 2e-12 of roundoff in
each package (measured up to 2.2e-12 apart; refinement removes it).  ALGO_ITERATIVE stops on EXACT l∞-norm
stagnation, so its iteration counts are decided by last-bit ties:
XLA:CPU and torch round differently (the CENTER weights alone differ in the
last bit on about a third of the entries), and the counts agree on about
60% of cases, within one iteration on about 95% — the roundoff class of
docs/porting.md:40-44.  The bounds below sit under those measurements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_cases import cloud, rel_err
from wlsqm_tpu.fitter import engine as jengine
from wlsqm_tpu.ops import ruiz as jruiz
from wlsqm_tpu_torch.fitter import engine
from wlsqm_tpu_torch.ops import ruiz

torch.set_num_threads(1)

K_BY_DIM = {1: 16, 2: 30, 3: 56}
RADIUS = (0.3, 1.0)
TOL = 1e-12
TOL_UNREFINED = 1e-11


def _both(case, dim, **kw):
    keys = ("xk", "fk", "nk", "xi", "fi0", "order", "knowns", "weighting")
    j = jengine.fit_batch(*(jnp.asarray(case[k]) for k in keys),
                          dimension=dim, NO=case["NO"], **kw)
    t = engine.fit_batch(*(torch.as_tensor(case[k]) for k in keys),
                         dimension=dim, NO=case["NO"], **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_basic_with_sens_matches_jax(dim):
    rng = np.random.default_rng(100 + dim)
    case = cloud(rng, 256, K_BY_DIM[dim], dim, orders=(0, 1, 2, 3, 4),
                 weightings=(1, 2), knowns=True, radius=RADIUS)
    (jfi, jsens, _, _), (tfi, tsens, titers, _) = _both(case, dim, do_sens=True)
    assert np.isfinite(tfi).all()
    assert rel_err(tfi, jfi) <= TOL_UNREFINED
    assert rel_err(tsens, jsens) <= TOL
    assert (titers == 0).all()


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_iterative_matches_jax(dim):
    rng = np.random.default_rng(200 + dim)
    case = cloud(rng, 256, K_BY_DIM[dim], dim, orders=(0, 1, 2, 3, 4),
                 weightings=(1, 2), knowns=True, radius=RADIUS)
    (jfi, _, jit, _), (tfi, _, tit, _) = _both(case, dim, iterative=True, max_iter=3)
    assert rel_err(tfi, jfi) <= TOL
    assert (tit == jit).mean() >= 0.5
    assert (np.abs(tit - jit) <= 1).mean() >= 0.9
    assert tit.min() >= 1 and tit.max() <= 3


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_basis_matches_jax(dim):
    rng = np.random.default_rng(dim)
    delta = rng.uniform(-1, 1, (64, 7, dim))
    NO = engine.defs.number_of_dofs(dim, 4)
    a = engine.basis(torch.as_tensor(delta), dim, NO).numpy()
    b = np.asarray(jengine.basis(jnp.asarray(delta), dim, NO))
    np.testing.assert_array_equal(a, b)


def test_ruiz_matches_jax():
    rng = np.random.default_rng(5)
    C = rng.standard_normal((32, 20, 6)) * np.logspace(-3, 3, 6)
    A = np.einsum("bkj,bkm->bjm", C, C)
    r, c, it = ruiz.ruiz_scale(torch.as_tensor(A))
    jr, jc, jit = jruiz.ruiz_scale(jnp.asarray(A))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-14)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-14)
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit))


def test_jacobi_scaling_matches_jax():
    rng = np.random.default_rng(6)
    case = cloud(rng, 64, 30, 2, orders=(4,), weightings=(1, 2), radius=RADIUS)
    (jfi, *_), (tfi, *_) = _both(case, 2, scaling="jacobi")
    assert rel_err(tfi, jfi) <= TOL_UNREFINED


def test_debug_condition_numbers():
    rng = np.random.default_rng(8)
    case = cloud(rng, 32, 30, 2, orders=(2,), ragged=False)
    (_, _, _, jcond), (_, _, _, tcond) = _both(case, 2, debug=True)
    np.testing.assert_allclose(tcond, jcond, rtol=1e-8)


def _carry(jprep):
    """A JAX ``Prepared`` as the port's, through NumPy (utils/interop)."""
    import dataclasses

    from wlsqm_tpu_torch.utils.interop import prepared_from_numpy

    fields = {}
    for f in dataclasses.fields(jprep):
        v = getattr(jprep, f.name)
        if f.name in ("dimension", "solver", "precision"):
            continue
        fields[f.name] = (tuple(np.asarray(a) for a in v) if f.name == "fac"
                          else None if v is None else np.asarray(v))
    return prepared_from_numpy(fields, dimension=jprep.dimension, solver=jprep.solver,
                               precision=jprep.precision, device="cpu")


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_cond_estimate_on_a_carried_prepared_matches_jax(dim):
    """The same prepared state, the same start vector and the same rounds:
    power and inverse iteration agree with the JAX package's to 1e-9."""
    rng = np.random.default_rng(300 + dim)
    case = cloud(rng, 128, K_BY_DIM[dim], dim, orders=(0, 1, 2, 3, 4),
                 weightings=(1, 2), knowns=True, radius=RADIUS)
    keys = ("xk", "nk", "xi", "order", "knowns", "weighting")
    jprep = jengine.prepare(*(jnp.asarray(case[k]) for k in keys), dimension=dim,
                            NO=case["NO"])
    prep = _carry(jprep)
    assert prep.nk_max == jprep.nk_max == K_BY_DIM[dim]
    est = engine.cond_estimate(prep).numpy()
    jest = np.asarray(jengine.cond_estimate(jprep))
    assert np.isfinite(est).all() and (est >= 1.0 - 1e-12).all()
    np.testing.assert_allclose(est, jest, rtol=1e-9)
    np.testing.assert_allclose(engine.cond_estimate(prep, iters=3).numpy(),
                               np.asarray(jengine.cond_estimate(jprep, iters=3)), rtol=1e-9)


def test_lu_solver_matches_cholesky_and_jax():
    """The reference-parity LU mode (tests/test_precision_modes.py:85's bar:
    1e-11 of the Cholesky path, sens included) and against the JAX LU."""
    rng = np.random.default_rng(85)
    case = cloud(rng, 64, 30, 2, orders=(4,), weightings=(2,), ragged=False)
    (_, _, _, _), (tfi_c, ts_c, _, _) = _both(case, 2, solver="chol", do_sens=True)
    (jfi_l, js_l, _, _), (tfi_l, ts_l, _, _) = _both(case, 2, solver="lu", do_sens=True)
    rel = np.abs(tfi_l - tfi_c).max() / np.abs(tfi_c).max()
    srel = np.abs(ts_l - ts_c).max() / np.abs(ts_c).max()
    assert rel < 1e-11 and srel < 1e-11
    assert rel_err(tfi_l, jfi_l) <= TOL_UNREFINED
    assert rel_err(ts_l, js_l) <= TOL


@pytest.mark.parametrize("dim", [2, 3])
def test_chol_unrolled_is_the_cholesky(dim):
    rng = np.random.default_rng(400 + dim)
    case = cloud(rng, 64, K_BY_DIM[dim], dim, orders=(1, 2, 3, 4), weightings=(1, 2),
                 knowns=True, radius=RADIUS)
    # the JAX side runs "chol": its unrolled factor is a trace-time graph of
    # ~NO^3/6 scalar steps, minutes of XLA:CPU compile at NO = 35
    (jfi, *_), (tfi_c, ts_c, _, _) = _both(case, dim, do_sens=True)
    keys = ("xk", "fk", "nk", "xi", "fi0", "order", "knowns", "weighting")
    tfi_u, ts_u, _, _ = engine.fit_batch(*(torch.as_tensor(case[k]) for k in keys),
                                         dimension=dim, NO=case["NO"], do_sens=True,
                                         solver="chol_unrolled")
    np.testing.assert_array_equal(tfi_u.numpy(), tfi_c)
    np.testing.assert_array_equal(ts_u.numpy(), ts_c)
    assert rel_err(tfi_u.numpy(), jfi) <= TOL_UNREFINED


def test_singular_lu_factor_is_nan():
    A = torch.zeros((2, 3, 3), dtype=torch.float64)
    A[0] = torch.eye(3)
    lu, piv = engine.solve_ops.factor(A, "lu")
    assert torch.isfinite(lu[0]).all() and torch.isnan(lu[1]).all()
    x = engine.solve_ops.solve_factored((lu, piv), torch.ones((2, 3, 1), dtype=torch.float64),
                                        "lu")
    assert torch.isnan(x[1]).all() and torch.equal(x[0], torch.ones((3, 1), dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown solver"):
        engine.solve_ops.factor(A, "qr")
