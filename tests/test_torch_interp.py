"""Polynomial evaluation and interpolation, port vs JAX.

The same NumPy coefficients, origins and query points go through the JAX
package's ``fitter.polyeval`` / ``fitter.interp`` / ``api.interpolate``
and the port's, on the CPU; they compute the same basis rows and the same
contractions, so they agree within 1e-13 relative to max(|ref|, 1) per
case over dims 1-3, orders 0-4 and derivative codes up to the highest.
"""

import numpy as np
import pytest
import torch

import wlsqm_tpu as wt
import wlsqm_tpu_torch as wtt
from torch_port_cases import rel_err
from wlsqm_tpu.fitter import interp as jinterp
from wlsqm_tpu.fitter import polyeval as jpolyeval
from wlsqm_tpu_torch.fitter import interp, polyeval, tables

torch.set_num_threads(1)

TOL = 1e-13
NO_MAX = {1: 5, 2: 15, 3: 35}


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _data(dim, seed, B=64, n=9):
    rng = np.random.default_rng(seed)
    fi = rng.standard_normal((B, NO_MAX[dim])) * 3.0
    xi = rng.uniform(-1, 1, (B, dim))
    x = xi[:, None, :] + rng.uniform(-0.4, 0.4, (B, n, dim))
    return fi, xi, x


def test_diff_projection_matches_jax():
    from wlsqm_tpu.fitter import tables as jtables

    for dim in (1, 2, 3):
        for diff in range(NO_MAX[dim]):
            np.testing.assert_array_equal(tables.diff_projection(dim, diff),
                                          jtables.diff_projection(dim, diff))
    with pytest.raises(ValueError):
        tables.diff_projection(2, 15)


@pytest.mark.parametrize("kind", ["taylor", "general"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_polyeval_matches_jax(dim, kind):
    fi, xi, x = _data(dim, dim, B=1, n=40)
    x, xi = x[0], xi[0]
    if dim == 1:
        x, xi = x[:, 0], xi[0]
    for order in range(5):
        ref = getattr(jpolyeval, "%s_%dD" % (kind, dim))(order, fi[0], xi, x)
        got = getattr(polyeval, "%s_%dD" % (kind, dim))(order, fi[0], xi, x, device="cpu")
        assert got.device.type == "cpu" and got.shape == (40,)
        assert rel_err(_np(got)[None], _np(ref)[None]) <= TOL
        assert torch.equal(got, getattr(polyeval, kind)(dim, order, fi[0], xi, x,
                                                        device="cpu"))


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_eval_fit_and_interpolate_many_match_jax(dim, order):
    """The value, a first and the last derivative of the model's order, and
    the highest code (zero above the model order)."""
    fi, xi, x = _data(dim, 10 * dim + order)
    no = wtt.number_of_dofs(dim, order)
    for diff in sorted({0, min(1, no - 1), no - 1, NO_MAX[dim] - 1}):
        ref = jinterp.eval_fit(fi, xi, x, dimension=dim, order=order, diff=diff)
        got = interp.eval_fit(fi, xi, x, dimension=dim, order=order, diff=diff,
                              device="cpu")
        assert got.shape == (64, 9)
        assert rel_err(_np(got), _np(ref)) <= TOL
        many = interp.interpolate_many(fi, xi, x, dimension=dim, order=order, diff=diff,
                                       device="cpu")
        assert torch.equal(many, got)
        api = wtt.interpolate(fi, xi, x, dimension=dim, order=order, diff=diff,
                              device="cpu")
        japi = wt.interpolate(fi, xi, x, dimension=dim, order=order, diff=diff)
        assert rel_err(_np(api), _np(japi)) <= TOL


@pytest.mark.parametrize("diff", [0, 1, 4])
@pytest.mark.parametrize("dim", [2, 3])
def test_interpolate_continuous_matches_jax(dim, diff):
    rng = np.random.default_rng(dim + diff)
    B, Q, order = 300, 70, 2
    fi = rng.standard_normal((B, NO_MAX[dim]))
    xi = rng.uniform(-1, 1, (B, dim))
    x = rng.uniform(-1, 1, (Q, dim))
    x[-1] = 5.0                            # no model in range: den = 0
    valid = rng.random(B) < 0.9
    kw = dict(dimension=dim, order=order, diff=diff, valid=valid, block_q=32, block_b=128)
    num, den = interp.interpolate_continuous(fi, xi, x, 0.4, device="cpu", **kw)
    jnum, jden = jinterp.interpolate_continuous(fi, xi, x, 0.4, **kw)
    assert num.shape == den.shape == (Q,)
    assert rel_err(_np(num)[:, None], _np(jnum)[:, None]) <= TOL
    assert rel_err(_np(den)[:, None], _np(jden)[:, None]) <= TOL
    assert (_np(den) > 0).any() and (_np(den) == 0).any()


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_interpolate_fit_and_lambdify_match_jax(dim):
    fi, xi, x = _data(dim, 50 + dim, B=1, n=25)
    xi0 = xi[0, 0] if dim == 1 else xi[0]
    pts = x[0, :, 0] if dim == 1 else x[0]
    for order in range(5):
        for diff in (0, 1, NO_MAX[dim] - 1):
            got = interp.interpolate_fit(xi0, fi[0], dim, order, pts, diff, device="cpu")
            ref = jinterp.interpolate_fit(xi0, fi[0], dim, order, pts, diff)
            assert isinstance(got, np.ndarray) and got.shape == (25,)
            assert rel_err(got[None], np.asarray(ref)[None]) <= TOL
            model = interp.lambdify_fit(xi0, fi[0], dim, order, diff, device="cpu")
            jmodel = jinterp.lambdify_fit(xi0, fi[0], dim, order, diff)
            coords = [pts] if dim == 1 else [pts[:, a].reshape(5, 5) for a in range(dim)]
            out, jout = model(*coords), jmodel(*coords)
            assert out.shape == np.shape(jout)
            assert rel_err(np.reshape(out, (1, -1)), np.reshape(jout, (1, -1))) <= TOL
    with pytest.raises(ValueError):
        interp.interpolate_fit(xi0, fi[0], dim, 5, pts, device="cpu")
    with pytest.raises(ValueError):
        interp.interpolate_fit(xi0, fi[0], dim, 2, pts, diff=NO_MAX[dim], device="cpu")
    if dim > 1:
        with pytest.raises(ValueError):
            interp.lambdify_fit(xi0, fi[0], dim, 2, device="cpu")(pts[:, 0])


def test_interpolation_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fi, xi, x = _data(2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wtt.interpolate(fi, xi, x, dimension=2, order=4)
