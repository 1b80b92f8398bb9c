"""The port's public route against the JAX package's f64 route.

``plan_fit_many`` + ``fit_many(plan=)`` of the port (the moment and rows
kernels; on the CPU their plain torch versions) against
``wlsqm_tpu.fit_many(backend="xla", precision="f64")`` on the same NumPy
inputs, to the repo's 1e-10 parity bar (relative to max(|ref|, 1) per case).
Every call asks for the CPU: without ``device=`` the port computes on the
card, and raises where there is none.
"""

import numpy as np
import pytest
import torch

import wlsqm_tpu as wt
import wlsqm_tpu_torch as wtt
from torch_port_cases import cloud, rel_err
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

torch.set_num_threads(1)

PARITY = 1e-10
CPU = "cpu"


def _headline(B=1024, K=30, seed=42):
    """The bench workload (bench.py:102-108), made with NumPy."""
    rng = np.random.default_rng(seed)
    xk = rng.uniform(-1.0, 1.0, (B, K, 2))
    fk = np.sin(3.0 * xk[..., 0]) * np.cos(2.0 * xk[..., 1])
    fk = fk + 0.01 * rng.standard_normal((B, K))
    return xk, fk, np.zeros((B, 2))


def _jax(xk, fk, xi, **kw):
    res = wt.fit_many(xk, fk, xi, backend="xla", precision="f64", **kw)
    return res, np.asarray(res.fi)


def test_headline_plan_matches_jax_f64():
    xk, fk, xi = _headline()
    plan = wtt.plan_fit_many(xk, xi, order=4, weighting=wtt.WEIGHT_CENTER, device=CPU)
    res = wtt.fit_many(xk, fk, xi, order=4, weighting=wtt.WEIGHT_CENTER, plan=plan,
                       device=CPU)
    _, ref = _jax(xk, fk, xi, order=4, weighting=wt.WEIGHT_CENTER)
    assert res.fi.shape == (1024, 15) and res.fi.dtype == torch.float64
    assert bool(res.ok.all())
    assert rel_err(res.fi.numpy(), ref) <= PARITY
    assert (res.iterations == 0).all() and res.sens is None


def test_headline_plan_routes_to_the_kernel():
    xk, _, xi = _headline(B=64)
    plan = wtt.plan_fit_many(xk, xi, order=4, weighting=wtt.WEIGHT_CENTER, device=CPU)
    r = plan.route
    assert (r.path, r.kernel_precision, r.assembly) == ("kernel", "f64", "moments")
    assert r.refine_steps == fit_kernel.DEFAULT_REFINE_STEPS
    assert wtt.plan_fit_many(xk, xi, order=4, refine_steps=3,
                             device=CPU).route.refine_steps == 3


def test_knowns_batch_goes_to_the_engine_and_matches():
    """A knowns batch with sens: the plan picks the rows kernel (before the
    rows kernel existed it went to the engine); both match the JAX f64
    route, and the known DOFs keep their prescribed values bit-exactly."""
    rng = np.random.default_rng(1)
    case = cloud(rng, 256, 30, 2, orders=(3,), weightings=(2,), radius=(0.3, 1.0))
    kn = wt.b2_F | wt.b2_XY
    args = (case["xk"], case["fk"], case["xi"])
    kw = dict(nk=case["nk"], order=3, knowns=kn, weighting=2, fi_init=case["fi0"],
              device=CPU)
    plan = wtt.plan_fit_many(case["xk"], case["xi"], order=3, knowns=kn, weighting=2,
                             do_sens=True, device=CPU)
    assert (plan.route.path, plan.route.assembly) == ("kernel", "rows")
    before = fit_kernel.LAUNCHES, fit_rows.LAUNCHES
    res = wtt.fit_many(*args, plan=plan, do_sens=True, **kw)
    auto = wtt.fit_many(*args, do_sens=True, **kw)
    del kw["device"]
    jres, ref = _jax(*args, do_sens=True, **kw)
    assert rel_err(res.fi.numpy(), ref) <= PARITY
    assert rel_err(auto.fi.numpy(), ref) <= PARITY
    assert rel_err(res.sens.numpy(), np.asarray(jres.sens)) <= PARITY
    assert rel_err(auto.sens.numpy(), np.asarray(jres.sens)) <= PARITY
    np.testing.assert_array_equal(res.fi.numpy()[:, [0, 4]], case["fi0"][:, [0, 4]])
    assert (fit_kernel.LAUNCHES, fit_rows.LAUNCHES) == before   # CPU: plain version


def test_3d_batch_goes_to_the_engine_and_matches():
    """3D: the rows kernel where K >= 1.5 NO (it went to the engine before
    the rows kernel existed), the engine below that."""
    rng = np.random.default_rng(2)
    case = cloud(rng, 256, 24, 3, orders=(2,), weightings=(1,), radius=(0.3, 1.0))
    args = (case["xk"], case["fk"], case["xi"])
    plan = wtt.plan_fit_many(case["xk"], case["xi"], order=2, device=CPU)
    assert (plan.route.path, plan.route.assembly) == ("kernel", "rows")
    assert wtt.plan_fit_many(case["xk"][:, :14], case["xi"], order=2,
                             device=CPU).route.path == "xla"
    res = wtt.fit_many(*args, nk=case["nk"], order=2, plan=plan, device=CPU)
    auto = wtt.fit_many(*args, nk=case["nk"], order=2, device=CPU)
    _, ref = _jax(*args, nk=case["nk"], order=2)
    assert rel_err(res.fi.numpy(), ref) <= PARITY
    assert rel_err(auto.fi.numpy(), ref) <= PARITY


def test_mixed_order_auto_matches():
    """Per-case orders, weightings and knowns: the knowns-free buckets run on
    the moment kernel, the knowns buckets on the rows kernel, and the
    buckets below K >= 1.5 NO (none here) in one engine call."""
    rng = np.random.default_rng(3)
    case = cloud(rng, 512, 30, 2, orders=(0, 1, 2, 3, 4), weightings=(1, 2),
                 radius=(0.3, 1.0))
    case["knowns"][::4] = wt.b2_F
    args = (case["xk"], case["fk"], case["xi"])
    kw = dict(nk=case["nk"], order=case["order"], knowns=case["knowns"],
              weighting=case["weighting"], fi_init=case["fi0"])
    res = wtt.fit_many(*args, backend="auto", device=CPU, **kw)
    _, ref = _jax(*args, **kw)
    assert rel_err(res.fi.numpy(), ref) <= PARITY
    # inactive trailing DOFs keep fi_init, as in the JAX package
    low = case["order"] < 4
    np.testing.assert_array_equal(res.fi.numpy()[low, 10:], case["fi0"][low, 10:])


def test_iterative_auto_matches():
    rng = np.random.default_rng(4)
    case = cloud(rng, 256, 30, 2, orders=(2, 4), weightings=(2,), radius=(0.3, 1.0))
    args = (case["xk"], case["fk"], case["xi"])
    kw = dict(nk=case["nk"], order=case["order"], iterative=True, max_iter=3,
              weighting=2)
    res = wtt.fit_many(*args, device=CPU, **kw)
    _, ref = _jax(*args, **kw)
    assert rel_err(res.fi.numpy(), ref) <= PARITY
    assert int(res.iterations.min()) >= 1


def test_backend_names_of_both_packages():
    xk, fk, xi = _headline(B=128)
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER, device=CPU)
    k = wtt.fit_many(xk, fk, xi, backend="kernel", **kw).fi
    assert torch.equal(k, wtt.fit_many(xk, fk, xi, backend="pallas", **kw).fi)
    e = wtt.fit_many(xk, fk, xi, backend="engine", **kw).fi
    assert torch.equal(e, wtt.fit_many(xk, fk, xi, backend="xla", **kw).fi)
    assert rel_err(k.numpy(), e.numpy()) <= PARITY


def test_rejections():
    xk, fk, xi = _headline(B=16)
    with pytest.raises(ValueError):
        wtt.fit_many(xk, fk, xi, order=4, backend="bogus", device=CPU)
    with pytest.raises(ValueError):
        wtt.fit_many(xk, fk, xi, order=4, precision="ds", device=CPU)
    with pytest.raises(ValueError):
        wtt.fit_many(xk, fk, xi, order=4, weighting=7, device=CPU)
    with pytest.raises(ValueError):   # knowns are homogeneous per kernel launch
        wtt.fit_many(xk, fk, xi, order=4, knowns=np.array([0, 1] * 8),
                     backend="kernel", device=CPU)
    with pytest.raises(ValueError):
        wtt.plan_fit_many(xk, xi, order=np.array([2, 3]), device=CPU)
    with pytest.raises(ValueError, match=r"\[5, 7\]"):
        wtt.fit_many(xk, fk, xi, order=4, weighting=np.array([1, 5, 2, 7] * 4),
                     device=CPU)
    with pytest.raises(ValueError):
        wtt.fit_many(xk, fk, xi, order=np.array([4, 3] * 8), backend="kernel",
                     device=CPU)
    with pytest.raises(ValueError, match="moments"):   # a moment plan cannot sens
        plan = wtt.plan_fit_many(xk, xi, order=4, device=CPU)
        wtt.fit_many(xk, fk, xi, order=4, plan=plan, do_sens=True, device=CPU)


def test_per_case_tensor_parameters():
    """Per-case parameters given as tensors: a homogeneous batch may be
    forced onto the kernel, and auto routing groups on the device."""
    xk, fk, xi = _headline(B=64)
    t = torch.as_tensor
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER, device=CPU)
    ref = wtt.fit_many(xk, fk, xi, **kw).fi
    forced = wtt.fit_many(t(xk), t(fk), t(xi), order=torch.full((64,), 4),
                          weighting=torch.full((64,), 2), backend="kernel",
                          device=CPU)
    assert torch.equal(forced.fi, ref)
    order = torch.tensor([4, 2] * 32)
    auto = wtt.fit_many(t(xk), t(fk), t(xi), order=order, weighting=2,
                        device="cpu")
    assert torch.equal(auto.fi[::2], ref[::2])
    two = wtt.fit_many(xk[1::2], fk[1::2], xi[1::2], order=2, weighting=2,
                       device=CPU).fi
    torch.testing.assert_close(auto.fi[1::2, :6], two, rtol=0, atol=0)


def test_single_fit_matches_batch():
    xk, fk, xi = _headline(B=4)
    one = wtt.fit(xk[1], fk[1], xi[1], order=4, weighting=wtt.WEIGHT_CENTER,
                  device=CPU)
    many = wtt.fit_many(xk, fk, xi, order=4, weighting=wtt.WEIGHT_CENTER, device=CPU)
    assert one.fi.shape == (15,)
    torch.testing.assert_close(one.fi, many.fi[1], rtol=1e-13, atol=1e-13)


def test_no_device_and_no_card_raises(monkeypatch):
    """Without ``device=`` the port computes on the card; with no card it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xk, fk, xi = _headline(B=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wtt.fit_many(xk, fk, xi, order=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wtt.fit_many(torch.as_tensor(xk), torch.as_tensor(fk), torch.as_tensor(xi),
                     order=4)
    with pytest.raises(RuntimeError):
        wtt.plan_fit_many(xk, xi, order=4)
    with pytest.raises(RuntimeError):
        wtt.fit(xk[0], fk[0], xi[0], order=4)
    assert wtt.fit_many(xk, fk, xi, order=4, device=CPU).fi.device.type == "cpu"
