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
from torch_port_cases import cloud, rel_err, roomy_units
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


def test_knowns_batch_goes_to_the_engine_and_matches(monkeypatch):
    """A knowns batch with sens: the plan picks the rows kernel (before the
    rows kernel existed it went to the engine); both match the JAX f64
    route, and the known DOFs keep their prescribed values bit-exactly.
    Routing by configuration: the record certifies every case."""
    roomy_units(monkeypatch)
    rng = np.random.default_rng(1)
    case = cloud(rng, 256, 30, 2, orders=(3,), weightings=(2,), radius=(0.3, 1.0))
    kn = wt.b2_F | wt.b2_XY
    args = (case["xk"], case["fk"], case["xi"])
    kw = dict(nk=case["nk"], order=3, knowns=kn, weighting=2, fi_init=case["fi0"],
              device=CPU)
    plan = wtt.plan_fit_many(case["xk"], case["xi"], nk=case["nk"], order=3, knowns=kn,
                             weighting=2, do_sens=True, device=CPU)
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


def test_3d_batch_goes_to_the_engine_and_matches(monkeypatch):
    """3D: the rows kernel where K >= 1.5 NO (it went to the engine before
    the rows kernel existed), the engine below that.  Routing by
    configuration: the record certifies every case."""
    roomy_units(monkeypatch)
    rng = np.random.default_rng(2)
    case = cloud(rng, 256, 24, 3, orders=(2,), weightings=(1,), radius=(0.3, 1.0))
    args = (case["xk"], case["fk"], case["xi"])
    plan = wtt.plan_fit_many(case["xk"], case["xi"], nk=case["nk"], order=2, device=CPU)
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
    with pytest.raises(ValueError, match="f64"):
        wtt.fit_many(xk, fk, xi, order=4, precision="bogus", device=CPU)
    ref = wtt.fit_many(xk, fk, xi, order=4, device=CPU).fi
    for name in ("f64", "ds", "mixed", "fast"):     # the JAX names: each computes in f64
        assert torch.equal(wtt.fit_many(xk, fk, xi, order=4, precision=name,
                                        device=CPU).fi, ref)
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


def test_mixed_steps_none_is_the_reference_call_and_others_are_refused():
    """A call written for the reference, ``mixed_steps=None`` in its
    position after ``refine_steps``, runs through both packages and agrees;
    any other value names the JAX package's emulated precisions."""
    xk, fk, xi = _headline(B=256)
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER, refine_steps=None, mixed_steps=None)
    got = wtt.fit_many(xk, fk, xi, device=CPU, **kw)
    ref = wt.fit_many(xk, fk, xi, backend="xla", precision="f64", **kw)
    assert rel_err(got.fi.numpy(), np.asarray(ref.fi)) <= PARITY
    for bad in (0, 2):
        with pytest.raises(ValueError, match="emulated precisions.*mixed"):
            wtt.fit_many(xk, fk, xi, order=4, mixed_steps=bad, device=CPU)


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


# ---------------------------------------------------------------------------
# The certified auto route: probe, ladder, per-case split
# ---------------------------------------------------------------------------

def _straddling(B=1024, K=30, seed=51):
    """2D order-4 clouds with radii log-uniform in [0.15, 1]: their keys span
    three decades around the card's certified edge, about four in five under it."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(-1, 1, (B, 2))
    r = np.exp(rng.uniform(np.log(0.15), np.log(1.0), B))
    xk = xi[:, None, :] + r[:, None, None] * rng.uniform(-1, 1, (B, K, 2))
    fk = np.sin(3 * xk[..., 0]) * np.cos(2 * xk[..., 1]) + 0.3 * xk[..., 0] * xk[..., 1]
    return xk, fk, xi


def test_certified_auto_route_matches_jax_f64(monkeypatch):
    """The slice as a whole.  One record serves both packages: the moment
    body's units as measured on the card, in the JAX record's pair fields
    (which stand for FP64; its triple units are tiny so that its tail kernel
    plays the port's engine).  Both packages plan a "kernel-split" of the moment body at that
    edge; the port's replay and its eager auto route hold every certified
    case to 1e-10 of the JAX f64 route, and every tail case (the f64 engine
    here, against the f64 engine there) to 1e-11 — the unrefined-DOF bound of
    tests/test_torch_engine.py — times max(cond_2 amp / 1e3, 1) of the case:
    two f64 solves differ by ~eps cond_2, and the de-scale multiplies that by
    amp = max(inv_s, 1)^order, which is what puts a case in the tail."""
    import dataclasses

    import jax

    from wlsqm_tpu import api as japi
    from wlsqm_tpu.fitter import calibration as jcal
    from wlsqm_tpu.fitter import condprobe as jprobe
    from wlsqm_tpu.fitter import engine_ds
    from wlsqm_tpu.fitter import ladder as jladder
    from wlsqm_tpu_torch import api
    from wlsqm_tpu_torch.fitter import calibration, condprobe
    from wlsqm_tpu_torch.utils import interop

    xk, fk, xi = _straddling()
    B = len(xk)
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER)
    t = [torch.as_tensor(a) for a in (xk, fk, np.full(B, 30, np.int32), xi)]
    fi_k, key = fit_kernel.fit_kernel(*t, dimension=2, emit_cond=True, **kw)
    card = calibration._H100
    edge = 1e-10 / (4 * card["est_f64_cert_unit_m"])
    jrec = jcal.DeviceCalibration(
        ds_unit=card["f64_unit_m"], ds_cert_unit=card["f64_cert_unit_m"],
        ts_parity_unit=1e-24, beyond_parity_floor=1e-8, kernel_max_floor=1e-3,
        ds_unit_m=card["f64_unit_m"], ds_cert_unit_m=card["f64_cert_unit_m"],
        ts_parity_unit_m=1e-24, est_ds_cert_unit_m=card["est_f64_cert_unit_m"],
        certified=True, source="measured")
    prec = interop.calibration_from_fields(dataclasses.asdict(jrec), f64_from="ds")
    monkeypatch.setattr(jprobe, "_units", lambda: jrec)
    monkeypatch.setattr(condprobe, "_units", lambda: prec)

    # the plans: JAX as on its accelerator (its throughput guard set aside:
    # it compares TPU kernel speeds), the port on CPU tensors
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(engine_ds, "ds_backend_ok", lambda: True)
    monkeypatch.setattr(jladder, "SPLIT_MIN_GAIN", 0.0)
    jroute = japi.plan_fit_many(xk, xi, **kw).route
    monkeypatch.undo()
    monkeypatch.setattr(condprobe, "_units", lambda: prec)
    carried = interop.route_from_fields(dataclasses.asdict(jroute))
    plan = wtt.plan_fit_many(xk, xi, device=CPU, **kw)
    r = plan.route
    assert (r.path, r.assembly, r.kernel_precision) == ("kernel-split", "moments", "f64")
    assert (carried.path, carried.assembly, carried.kernel_precision) == (
        r.path, r.assembly, r.kernel_precision)
    assert carried.split_edge == r.split_edge == pytest.approx(edge)
    over = ~(key <= edge)
    assert r.tail_frac == pytest.approx(float(over.double().mean()) * 1.6)
    assert carried.tail_frac == 1.0      # the JAX window adds one 1,024-case tile of slack

    # the executions
    splits = []
    eager = api._eager_split_group
    monkeypatch.setattr(api, "_eager_split_group",
                        lambda *a, **k: splits.append(k["edge"]) or eager(*a, **k))
    res_plan = wtt.fit_many(xk, fk, xi, plan=plan, device=CPU, **kw)
    res_auto = wtt.fit_many(xk, fk, xi, backend="auto", device=CPU, **kw)
    assert splits == [r.split_edge]                      # the eager route did split
    assert torch.equal(res_plan.fi, res_auto.fi)         # the window held the whole tail
    assert torch.equal(res_auto.fi[~over], fi_k[~over])  # certified: the kernel's bits
    assert not torch.equal(res_auto.fi[over], fi_k[over])
    _, ref = _jax(xk, fk, xi, **kw)
    cond, amp = condprobe.probe(xk, None, xi, 4, wtt.WEIGHT_CENTER, dimension=2, sample=B)
    err = np.abs(res_auto.fi.numpy() - ref).max(1) / np.maximum(np.abs(ref).max(1), 1.0)
    sure = ~over.numpy()
    assert 0.7 * B < sure.sum() < 0.9 * B
    assert err[sure].max() <= PARITY
    assert (err[~sure] <= 1e-11 * np.maximum((cond * amp)[~sure] / 1e3, 1.0)).all()
    # forced onto the kernel, the tail is what the certification is for
    assert bool(torch.equal(wtt.fit_many(xk, fk, xi, backend="kernel", device=CPU,
                                         **kw).fi, fi_k))


def test_auto_route_of_an_uncertifiable_batch_is_the_engine(monkeypatch):
    """A collapsed batch has no probe: plan and auto route give it to the
    engine in one call, as the JAX package does
    (tests/test_autorouting.py::test_auto_routes_extreme_conditioning_to_f64)."""
    from wlsqm_tpu_torch.fitter import engine

    xk = np.zeros((64, 30, 2))
    fk = np.ones((64, 30))
    calls = []
    fit_batch = engine.fit_batch
    monkeypatch.setattr(engine, "fit_batch",
                        lambda *a, **k: calls.append(1) or fit_batch(*a, **k))
    assert wtt.plan_fit_many(xk, None, order=2, device=CPU).route.path == "xla"
    res = wtt.fit_many(xk, fk, None, order=2, device=CPU)
    assert calls == [1]
    ref = wtt.fit_many(xk, fk, None, order=2, backend="engine", device=CPU)
    assert torch.equal(torch.nan_to_num(res.fi, 7.0), torch.nan_to_num(ref.fi, 7.0))


def test_plans_name_the_moment_body_where_the_jax_package_does(monkeypatch):
    """The certified route takes the moment body for 1D, for knowns and for
    ALGO_ITERATIVE in 2D (``moment_cert_ok``: dims 1-2), the rows body for
    sensitivities and for 3D; a forced kernel takes the moment body in 3D
    too (``moment_auto_ok``).  Routing by configuration: the record
    certifies every case."""
    roomy_units(monkeypatch)
    rng = np.random.default_rng(9)
    kw = dict(ragged=False, radius=(0.3, 1.0))
    x1 = cloud(rng, 64, 16, 1, orders=(2,), **kw)["xk"]
    x2 = cloud(rng, 64, 30, 2, **kw)["xk"]
    x3 = cloud(rng, 64, 24, 3, orders=(2,), **kw)["xk"]

    def body(xk, **kw):
        r = wtt.plan_fit_many(xk, None, device=CPU, **kw).route
        assert r.path == "kernel", (xk.shape, kw, r)
        return r.assembly

    assert body(x1, order=2) == "moments"
    assert body(x2, order=4, knowns=wt.b2_F) == "moments"
    assert body(x2, order=4, iterative=True) == "moments"
    assert body(x2, order=4, knowns=wt.b2_F, iterative=True) == "moments"
    assert body(x2, order=4, do_sens=True) == "rows"
    assert body(x3, order=2) == "rows"
    calls = []
    real = fit_kernel.fit_kernel
    monkeypatch.setattr(fit_kernel, "fit_kernel",
                        lambda *a, **k: calls.append(k["dimension"]) or real(*a, **k))
    wtt.fit_many(x3, np.sin(x3[..., 0]), order=2, backend="kernel", device=CPU)
    wtt.fit_many(x3, np.sin(x3[..., 0]), order=2, device=CPU)
    assert calls == [3]


def test_slice_end_to_end_matches_jax_f64(monkeypatch):
    """The slice as a whole on the CPU (the moment kernel's plain version):
    a 2D batch with known DOFs and ALGO_ITERATIVE through fit_many's auto
    route, a plan and a forced kernel, and a forced 3D order-4 batch at
    K = 48, each against the JAX package's f64 route to 1e-10; the known
    DOFs are fi_init's bits."""
    roomy_units(monkeypatch)
    rng = np.random.default_rng(10)
    case = cloud(rng, 256, 30, 2, orders=(4,), weightings=(2,), radius=(0.3, 1.0))
    kn = wt.b2_F | wt.b2_Y
    args = (case["xk"], case["fk"], case["xi"])
    kw = dict(nk=case["nk"], order=4, knowns=kn, weighting=2, fi_init=case["fi0"],
              iterative=True, max_iter=3)
    _, ref = _jax(*args, **kw)
    plan = wtt.plan_fit_many(case["xk"], case["xi"], nk=case["nk"], order=4, knowns=kn,
                             weighting=2, iterative=True, device=CPU)
    assert (plan.route.path, plan.route.assembly) == ("kernel", "moments")
    for extra in (dict(), dict(plan=plan), dict(backend="kernel")):
        res = wtt.fit_many(*args, device=CPU, **kw, **extra)
        assert rel_err(res.fi.numpy(), ref) <= PARITY, extra
        np.testing.assert_array_equal(res.fi.numpy()[:, [0, 2]], case["fi0"][:, [0, 2]])
        assert 1 <= int(res.iterations.min()) and int(res.iterations.max()) <= 3
    c3 = cloud(rng, 128, 48, 3, orders=(4,), weightings=(2,), radius=(0.3, 1.0))
    a3 = (c3["xk"], c3["fk"], c3["xi"])
    res = wtt.fit_many(*a3, nk=c3["nk"], order=4, weighting=2, backend="kernel", device=CPU)
    _, ref3 = _jax(*a3, nk=c3["nk"], order=4, weighting=2)
    assert rel_err(res.fi.numpy(), ref3) <= PARITY
