"""The port's conditioning probe and certification gates against the JAX package's.

The same NumPy inputs go through ``wlsqm_tpu.fitter.condprobe`` and
``wlsqm_tpu_torch.fitter.condprobe`` (``device="cpu"``).  Tolerances:

* the sampled probe's cond is float64 in both packages (the JAX package's
  a NumPy SVD, the port's a torch eigensolver): cond to 1e-8 relative, amp
  equal;
* the per-case key: the JAX reference computes it in float32, so the two
  agree to 5e-2 relative (median 2e-3) at radii 0.1-1.0; the port's own
  three forms (library calls, the moment body's plain version, the rows
  body's plain version) are float64 and agree to 1e-8;
* the gates are pure functions of a record: equal decisions on a table of
  fake units, the JAX record's unit standing for the FP64 one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wlsqm_tpu.fitter import calibration as jcal
from wlsqm_tpu.fitter import condprobe as jprobe
from wlsqm_tpu_torch.fitter import calibration, condprobe, defs
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows
from wlsqm_tpu_torch.utils import interop

torch.set_num_threads(1)

CPU = "cpu"


def _cloud(rng, B, K, dim, radius=(0.1, 1.0), ragged=True, lo=None):
    xi = rng.uniform(-1, 1, (B, dim))
    r = np.exp(rng.uniform(np.log(radius[0]), np.log(radius[1]), B))
    xk = xi[:, None, :] + r[:, None, None] * rng.uniform(-1, 1, (B, K, dim))
    nk = np.full(B, K, np.int32)
    if ragged:
        nk[1::2] = rng.integers(lo or K - 4, K + 1, B // 2)
        xk[np.arange(K)[None, :] >= nk[:, None]] = np.nan
    return xk, nk, xi


def _fake_units(monkeypatch, **kw):
    """One fake record for both packages: the JAX ds units stand for FP64."""
    rec = dict(ds_unit=2e-15, ds_cert_unit=1.25e-14, ts_parity_unit=7e-16,
               beyond_parity_floor=1e-8, kernel_max_floor=1e-3)
    rec.update(kw)
    jrec = jcal.DeviceCalibration(**rec, certified=True, source="measured")
    prec = interop.calibration_from_fields(dataclasses.asdict(jrec), f64_from="ds")
    monkeypatch.setattr(jprobe, "_units", lambda: jrec)
    monkeypatch.setattr(condprobe, "_units", lambda: prec)
    return jrec, prec


# -- the per-case key ------------------------------------------------------------

@pytest.mark.parametrize("dim,order,K,knowns,weighting", [
    (2, 4, 30, 0, defs.WEIGHT_CENTER),
    (2, 4, 30, 0, defs.WEIGHT_UNIFORM),
    (2, 3, 24, 0b100101, defs.WEIGHT_CENTER),
    (3, 2, 24, 0, defs.WEIGHT_UNIFORM),
    (3, 3, 40, 0b1001, defs.WEIGHT_CENTER),
])
def test_cond_key_matches_jax(dim, order, K, knowns, weighting):
    rng = np.random.default_rng(dim * 10 + order)
    xk, nk, xi = _cloud(rng, 192, K, dim)
    kw = dict(dimension=dim, order=order, knowns=knowns, weighting=weighting)
    got = condprobe.cond_key(xk, nk, xi, device=CPU, **kw).numpy()
    ref = np.asarray(jprobe.cond_key(np.nan_to_num(xk), nk, xi, **kw))
    assert got.dtype == np.float64 and np.isfinite(got).all()
    rel = np.abs(got - ref) / got
    # the JAX key is assembled and factored in float32: ~cond * 6e-8
    assert rel.max() <= 5e-2 and np.median(rel) <= 2e-3


@pytest.mark.parametrize("dim,order,K,knowns", [(2, 4, 30, 0), (2, 2, 16, 0b10),
                                                (3, 2, 24, 0), (1, 4, 16, 0b1)])
def test_plain_kernels_emit_the_library_key(dim, order, K, knowns):
    """cond_key (library calls) is the yardstick of the key both kernels'
    plain versions emit: 1e-8 relative, float64 all."""
    rng = np.random.default_rng(order)
    xk, nk, xi = _cloud(rng, 128, K, dim)
    t = [torch.as_tensor(a) for a in (xk, np.zeros((128, K)), nk, xi)]
    for w in (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER):
        kw = dict(dimension=dim, order=order, weighting=w)
        ref = condprobe.cond_key(xk, nk, xi, knowns=knowns, device=CPU, **kw)
        rows = fit_rows.fit_rows(*t, knowns=knowns, emit_cond=True, **kw)[3]
        torch.testing.assert_close(rows, ref, rtol=1e-8, atol=0)
        if not knowns:
            mom = fit_kernel.fit_kernel(*t, emit_cond=True, **kw)[1]
            torch.testing.assert_close(mom, ref, rtol=1e-8, atol=0)


def test_key_upper_bounds_cond2_times_amp():
    """est >= cond_2(A_jac) * amp for every case, in float64 (the bound the
    calibration leans on); the slack stays modest."""
    rng = np.random.default_rng(5)
    for dim, order, K in ((2, 4, 30), (3, 3, 40)):
        xk, nk, xi = _cloud(rng, 256, K, dim, radius=(0.05, 1.0))
        est = condprobe.cond_key(xk, nk, xi, dimension=dim, order=order,
                                 weighting=defs.WEIGHT_CENTER, device=CPU).numpy()
        cond, amp = condprobe.probe(xk, nk, xi, order, defs.WEIGHT_CENTER,
                                    dimension=dim, sample=256)
        ratio = est / (cond * amp)
        assert (ratio >= 0.999).all() and ratio.max() < 10.0


def test_degenerate_key_never_certifies():
    """Collapsed and collinear neighbourhoods: the key is NaN, inf or huge,
    and compares False against any edge a record can hold."""
    B, K = 16, 30
    xi = np.zeros((B, 2))
    xk = np.zeros((B, K, 2))
    t = np.linspace(-0.8, 0.8, K)
    xk[8:] = np.stack([t, 2 * t], axis=1)
    nk = np.full(B, K, np.int32)
    kw = dict(dimension=2, order=4, weighting=defs.WEIGHT_UNIFORM)
    keys = [condprobe.cond_key(xk, nk, xi, device=CPU, **kw)]
    tt = [torch.as_tensor(a) for a in (xk, np.zeros((B, K)), nk, xi)]
    keys.append(fit_kernel.fit_kernel(*tt, emit_cond=True, **kw)[1])
    keys.append(fit_rows.fit_rows(*tt, emit_cond=True, **kw)[3])
    for key in keys:
        assert not bool((key <= 1e12).any())
    assert bool(torch.isnan(keys[0][:8]).all())          # the library form says NaN


# -- the sampled probe -----------------------------------------------------------

@pytest.mark.parametrize("dim,knowns", [(2, 0), (2, 0b1001), (3, 0), (1, 0),
                                         (1, 0b10), (3, 0b1001)])
def test_probe_matches_jax(dim, knowns):
    """The probe against the JAX package's on NumPy input, on tensors, and
    with order and weighting per case or scalar, as arrays, tensors and
    0-dim tensors: cond to 1e-8 relative, amp bit for bit."""
    rng = np.random.default_rng(dim)
    B, K = condprobe.SAMPLE, {1: 12, 2: 30, 3: 40}[dim]   # every case: no ties to break
    top = {1: 4, 2: 4, 3: 3}[dim]
    xk, nk, xi = _cloud(rng, B, K, dim, radius=(0.03, 1.0))
    order = rng.integers(1, top + 1, B).astype(np.int32)
    weighting = rng.choice([1, 2], B).astype(np.int32)
    geo = [torch.as_tensor(a) for a in (xk, nk, xi)]
    for (o, w), tensors in (((order, weighting), False), ((top, defs.WEIGHT_CENTER), False),
                            ((order, weighting), True), ((top, defs.WEIGHT_UNIFORM), True)):
        ref = jprobe.probe(np.nan_to_num(xk), nk, xi, o, w, dimension=dim, knowns=knowns)
        if tensors:
            got = condprobe.probe(*geo, torch.as_tensor(o), torch.as_tensor(w),
                                  dimension=dim, knowns=knowns)
        else:
            got = condprobe.probe(xk, nk, xi, o, w, dimension=dim, knowns=knowns)
        assert got[0].shape == ref[0].shape
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-8)
        np.testing.assert_array_equal(got[1], ref[1])


def test_probe_runs_no_numpy_linear_algebra(monkeypatch):
    """On tensors the sample's matrices and their cond are torch's: NumPy's
    einsum and linear algebra raise here, and the probe still runs (the
    screen included)."""
    rng = np.random.default_rng(3)
    xk, nk, xi = _cloud(rng, 4 * condprobe.SAMPLE, 30, 2)
    ref = condprobe.probe(xk, nk, xi, 4, defs.WEIGHT_CENTER, dimension=2)

    def refuse(*a, **k):
        raise AssertionError("NumPy linear algebra in the probe")

    for name in ("cond", "svd", "eigvalsh", "eigh", "norm", "inv"):
        monkeypatch.setattr(np.linalg, name, refuse)
    monkeypatch.setattr(np, "einsum", refuse)
    got = condprobe._cond_amp(*[torch.as_tensor(a) for a in (xk, nk, xi)], 4,
                              defs.WEIGHT_CENTER, dimension=2)
    assert len(got[0]) > condprobe.SAMPLE
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_probe_gives_inf_for_a_singular_finite_sample():
    """Neighbourhoods collapsed onto xi are finite and singular: cond inf in
    both packages, and no None (that is for geometry that is not finite)."""
    rng = np.random.default_rng(4)
    xk, nk, xi = _cloud(rng, 64, 30, 2, ragged=False)
    xk[::4] = xi[::4, None, :]
    got = condprobe.probe(xk, nk, xi, 4, defs.WEIGHT_CENTER, dimension=2)
    ref = jprobe.probe(xk, nk, xi, 4, defs.WEIGHT_CENTER, dimension=2)
    assert np.isinf(got[0][::4]).all() and np.isfinite(got[0][1::4]).all()
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-8)
    assert not condprobe.accuracy_ok_from(got)


def test_probe_takes_tensors_and_none_nk():
    rng = np.random.default_rng(7)
    xk, _, xi = _cloud(rng, 300, 30, 2, ragged=False)
    a = condprobe.probe(xk, None, xi, 4, 2, dimension=2)
    b = condprobe.probe(torch.as_tensor(xk), None, torch.as_tensor(xi),
                        torch.tensor(4), torch.tensor(2), dimension=2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("B", [1, 255, 256, 257, 4096, 65536, 1 << 22])
def test_sample_idx_equals_jax(B):
    np.testing.assert_array_equal(condprobe._sample_idx(B, condprobe.SAMPLE),
                                  jprobe._sample_idx(B, jprobe.SAMPLE))


def test_screened_idx_equals_jax_and_pins_the_outliers():
    """64 small-radius cases and one collinear case among 8,192, off the
    spaced sample: both packages' screens pin them (equal index sets; the
    radius channel ranks by a power of two, so only a full top-64 of
    outliers leaves it no ties to break)."""
    rng = np.random.default_rng(11)
    B, K = 8192, 30
    xk, nk, xi = _cloud(rng, B, K, 2, radius=(0.8, 0.8), ragged=False)
    base = condprobe._sample_idx(B, condprobe.SAMPLE)
    free = np.setdiff1d(np.arange(B), base)
    tiny, line = free[:: len(free) // 64][:64], free[1000]
    assert line not in tiny
    r = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), 64))
    xk[tiny] = xi[tiny, None, :] + r[:, None, None] * rng.uniform(-1, 1, (64, K, 2))
    t = np.linspace(-0.8, 0.8, K)
    xk[line] = xi[line] + np.stack([t, 2 * t], axis=1)
    got = condprobe._screened_idx(torch.as_tensor(xk), torch.as_tensor(nk),
                                  torch.as_tensor(xi), 4, 2, condprobe.SAMPLE)
    ref = jprobe._screened_idx(xk, nk, xi, 4, 2, jprobe.SAMPLE)
    assert set(got.tolist()) == set(ref.tolist())
    assert set(tiny.tolist()) <= set(got.tolist()) and line in got
    amp, aniso = condprobe._screen_math(
        torch.as_tensor(xk), torch.as_tensor(nk), torch.as_tensor(xi),
        torch.full((B,), 4.0, dtype=torch.float64), 2)
    jamp, janiso = jprobe._screen_scalars(xk, nk, xi, 4, 2)
    np.testing.assert_allclose(amp.numpy(), jamp, rtol=1e-12)
    np.testing.assert_allclose(aniso.numpy(), janiso, rtol=1e-9, atol=1e-300)


def test_probe_returns_none_on_unusable_geometry():
    xk = np.full((4, 30, 2), np.nan)
    assert condprobe.probe(xk, None, np.zeros((4, 2)), 4, 1, dimension=2) is None
    assert not condprobe.accuracy_ok_from(None)


# -- the gates on a table of fake units -----------------------------------------------

CA_TABLE = [1.0, 10.0, 1.9e3, 2.1e3, 1.5e3, 1.6e3, 3e4, 4e4, 1e7, float("inf")]


@pytest.mark.parametrize("assembly", ["rows", "moments"])
def test_accuracy_gate_decides_as_jax(monkeypatch, assembly):
    _fake_units(monkeypatch)
    for ca in CA_TABLE:
        for amp in (1.0, 16.0):
            cond_amp = (np.array([1.0, ca / amp]), np.array([1.0, amp]))
            assert (condprobe.accuracy_ok_from(cond_amp, assembly=assembly)
                    == jprobe.accuracy_ok_from(cond_amp, assembly=assembly)), (ca, amp)
    # the edge sits where unit * ca * SAFETY = tol
    _, prec = _fake_units(monkeypatch, ds_cert_unit=2e-14, ds_cert_unit_m=2e-14)
    edge = condprobe.AUTO_TOL / (condprobe.SAFETY * 2e-14)
    one = lambda ca: (np.array([ca]), np.array([1.0]))    # noqa: E731
    assert condprobe.accuracy_ok_from(one(edge * 0.999), assembly=assembly)
    assert not condprobe.accuracy_ok_from(one(edge * 1.001), assembly=assembly)
    assert condprobe.accuracy_ok_from(one(edge * 1.9), tol=2e-10, assembly=assembly)


def test_uncertified_record_refuses_every_gate(monkeypatch):
    _, prec = _fake_units(monkeypatch, est_ds_cert_unit_m=2e-14)
    assert condprobe.accuracy_ok_from((np.array([10.0]), np.array([1.0])))
    assert condprobe.est_certified_edges()["moments"] == pytest.approx(1250.0)
    off = dataclasses.replace(prec, certified=False)
    monkeypatch.setattr(condprobe, "_units", lambda: off)
    assert not condprobe.accuracy_ok_from((np.array([10.0]), np.array([1.0])))
    assert condprobe.est_certified_edges() == {}
    assert condprobe.split_partition_choice() is None


def test_key_edges_and_split_choice(monkeypatch):
    _fake_units(monkeypatch)                         # no key unit recorded
    assert condprobe.est_certified_edges() == {"moments": None, "rows": None}
    assert condprobe.split_partition_choice() is None
    jrec, prec = _fake_units(monkeypatch, est_ds_cert_unit_m=2.26e-14)
    edge = 1e-10 / (4 * 2.26e-14)
    assert jprobe.split_partition_choice() == ("ds", pytest.approx(edge))
    assert condprobe.split_partition_choice() == ("f64", pytest.approx(edge))
    assert condprobe.est_certified_edges(tol=2e-10)["moments"] == pytest.approx(2 * edge)
    assert jprobe.est_certified_edges()["ds"] == condprobe.est_certified_edges()["moments"]
    # each body has its own key unit
    rec = dataclasses.replace(prec, est_f64_cert_unit=1e-15, est_f64_cert_unit_m=None)
    monkeypatch.setattr(condprobe, "_units", lambda: rec)
    assert condprobe.split_partition_choice(assembly="moments") is None
    assert condprobe.split_partition_choice(assembly="rows") == ("f64", pytest.approx(2.5e4))


def test_predicted_error_and_sweep_picks(monkeypatch):
    _, prec = _fake_units(monkeypatch)
    cond, amp = np.array([10.0, 1e4, 1e9]), np.array([1.0, 16.0, 1.0])
    for assembly, unit in (("rows", prec.f64_unit), ("moments", prec.f64_unit_m)):
        pred = condprobe.predicted_error(cond, amp, 1, assembly=assembly)
        rate = condprobe.F32_UNIT * cond
        np.testing.assert_allclose(pred, np.maximum(unit * cond, rate ** 2) * amp)
    # one arithmetic, one sweep count: every pick is the kernels' default
    ca = (cond, amp)
    steps = fit_kernel.DEFAULT_REFINE_STEPS
    assert condprobe.pick_from(ca) == condprobe.pick_from(None) == steps
    assert condprobe.pick_ts_from(ca, assembly="moments") == steps
    assert condprobe.pick_steps_at_edge(5e4) == steps
    xk, nk, xi = _cloud(np.random.default_rng(0), 64, 30, 2)
    assert condprobe.pick_refine_steps(xk, nk, xi, 4, 2, dimension=2) == steps


def test_kernel_accuracy_ok_on_the_radius_sweep(monkeypatch):
    """With the JAX package's own record standing for FP64, the port's gate
    takes and refuses the clouds the JAX gate does (its ds-or-ts rule against
    the port's moments-or-rows rule: here ts = ds, so one envelope each)."""
    _fake_units(monkeypatch, ts_parity_unit=1.25e-14, ts_parity_unit_m=1.6e-14)
    rng = np.random.default_rng(42)
    for radius, K in ((0.05, 30), (0.15, 24), (0.3, 30), (1.0, 40)):
        xk, nk, xi = _cloud(rng, 300, K, 2, radius=(radius, radius), ragged=False)
        for order in (2, 4):
            got = condprobe.kernel_accuracy_ok(xk, nk, xi, order, 2, dimension=2)
            ref = jprobe.kernel_accuracy_ok(xk, nk, xi, order, 2, dimension=2)
            assert got == ref, (radius, order)
    assert not condprobe.kernel_accuracy_ok(np.zeros((64, 30, 2)), None, np.zeros((64, 2)),
                                            4, 1, dimension=2)


def test_shipped_cpu_record_drives_the_gates():
    """Without a fake: the logic runs on the shipped record (the card's units)."""
    calibration._reset_cache()
    u = condprobe._units()
    assert u.certified and u.source == "shipped"
    edges = condprobe.est_certified_edges()
    assert edges["moments"] == pytest.approx(1e-10 / (4 * u.est_f64_cert_unit_m))
    assert edges["rows"] == pytest.approx(1e-10 / (4 * u.est_f64_cert_unit))
