"""The port's per-device calibration store and harness against the JAX package's.

The cases of tests/test_calibration.py on the port's record (one arithmetic,
two kernel bodies): the shipped record, refusal on an unknown device kind,
the one-time warning, persistence, the env override, a corrupt store.  Then
``calibrate_device``'s fit logic: both packages' kernels are replaced by the
same synthetic errors and keys (oracle + unit * cond·amp), and the units both
harnesses fit from them agree to 1e-15 relative (they run the same NumPy
arithmetic on the same numbers).
"""

import dataclasses
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wlsqm_tpu.ops.pallas_fit as jpallas
from wlsqm_tpu.fitter import calibration as jcal
from wlsqm_tpu.fitter import condprobe as jprobe
from wlsqm_tpu_torch.fitter import calibration, condprobe, ladder
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows
from wlsqm_tpu_torch.utils import interop

torch.set_num_threads(1)

KIND = "NVIDIA H999 hypothetical"


@pytest.fixture(autouse=True)
def _fresh_cache(tmp_path, monkeypatch):
    """Each test starts with no cached record, no env override, and a store
    of its own (never the package's build directory)."""
    monkeypatch.delenv("WLSQM_TPU_CALIBRATION", raising=False)
    monkeypatch.setattr(calibration, "_store_path",
                        lambda: str(tmp_path / "device_calibration.json"))
    calibration._reset_cache()
    jcal._reset_cache()
    yield
    calibration._reset_cache()
    jcal._reset_cache()


def _cond_amp(cond, amp=1.0):
    return (np.asarray([float(cond)]), np.asarray([float(amp)]))


def _record(**kw):
    rec = dict(f64_unit=3e-16, f64_cert_unit=2e-15, f64_unit_m=4e-16,
               f64_cert_unit_m=3e-15)
    rec.update(kw)
    return calibration.DeviceCalibration(**rec, certified=True, source="measured")


def test_shipped_record_on_cpu():
    """The CPU serves the logic tests and carries the card's numbers."""
    cal = calibration.active()
    assert calibration.device_kind() == "cpu"
    assert cal.certified and cal.source == "shipped"
    assert cal == calibration.DeviceCalibration(**calibration._H100)
    assert cal.units_for("rows") == (cal.f64_unit, cal.f64_cert_unit)
    assert cal.units_for("moments") == (cal.f64_unit_m, cal.f64_cert_unit_m)
    for f in dataclasses.fields(cal):
        if f.name.endswith(("unit", "unit_m")) and not f.name.startswith("data_"):
            assert 1e-16 <= getattr(cal, f.name) <= 1e-14, f.name    # the 53-bit class
    # the data units carry the calibration field's DOF-to-value ratio (~50-90)
    # on top of that class, and gate each body more tightly than its key
    for unit, key_unit in ((cal.data_unit, cal.est_f64_cert_unit),
                           (cal.data_unit_m, cal.est_f64_cert_unit_m)):
        assert 1e-14 <= unit <= 1e-12 and unit > 10 * key_unit


def test_shipped_record_matches_the_card_by_name(monkeypatch):
    monkeypatch.setattr(calibration, "device_kind", lambda: "NVIDIA H100 80GB HBM3")
    cal = calibration.active()
    assert cal.certified and cal.source == "shipped"


def test_unknown_device_refuses_certification(monkeypatch):
    """No calibration record: the certification gates refuse and the ladder
    keeps certified bands off the kernel."""
    monkeypatch.setattr(calibration, "device_kind", lambda: KIND)
    with pytest.warns(UserWarning, match="no accuracy calibration"):
        cal = calibration.active()
    assert not cal.certified and cal.source == "default"
    ca = _cond_amp(10.0)                 # trivially well conditioned
    assert not condprobe.accuracy_ok_from(ca)
    assert not condprobe.accuracy_ok_from(ca, assembly="moments")
    assert condprobe.est_certified_edges() == {}
    assert ladder.choose(ca, moments_ok=True).path == "xla"
    # the conditioning-limited regime makes no certification claim and keeps
    # the kernel's speed
    floor_ca = (cal.beyond_parity_floor * 2) / cal.f64_unit
    r = ladder.choose(_cond_amp(floor_ca), moments_ok=True)
    assert (r.path, r.assembly) == ("kernel", "moments")


def test_unknown_device_warns_once(monkeypatch):
    monkeypatch.setattr(calibration, "device_kind", lambda: KIND + " 2")
    with pytest.warns(UserWarning):
        calibration.active()
    with warnings.catch_warnings():      # cached: no second warning
        warnings.simplefilter("error")
        assert not calibration.active().certified


def test_measured_record_roundtrip(monkeypatch):
    """A persisted measured record wins over the uncalibrated default and
    over the shipped table."""
    for kind in (KIND, "NVIDIA H100 80GB HBM3"):
        monkeypatch.setattr(calibration, "device_kind", lambda kind=kind: kind)
        calibration._persist(kind, _record(est_f64_cert_unit_m=5e-15))
        calibration._reset_cache()
        got = calibration.active()
        assert got.certified and got.source == "measured"
        assert got.f64_cert_unit == 2e-15 and got.est_f64_cert_unit_m == 5e-15
        assert got.est_f64_cert_unit is None
    edge = condprobe.AUTO_TOL / (condprobe.SAFETY * 2e-15)
    assert condprobe.accuracy_ok_from(_cond_amp(edge * 0.9))
    assert not condprobe.accuracy_ok_from(_cond_amp(edge * 1.1))
    data = json.loads(open(calibration._store_path()).read())
    assert set(data) == {calibration._key(KIND), calibration._key("NVIDIA H100 80GB HBM3")}
    assert "source" not in data[calibration._key(KIND)]


def test_env_override_wins(tmp_path, monkeypatch):
    store = tmp_path / "site_cal.json"
    store.write_text(json.dumps({calibration._key(KIND): dict(
        f64_unit=1e-16, f64_cert_unit=5e-16, certified=True)}))
    calibration._persist(KIND, _record())
    monkeypatch.setenv("WLSQM_TPU_CALIBRATION", str(store))
    monkeypatch.setattr(calibration, "device_kind", lambda: KIND)
    got = calibration.active()
    assert got.source == "env" and got.f64_cert_unit == 5e-16
    assert got.f64_cert_unit_m == 5e-16          # a missing body takes the other's
    assert got.est_f64_cert_unit is None and got.est_f64_cert_unit_m is None


def test_corrupt_store_falls_through():
    with open(calibration._store_path(), "w") as f:
        f.write("{not json")
    cal = calibration.active()           # cpu: the shipped record still found
    assert cal.certified and cal.source == "shipped"
    with open(calibration._store_path(), "w") as f:
        json.dump({calibration._key("cpu"): {"f64_unit": "x"}}, f)
    calibration._reset_cache()
    assert calibration.active().source == "shipped"


def test_version_keys_the_store(monkeypatch):
    """A record persisted by another harness version is not trusted."""
    calibration._persist("cpu", _record())
    calibration._reset_cache()
    assert calibration.active().source == "measured"
    monkeypatch.setattr(calibration, "VERSION", calibration.VERSION + 1)
    calibration._reset_cache()
    assert calibration.active().source == "shipped"


def test_strong_oracle_is_the_jax_one():
    for weighting in (1, 2):
        xk, fk, xi = calibration._problem(np.random.default_rng(4), 32, 30, 0.3, 2)
        jxk, jfk, jxi = jcal._problem(np.random.default_rng(4), 32, 30, 0.3, 2)
        np.testing.assert_array_equal(xk, jxk)
        np.testing.assert_array_equal(fk, jfk)
        np.testing.assert_array_equal(calibration._strong_oracle(xk, xi, fk, weighting, 2),
                                      jcal._strong_oracle(jxk, jxi, jfk, weighting, 2))


def test_reduced_oracle_without_knowns_is_the_strong_oracle():
    """With no known DOF the reduced system is the whole one, in dims 1-3:
    to 1e-15 relative to max(|ref|, 1) (the same operations; NumPy's
    einsum may sum a copied column slice in another order)."""
    rng = np.random.default_rng(11)
    for dim, order in ((1, 4), (2, 4), (3, 2)):
        xk = rng.uniform(-1, 1, (16, 24, dim))
        xi = rng.uniform(-0.1, 0.1, (16, dim))
        fk = np.sin(3 * xk[..., 0])
        for weighting in (1, 2):
            ref = calibration._strong_oracle(xk, xi, fk, weighting, dim, order)
            got = calibration._reduced_oracle(xk, xi, fk, np.zeros((16, 35)), [], weighting,
                                              dim, order)
            assert (np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1)).max() <= 1e-15


def test_oracle_case_errors_fit_each_case_on_its_own_neighbours():
    """Ragged cases (NaN past nk) with a known DOF: the oracle's fit has
    fi0's bits on the known DOF and holds the f64 engine to 1e-10; a fit
    moved by 1e-6 on one case shows that case's error and no other's."""
    from wlsqm_tpu_torch.fitter import engine

    rng = np.random.default_rng(12)
    B, K, dim, order = 8, 16, 1, 3
    xk = rng.uniform(-1, 1, (B, K, dim))
    xi = np.zeros((B, dim))
    fk = np.sin(3 * xk[..., 0])
    nk = rng.integers(9, K + 1, B).astype(np.int32)
    pad = np.arange(K)[None, :] >= nk[:, None]
    xk[pad] = np.nan
    fk[pad] = np.nan
    fi0 = rng.standard_normal((B, 4))
    t = [torch.as_tensor(a) for a in (xk, fk, nk, xi, fi0)]
    fi, _, _, _ = engine.fit_batch(*t, torch.full((B,), order), torch.full((B,), 1),
                                   torch.full((B,), 2), dimension=dim, NO=4)
    moved = fi.clone()
    moved[3, 1] += 1e-6 * max(float(fi[3].abs().max()), 1.0)
    err = calibration.oracle_case_errors([fi, moved], t[0], t[1], t[2], t[3],
                                         t[4], [0], 2, dim, order)
    assert err[0].max() <= 1e-10
    assert abs(err[1, 3] - 1e-6) <= 1e-9 and np.array_equal(np.delete(err[1], 3),
                                                           np.delete(err[0], 3))


def test_calibrate_device_fit_logic_matches_jax(monkeypatch):
    """Both harnesses on the same synthetic kernels: err = unit * (the case's
    cond·amp) on top of the oracle, key = 1.5 * cond·amp.  JAX's ds variants
    and the port's two bodies get the same units, so each pair of fitted
    units agrees to 1e-15; the record persists and reloads."""
    monkeypatch.setattr(calibration, "device_kind", lambda: KIND)
    monkeypatch.setattr(jcal, "device_kind", lambda: KIND)
    monkeypatch.setattr(jcal, "_store_path", lambda: None)
    true = {"rows": 5e-15, "moments": 8e-15}
    state = {}

    def synth(xk, xi, fk, weighting, assembly):
        key = (float(xk.sum()), weighting)
        if key not in state:
            ref = calibration._strong_oracle(xk, xi, fk, weighting, 2)
            cond, amp = condprobe.probe(xk, None, xi, 4, weighting, dimension=2,
                                        sample=len(ref))
            state[key] = ref, cond * amp
        ref, ca = state[key]
        pert = (true[assembly] * ca)[:, None] * np.abs(ref).max(-1, keepdims=True)
        return ref + pert, 1.5 * ca

    def fake_pallas(xk, fk, nk, xi, **kw):
        fi, est = synth(np.asarray(xk), np.asarray(xi), np.asarray(fk), kw["weighting"],
                        kw["assembly"])
        if kw.get("precision", "ds") != "ds":       # the JAX-only arithmetics
            fi = state[(float(np.asarray(xk).sum()), kw["weighting"])][0]
        return (jnp.asarray(fi), jnp.asarray(est)) if kw.get("emit_cond") else jnp.asarray(fi)

    def fake_rows(xk, fk, nk, xi, **kw):
        fi, est = synth(xk.numpy(), xi.numpy(), fk.numpy(), kw["weighting"], "rows")
        return torch.as_tensor(fi), None, None, torch.as_tensor(est)

    def fake_moments(xk, fk, nk, xi, **kw):
        fi, est = synth(xk.numpy(), xi.numpy(), fk.numpy(), kw["weighting"], "moments")
        return torch.as_tensor(fi), torch.as_tensor(est)

    monkeypatch.setattr(jpallas, "fit_pallas", fake_pallas)
    monkeypatch.setattr(fit_rows, "fit_rows", fake_rows)
    monkeypatch.setattr(fit_kernel, "fit_kernel", fake_moments)
    args = dict(batch=64, radii=(0.3, 1.0))
    jrec = jcal.calibrate_device(persist=False, **args)
    cal = calibration.calibrate_device(persist=True, device="cpu", **args)
    assert cal.certified and cal.source == "measured"
    for mine, theirs in (("f64_unit", "ds_unit"), ("f64_cert_unit", "ds_cert_unit"),
                         ("f64_unit_m", "ds_unit_m"), ("f64_cert_unit_m", "ds_cert_unit_m"),
                         ("est_f64_cert_unit_m", "est_ds_cert_unit_m")):
        assert getattr(cal, mine) == pytest.approx(getattr(jrec, theirs), rel=1e-15), mine
    # edge-anchored: err = unit * ca stays under tol / HEADROOM over the whole
    # sweep here, so the edge clamps to the swept maximum and the fitted unit
    # lands within a small factor above the true one
    assert true["rows"] <= cal.f64_cert_unit <= 4 * true["rows"]
    assert cal.f64_unit == pytest.approx(true["rows"], rel=1e-6)
    assert cal.f64_unit_m == pytest.approx(true["moments"], rel=1e-6)
    # the key carries a uniform 1.5x slack: its unit is the cond·amp one / 1.5
    assert cal.est_f64_cert_unit == pytest.approx(cal.f64_cert_unit / 1.5, rel=1e-12)
    calibration._reset_cache()
    assert calibration.active() == cal
    # carried across by the caller naming the unit that stands for FP64
    carried = interop.calibration_from_fields(dataclasses.asdict(jrec), f64_from="ds")
    assert carried.f64_cert_unit_m == jrec.ds_cert_unit_m
    assert carried.est_f64_cert_unit_m == jrec.est_ds_cert_unit_m


def test_calibrate_device_places_the_edge_where_errors_cross(monkeypatch):
    """Errors that cross tol / CERT_HEADROOM inside the sweep: the certified
    edge is the last cond·amp (or key) whose running worst error is under it."""
    monkeypatch.setattr(calibration, "device_kind", lambda: KIND)
    unit = 4e-14

    def probe_all(xk, xi, w):
        cond, amp = condprobe.probe(xk.numpy(), None, xi.numpy(), 4, w, dimension=2,
                                    sample=xk.shape[0])
        return cond * amp

    def fake_rows(xk, fk, nk, xi, **kw):
        ca = probe_all(xk, xi, kw["weighting"])
        ref = calibration._strong_oracle(xk.numpy(), xi.numpy(), fk.numpy(), kw["weighting"], 2)
        fi = ref + (unit * ca)[:, None] * np.abs(ref).max(-1, keepdims=True)
        return torch.as_tensor(fi), None, None, torch.as_tensor(2.0 * ca)

    monkeypatch.setattr(fit_rows, "fit_rows", fake_rows)
    monkeypatch.setattr(fit_kernel, "fit_kernel",
                        lambda *a, **k: (lambda r: (r[0], r[3]))(fake_rows(*a, **k)))
    cal = calibration.calibrate_device(batch=128, radii=(0.1, 0.3, 1.0), persist=False,
                                       device="cpu")
    # err = unit * ca <= tol / 5  <=>  ca <= tol / (5 unit); the gate's edge
    # tol / (SAFETY * cert_unit) is the last swept ca under it
    crossing = condprobe.AUTO_TOL / (calibration.CERT_HEADROOM * unit)
    edge = condprobe.AUTO_TOL / (condprobe.SAFETY * cal.f64_cert_unit)
    assert 0.5 * crossing < edge <= crossing
    key_edge = condprobe.AUTO_TOL / (condprobe.SAFETY * cal.est_f64_cert_unit)
    assert key_edge == pytest.approx(2.0 * edge, rel=1e-12)
    assert cal.f64_cert_unit_m == cal.f64_cert_unit


def test_calibration_from_fields_needs_the_f64_unit_named():
    jrec = jcal.DeviceCalibration(**jcal._V5E)
    fields = dataclasses.asdict(jrec)
    with pytest.raises(TypeError):
        interop.calibration_from_fields(fields)
    with pytest.raises(ValueError, match="f64_from"):
        interop.calibration_from_fields(fields, f64_from="dsts")
    ds = interop.calibration_from_fields(fields, f64_from="ds")
    ts = interop.calibration_from_fields(fields, f64_from="ts")
    assert (ds.f64_cert_unit, ds.f64_cert_unit_m) == (jrec.ds_cert_unit, jrec.ds_cert_unit_m)
    assert (ts.f64_cert_unit, ts.f64_cert_unit_m) == (jrec.ts_parity_unit,
                                                      jrec.ts_parity_unit_m)
    assert ds.est_f64_cert_unit_m == jrec.est_ds_cert_unit_m
    assert ts.est_f64_cert_unit_m == jrec.est_ts_parity_unit_m
    assert ds.f64_unit == ts.f64_unit == jrec.ds_unit
    assert ds.certified and ds.source == "shipped"
    assert jprobe.AUTO_TOL == condprobe.AUTO_TOL and jprobe.SAFETY == condprobe.SAFETY
