"""The port's routing ladder against the JAX package's, on fake units.

``ladder.choose`` is a pure function of a probe result and a calibration
record.  One fake JAX record is carried across with
``interop.calibration_from_fields(..., f64_from="ts")``: the JAX triple-single
units stand for FP64 (its pair units are set so loose that they never
certify), and each JAX route is carried across with
``interop.route_from_fields``.  Where the decision has an FP64 meaning both
ladders agree on path, kernel body and arithmetic; the sweep counts are each
package's own.
"""

import dataclasses

import numpy as np
import pytest

from wlsqm_tpu.fitter import calibration as jcal
from wlsqm_tpu.fitter import condprobe as jprobe
from wlsqm_tpu.fitter import ladder as jladder
from wlsqm_tpu_torch.fitter import calibration, condprobe, ladder
from wlsqm_tpu_torch.ops import fit_kernel
from wlsqm_tpu_torch.utils import interop

ROWS_UNIT, MOM_UNIT, CENTRAL = 7e-16, 9e-16, 5e-16
ROWS_EDGE = 1e-10 / (4 * ROWS_UNIT)      # 35,714
MOM_EDGE = 1e-10 / (4 * MOM_UNIT)        # 27,778


@pytest.fixture
def units(monkeypatch):
    jrec = jcal.DeviceCalibration(
        ds_unit=CENTRAL, ds_cert_unit=1.0, ts_parity_unit=ROWS_UNIT,
        beyond_parity_floor=1e-8, kernel_max_floor=1e-3, ds_unit_m=CENTRAL,
        ds_cert_unit_m=1.0, ts_parity_unit_m=MOM_UNIT, certified=True, source="measured")
    prec = interop.calibration_from_fields(dataclasses.asdict(jrec), f64_from="ts")
    monkeypatch.setattr(jprobe, "_units", lambda: jrec)
    monkeypatch.setattr(condprobe, "_units", lambda: prec)
    return jrec, prec


def _ca(ca, amp=1.0):
    return (np.array([1.0, ca / amp]), np.array([1.0, amp]))


def _carried(jroute):
    return interop.route_from_fields(dataclasses.asdict(jroute))


# (cond·amp maximum, expected path, expected body with both kernels available)
TABLE = [
    (10.0, "kernel", "moments"),
    (0.99 * MOM_EDGE, "kernel", "moments"),
    (1.01 * MOM_EDGE, "kernel", "rows"),           # the rows envelope reaches further
    (0.99 * ROWS_EDGE, "kernel", "rows"),
    (1.01 * ROWS_EDGE, "xla", None),               # the middle band: no batch-level kernel
    (1e6, "xla", None),
    (0.9e-8 / CENTRAL, "xla", None),
    (2e-8 / CENTRAL, "kernel", "moments"),         # conditioning-limited: uncertified kernel
    (0.9e-3 / CENTRAL, "kernel", "moments"),
    (1.1e-3 / CENTRAL, "xla", None),               # degenerate: fail safe
    (float("inf"), "xla", None),
]


@pytest.mark.parametrize("ca,path,body", TABLE)
def test_choose_decision_table(units, ca, path, body):
    for amp in (1.0, 256.0):
        r = ladder.choose(_ca(ca, amp), moments_ok=True)
        assert r.path == path, (ca, amp)
        assert r.kernel_precision == "f64" and r.precision == "f64"
        assert r.mixed_steps is None and r.tail_refine_steps is None
        if path == "kernel":
            assert r.assembly == body
            assert r.refine_steps == fit_kernel.DEFAULT_REFINE_STEPS
            assert r.split_edge is None and r.tail_frac == 0.0


@pytest.mark.parametrize("ca,path,body", TABLE)
def test_choose_agrees_with_the_jax_ladder(units, ca, path, body):
    """The JAX ladder on the same record (triple-single standing for FP64):
    the same path everywhere, and the same body wherever the JAX route names
    one the sample certified."""
    cond_amp = _ca(ca)
    for moments_ok in (True, False):
        mine = ladder.choose(cond_amp, moments_ok=moments_ok)
        theirs = _carried(jladder.choose(cond_amp, kernel_ok=True, moments_ok=moments_ok))
        assert mine.path == theirs.path == path, (ca, moments_ok)
        assert theirs.kernel_precision == "f64" and theirs.precision == "f64"
        certified = path == "kernel" and ca <= ROWS_EDGE
        if certified or (path == "kernel" and not moments_ok):
            assert mine.assembly == theirs.assembly


def test_choose_without_a_kernel_or_a_probe(units):
    assert ladder.choose(None, moments_ok=True) == ladder.Route(path="xla")
    assert ladder.choose(_ca(10.0), kernel_ok=False) == ladder.Route(path="xla")
    assert ladder.choose(_ca(2e-8 / CENTRAL), kernel_ok=False).path == "xla"
    # only the moment body takes it: certified there, or not at all
    assert ladder.choose(_ca(10.0), kernel_ok=False, moments_ok=True).assembly == "moments"
    assert ladder.choose(_ca(1.01 * MOM_EDGE), kernel_ok=False, moments_ok=True).path == "xla"
    assert _carried(jladder.choose(None)).path == "xla"


def test_choose_honours_tol(units):
    ca = _ca(1.5 * ROWS_EDGE)
    assert ladder.choose(ca).path == "xla"
    assert ladder.choose(ca, tol=2e-10).path == "kernel"
    assert _carried(jladder.choose(ca, tol=2e-10)).path == "kernel"


def test_uncertified_record_keeps_certified_bands_off_the_kernel(units, monkeypatch):
    _, prec = units
    off = dataclasses.replace(prec, certified=False)
    monkeypatch.setattr(condprobe, "_units", lambda: off)
    assert ladder.choose(_ca(10.0), moments_ok=True).path == "xla"
    assert ladder.choose(_ca(2e-8 / CENTRAL), moments_ok=True).path == "kernel"


def test_route_is_hashable_and_defaults():
    r = ladder.Route(path="kernel-split", split_edge=3.7e4, tail_frac=0.25)
    assert hash(r) == hash(dataclasses.replace(r))
    assert (r.kernel_precision, r.assembly, r.precision) == ("f64", "moments", "f64")
    assert {f.name for f in dataclasses.fields(ladder.Route)} == {
        f.name for f in dataclasses.fields(jladder.Route)}
    assert (ladder.SPLIT_MIN_FRAC, ladder.TAIL_MARGIN, ladder.EST_OVER_COND_MED) == (
        jladder.SPLIT_MIN_FRAC, jladder.TAIL_MARGIN, jladder.EST_OVER_COND_MED)


@pytest.mark.parametrize("jroute", [
    jladder.Route(path="kernel"),
    jladder.Route(path="kernel", kernel_precision="ts", assembly="moments", refine_steps=5),
    jladder.Route(path="kernel", kernel_precision="dsts", assembly="auto", refine_steps=3),
    jladder.Route(path="kernel-split", kernel_precision="dsts", assembly="moments",
                  refine_steps=3, tail_refine_steps=4, split_edge=1562.5, tail_frac=0.21),
    jladder.Route(path="xla", precision="fast", mixed_steps=4),
    jladder.Route(path="xla", precision="ds"),
    jladder.Route(path="xla"),
])
def test_route_from_fields(jroute):
    r = _carried(jroute)
    assert isinstance(r, ladder.Route)
    assert r.path == jroute.path
    assert (r.kernel_precision, r.precision) == ("f64", "f64")
    assert r.mixed_steps is None and r.tail_refine_steps is None
    assert r.assembly == ("moments" if jroute.assembly == "auto" else jroute.assembly)
    assert r.refine_steps == jroute.refine_steps
    assert r.split_edge == jroute.split_edge and r.tail_frac == jroute.tail_frac


def test_route_from_fields_rejects_what_it_does_not_know():
    good = dataclasses.asdict(jladder.Route(path="kernel"))
    with pytest.raises(ValueError, match="missing"):
        interop.route_from_fields({k: v for k, v in good.items() if k != "tail_frac"})
    with pytest.raises(ValueError, match="unknown"):
        interop.route_from_fields(dict(good, extra=1))
    with pytest.raises(ValueError, match="kernel_precision"):
        interop.route_from_fields(dict(good, kernel_precision="f16"))
    with pytest.raises(ValueError, match="path"):
        interop.route_from_fields(dict(good, path="tpu"))


def test_shipped_record_orders_the_bodies():
    """On the card's record the rows envelope reaches further than the
    moment body's, in cond·amp and in the key: a batch between the two edges
    takes the rows kernel."""
    calibration._reset_cache()
    u = calibration.active()
    assert u.f64_cert_unit < u.f64_cert_unit_m
    assert u.est_f64_cert_unit < u.est_f64_cert_unit_m
    between = 0.5 * (1e-10 / (4 * u.f64_cert_unit) + 1e-10 / (4 * u.f64_cert_unit_m))
    r = ladder.choose(_ca(between), moments_ok=True)
    assert (r.path, r.assembly) == ("kernel", "rows")
