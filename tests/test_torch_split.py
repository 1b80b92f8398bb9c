"""The per-case certified split of the port, on the CPU.

The decision tables of tests/test_split.py that have an FP64 meaning (the
whole-batch upgrade by the exact key maximum, the NaN key that poisons it,
the majority rule, the record that refuses), held against the JAX package's
``_maybe_split_route`` on the same fake keys and the same fake record
(``interop.calibration_from_fields``, the JAX pair units standing for FP64);
and the two split executions against their compositions, bit for bit
(``torch.equal``): on the CPU the kernels run as their plain versions, which
are deterministic, so a split must equal the kernel's result with exactly the
tail cases overwritten by the engine's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu import api as japi
from wlsqm_tpu.fitter import calibration as jcal
from wlsqm_tpu.fitter import condprobe as jprobe
from wlsqm_tpu.fitter import ladder as jladder
from wlsqm_tpu.ops import pallas_fit
from wlsqm_tpu_torch import api
from wlsqm_tpu_torch.fitter import calibration, condprobe, defs, ladder
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows
from wlsqm_tpu_torch.utils import interop

torch.set_num_threads(1)

CPU = "cpu"
KEY_UNIT = 1.6e-14                       # the fake key unit of both packages
EDGE = 1e-10 / (4 * KEY_UNIT)            # 1,562.5
ENGINE = ladder.Route(path="xla")


def _same_bits(a, b):
    """Equal bit for bit (a collapsed case's NaN equals itself)."""
    return torch.equal(a.view(torch.int64), b.view(torch.int64))


def _fake_units(monkeypatch, **kw):
    rec = dict(ds_unit=2e-15, ds_cert_unit=1.25e-14, ts_parity_unit=7e-16,
               beyond_parity_floor=1e-8, kernel_max_floor=1e-3)
    rec.update(kw)
    jrec = jcal.DeviceCalibration(**rec, certified=True, source="measured")
    prec = interop.calibration_from_fields(dataclasses.asdict(jrec), f64_from="ds")
    monkeypatch.setattr(jprobe, "_units", lambda: jrec)
    monkeypatch.setattr(condprobe, "_units", lambda: prec)
    return jrec, prec


def _fake_keys(monkeypatch, est):
    """Both packages read these keys instead of computing them."""
    est = np.asarray(est, np.float64)
    monkeypatch.setattr(jprobe, "cond_key", lambda *a, **k: jnp.asarray(est))

    def group(xk, *a, emit_cond=False, **k):
        assert emit_cond
        B = xk.shape[0]
        return (xk.new_zeros((B, 15)), torch.zeros(B, dtype=torch.int32), None,
                torch.as_tensor(est))

    monkeypatch.setattr(api, "_run_kernel_group", group)


def _geometry(rng, B, K=30):
    xk = rng.uniform(-1, 1, (B, K, 2))
    return xk, np.full((B,), K, np.int32), np.zeros((B, 2))


def _port_route(xk, nk, xi, base=ENGINE, *, assembly="moments", certified=False,
                basic=True):
    t = [torch.as_tensor(a) for a in (xk, nk, xi)]
    return api._maybe_split_route(base, *t, dim=2, o=4, kn=0, wm=defs.WEIGHT_CENTER,
                                  assembly=assembly, certified=certified, basic=basic)


def _jax_route(xk, nk, xi):
    base = jladder.Route(path="kernel", kernel_precision="ts", refine_steps=3)
    out = japi._maybe_split_route(base, xk, nk, xi, dim=2, K=xk.shape[1], o=4, kn=0,
                                  wm=defs.WEIGHT_CENTER, basic=True)
    return interop.route_from_fields(dataclasses.asdict(out)), out is base


# -- the decision -------------------------------------------------------------------

def test_maybe_split_route_upgrades_to_the_split(monkeypatch, rng):
    """95% of the keys under the edge: a split with the measured tail times
    the margin; the JAX package decides the same on the same keys (its window
    adds one tile of slack, its glue guard is set aside as its own test does)."""
    _fake_units(monkeypatch, est_ds_cert_unit_m=KEY_UNIT)
    monkeypatch.setattr(jladder, "SPLIT_GLUE_TS_UNITS", 0.0)
    B = 8192
    xk, nk, xi = _geometry(rng, B)
    _fake_keys(monkeypatch, np.where(np.arange(B) % 20 == 0, 10 * EDGE, 0.5 * EDGE))
    r = _port_route(xk, nk, xi)
    assert (r.path, r.assembly, r.kernel_precision) == ("kernel-split", "moments", "f64")
    assert r.split_edge == pytest.approx(EDGE)
    tail = float((np.arange(B) % 20 == 0).mean())              # 410 of 8,192
    assert r.tail_frac == pytest.approx(tail * ladder.TAIL_MARGIN)
    assert r.refine_steps == fit_kernel.DEFAULT_REFINE_STEPS
    assert r.tail_refine_steps is None and r.mixed_steps is None
    jr, unchanged = _jax_route(xk, nk, xi)
    assert not unchanged
    assert (jr.path, jr.assembly, jr.split_edge) == (r.path, r.assembly, r.split_edge)
    assert jr.tail_frac == pytest.approx(r.tail_frac + pallas_fit.TILE / B)
    # the rows body splits on its own key unit (a JAX record has one for both)
    rows = _port_route(xk, nk, xi, assembly="rows")
    assert (rows.path, rows.assembly, rows.split_edge) == ("kernel-split", "rows", r.split_edge)


def test_maybe_split_route_passes_through(monkeypatch, rng):
    """A route the sample certified, a batch with sens or ALGO_ITERATIVE, a
    configuration no kernel covers and a record without key units are left
    as they are, and no key is computed for them."""
    _fake_units(monkeypatch, est_ds_cert_unit_m=KEY_UNIT)
    xk, nk, xi = _geometry(rng, 64)

    def boom(*a, **k):
        raise AssertionError("the key was computed")

    monkeypatch.setattr(api, "_run_kernel_group", boom)
    kernel = ladder.Route(path="kernel", refine_steps=1)
    assert _port_route(xk, nk, xi, kernel, certified=True) is kernel
    assert _port_route(xk, nk, xi, basic=False) is ENGINE
    assert _port_route(xk, nk, xi, assembly=None) is ENGINE
    _fake_units(monkeypatch)                                   # no key unit
    assert _port_route(xk, nk, xi) is ENGINE
    _, prec = _fake_units(monkeypatch, est_ds_cert_unit_m=KEY_UNIT)
    off = dataclasses.replace(prec, certified=False)           # uncertified record
    monkeypatch.setattr(condprobe, "_units", lambda: off)
    assert _port_route(xk, nk, xi) is ENGINE


def test_whole_batch_rungs_upgrade_by_exact_max_key(monkeypatch, rng):
    """When the exact key maximum certifies a body, the whole batch goes to
    that kernel — no split, no tail; the moment body first."""
    _, prec = _fake_units(monkeypatch, est_ds_cert_unit_m=KEY_UNIT)
    rec = dataclasses.replace(prec, est_f64_cert_unit=KEY_UNIT / 4)   # rows reach 4x further
    monkeypatch.setattr(condprobe, "_units", lambda: rec)
    xk, nk, xi = _geometry(rng, 64)

    def with_max(mx, **kw):
        _fake_keys(monkeypatch, np.linspace(0.1 * mx, mx, 64))
        return _port_route(xk, nk, xi, **kw)

    r = with_max(0.9 * EDGE)
    assert (r.path, r.assembly, r.kernel_precision) == ("kernel", "moments", "f64")
    assert r.split_edge is None and r.tail_frac == 0.0
    jr, _ = _jax_route(xk, nk, xi)                 # the JAX rung 1, on the same keys
    assert (jr.path, jr.assembly) == (r.path, r.assembly)
    r = with_max(2 * EDGE)
    assert (r.path, r.assembly) == ("kernel", "rows")
    assert with_max(2 * EDGE, assembly="rows").assembly == "rows"
    assert with_max(0.9 * EDGE, assembly="rows").assembly == "rows"
    r = with_max(8 * EDGE)                         # beyond both: only 1/8 under the edge
    assert r is ENGINE


def test_whole_batch_rungs_poisoned_by_nan_key(monkeypatch, rng):
    """A single degenerate (NaN- or inf-keyed) case disables the whole-batch
    rung — it certifies nothing — and goes to the split's tail."""
    _fake_units(monkeypatch, est_ds_cert_unit_m=KEY_UNIT)
    xk, nk, xi = _geometry(rng, 64)
    for poison in (np.nan, np.inf):
        est = np.full(64, 10.0)
        est[3] = poison
        _fake_keys(monkeypatch, est)
        r = _port_route(xk, nk, xi)
        assert r.path == "kernel-split"
        assert r.tail_frac == pytest.approx(ladder.TAIL_MARGIN / 64)
    jr, unchanged = _jax_route(xk, nk, xi)
    assert unchanged                               # the JAX whole-batch rungs refuse too


def test_maybe_split_route_needs_majority(monkeypatch, rng):
    _fake_units(monkeypatch, est_ds_cert_unit_m=KEY_UNIT)
    xk, nk, xi = _geometry(rng, 64)
    for share, split in ((0.0, False), (0.4, False), (0.5, True), (0.75, True)):
        est = np.where(np.arange(64) < share * 64, 0.5 * EDGE, 10 * EDGE)
        _fake_keys(monkeypatch, est)
        r = _port_route(xk, nk, xi)
        assert (r.path == "kernel-split") == split, share
        if not split:
            assert r is ENGINE
            assert _jax_route(xk, nk, xi)[1]
    assert ladder.SPLIT_MIN_FRAC == 0.5


# -- the executions -----------------------------------------------------------------

def _straddling(rng, B, K=30, dim=2):
    """Radii log-uniform in [0.1, 1]: order-4 keys on both sides of the edge."""
    xi = rng.uniform(-1, 1, (B, dim))
    r = np.exp(rng.uniform(np.log(0.1), np.log(1.0), B))
    xk = xi[:, None, :] + r[:, None, None] * rng.uniform(-1, 1, (B, K, dim))
    fk = np.sin(3 * xk[..., 0]) * np.cos(2 * xk[..., -1]) + 0.3 * xk[..., 0] * xk[..., -1]
    return [torch.as_tensor(a) for a in (xk, fk, np.full(B, K, np.int32), xi)]


def test_first_over_edge_is_a_static_compaction():
    g = torch.Generator().manual_seed(1)
    est = torch.rand(1000, generator=g, dtype=torch.float64) * 100
    est[[5, 77, 500]] = torch.nan
    est[[6, 999]] = torch.inf
    bad = (~(est <= 60.0)).nonzero().squeeze(1)
    assert {5, 6, 77, 500, 999} <= set(bad.tolist())
    for k in (1, 7, len(bad), len(bad) + 50, 1000):
        idx = api._first_over_edge(est, 60.0, k)
        assert idx.shape == (k,) and idx.dtype == torch.int64
        n = min(k, len(bad))
        assert torch.equal(idx[:n], bad[:n])                  # the first k, in order
        assert bool((idx[n:] == 1000).all())                  # fills: B
    assert bool((api._first_over_edge(torch.zeros(8, dtype=torch.float64), 1.0, 3) == 8).all())


@pytest.mark.parametrize("assembly,knowns", [("moments", 0), ("rows", 0),
                                             ("rows", int(defs.b2_F | defs.b2_XY))])
def test_run_kernel_split_composition(rng, assembly, knowns):
    """The planned split equals its composition: the kernel's result with the
    first k over-edge cases overwritten by the engine's — bit-identical;
    cases past the window stay on the kernel's result; NaN keys go first."""
    B = 512
    xk, fk, nk, xi = _straddling(rng, B)
    xk[7] = xi[7]                                  # collapsed: a huge key
    fi0 = torch.as_tensor(rng.standard_normal((B, 15)))
    kw = dict(dim=2, order=4, knowns=knowns, weighting=defs.WEIGHT_CENTER)
    fi_k, _, _, est = api._run_kernel_group(xk, fk, nk, xi, fi0, assembly=assembly,
                                            refine_steps=1, emit_cond=True, **kw)
    edge = float(est[torch.isfinite(est)].median())
    bad = (~(est <= edge)).nonzero().squeeze(1)
    assert 7 in bad.tolist() and 0.3 * B < len(bad) < 0.7 * B
    for tail_frac in (1.0, 0.25):                  # a window that holds the tail, one that does not
        route = ladder.Route(path="kernel-split", assembly=assembly, refine_steps=1,
                             split_edge=edge, tail_frac=tail_frac)
        fi_s, iters, sens = api._run_kernel_split(xk, fk, nk, xi, fi0, route=route, **kw)
        k = int(np.ceil(tail_frac * B))
        tail = bad[:k]
        exp = fi_k.clone()
        exp[tail] = api._engine_group(xk[tail], fk[tail], nk[tail], xi[tail], fi0[tail], **kw)
        assert _same_bits(fi_s, exp)
        assert sens is None and int(iters.max()) == 0
        assert (len(bad) > k) == (tail_frac == 0.25)
        if len(bad) > k:                           # overflow left on the kernel's result
            assert torch.equal(fi_s[bad[k:]], fi_k[bad[k:]])
    if knowns:
        KN = fit_rows.known_dofs(knowns, 2, 4)
        assert torch.equal(fi_s[:, KN], fi0[:, KN])


def test_eager_split_resolves_exactly_the_over_edge_cases(rng):
    B = 384
    xk, fk, nk, xi = _straddling(rng, B)
    kw = dict(dim=2, order=4, knowns=0, weighting=defs.WEIGHT_CENTER)
    fi_k, key = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=4,
                                      weighting=defs.WEIGHT_CENTER, emit_cond=True)
    edge = float(key.median())
    fi, iters, sens = api._eager_split_group(xk, fk, nk, xi, None, assembly="moments",
                                             edge=edge, **kw)
    over = ~(key <= edge)
    assert 0 < int(over.sum()) < B
    assert torch.equal(fi[~over], fi_k[~over])
    assert torch.equal(fi[over], api._engine_group(xk[over], fk[over], nk[over], xi[over],
                                                   None, **kw))
    assert sens is None and int(iters.max()) == 0
    # nothing over the edge: the kernel's result, untouched
    fi_all, _, _ = api._eager_split_group(xk, fk, nk, xi, None, assembly="moments",
                                          edge=float("inf"), **kw)
    assert torch.equal(fi_all, fi_k)


def test_split_plan_replays_through_fit_many(monkeypatch, rng):
    """plan_fit_many on a batch whose keys straddle a faked edge gives a
    "kernel-split" plan; fit_many(plan=) replays it (the basic algorithm only)
    and embeds the result in the caller's column layout."""
    B = 512
    xk, fk, nk, xi = _straddling(rng, B)
    key = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=4,
                                weighting=defs.WEIGHT_CENTER, emit_cond=True)[1]
    edge = float(torch.quantile(key, 0.7))
    unit = 1e-10 / (4 * edge)
    cal = calibration.DeviceCalibration(
        f64_unit=unit, f64_cert_unit=unit, f64_unit_m=unit, f64_cert_unit_m=unit,
        est_f64_cert_unit=unit, est_f64_cert_unit_m=unit, source="measured")
    monkeypatch.setattr(condprobe, "_units", lambda: cal)
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER)
    plan = wtt.plan_fit_many(xk, xi, device=CPU, **kw)
    r = plan.route
    assert (r.path, r.assembly) == ("kernel-split", "moments")
    assert r.split_edge == pytest.approx(edge)
    frac = float((key <= edge).double().mean())
    assert r.tail_frac == pytest.approx((1 - frac) * ladder.TAIL_MARGIN)
    res = wtt.fit_many(xk, fk, xi, plan=plan, max_order=4, device=CPU, **kw)
    fi_s, _, _ = api._run_kernel_split(xk, fk, nk, xi, None, dim=2, order=4, knowns=0,
                                       weighting=defs.WEIGHT_CENTER, route=r)
    assert torch.equal(res.fi, fi_s)
    assert res.sens is None and bool(torch.isnan(res.cond_scaled).all())
    for extra in (dict(do_sens=True), dict(iterative=True)):
        with pytest.raises(ValueError, match="basic algorithm only"):
            wtt.fit_many(xk, fk, xi, plan=plan, device=CPU, **extra, **kw)
    # a pinned sweep count keeps the batch-level route: no split
    pinned = wtt.plan_fit_many(xk, xi, refine_steps=2, device=CPU, **kw)
    assert pinned.route.path != "kernel-split"
    # sens and ALGO_ITERATIVE are planned without the split
    assert wtt.plan_fit_many(xk, xi, do_sens=True, device=CPU,
                             **kw).route.path != "kernel-split"
