"""Per-device calibration of the kernel-routing accuracy model.

Port of :mod:`wlsqm_tpu.fitter.calibration`.  The auto ladder's
*certification* gates (:mod:`wlsqm_tpu_torch.fitter.condprobe`,
:mod:`wlsqm_tpu_torch.fitter.ladder`) promise that a kernel-routed case
agrees with any correct f64 fit to the 1e-10 parity bar.  That promise rests
on unit-roundoff constants measured on the device: another generation of
card, or another compiler's order of operations, can behave differently, and
a gate tuned on one device could silently admit >1e-10 errors on another.  The TPU
package keeps three arithmetics (f32 pairs and triples); the H100 computes
in FP64, so a record here has one arithmetic and two kernel bodies:

* **shipped** records for the device kinds swept on real hardware (the
  H100; the CPU, where the kernels' plain torch versions run in the same
  FP64 and only the logic tests route);
* **measured** records produced by :func:`calibrate_device` — a harness
  that sweeps the actual kernels against a long-double-refined oracle on
  THIS device and persists the fitted units in the package's build
  directory;
* an **env override** (``WLSQM_TPU_CALIBRATION=/path/to.json``) for
  site-managed fleets.

On hardware with no record of any kind, :func:`active` returns the shipped
units flagged ``certified=False``: the condprobe certification gates then
refuse, so auto routing takes the uncertified or engine rungs (which make no
cross-device accuracy claims), and a one-time warning tells the user to run
``python -m wlsqm_tpu_torch.fitter.calibration``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings

import numpy as np
import torch

from wlsqm_tpu_torch import config, native
from wlsqm_tpu_torch.fitter import defs, tables

__all__ = ["DeviceCalibration", "active", "calibrate_device", "device_kind"]

#: bump when the calibration methodology changes; persisted records from an
#: older harness must not be trusted.  The certification units are
#: EDGE-ANCHORED (unit = tol / (SAFETY * edge) with the edge placed where the
#: measured worst-err envelope still has CERT_HEADROOM to the bar), as in
#: the JAX package's version 3; version 4 adds the data-scale key units.
VERSION = 4

#: predicted floor above which 1e-10 parity is unattainable for any f64
#: normal-equation solve, and the one beyond which the geometry counts as
#: degenerate: regime thresholds of the ladder, decades of the predicted
#: error, not measurements
BEYOND_PARITY_FLOOR = 1e-8
KERNEL_MAX_FLOOR = 1e-3


@dataclasses.dataclass(frozen=True)
class DeviceCalibration:
    """Accuracy-model units of the FP64 kernels for one device kind.

    The plain units describe the basis-ROWS kernel; the ``*_m`` variants the
    MOMENT-assembly kernel.  ``f64_unit`` is the central model unit (the
    worst batch-max ratio err / (cond·amp); regime splits);
    ``f64_cert_unit`` the per-case worst-case envelope against the sampled
    probe's ``cond·amp`` (the certification gate); ``est_f64_cert_unit`` the
    envelope against the KERNEL-EMITTED per-case key (``emit_cond=True``):
    err <= unit * key, the split route's gate; None disables the split on
    that body.  The ladder certifies each body against ITS units.

    Those units are fitted on one field family (:func:`_problem`), whose
    order-4 DOFs are ~50x its values, with the error relative to max |fi|;
    an f64 fit's error follows the DATA, so on a field whose DOFs are of the
    size of its values the same key means up to ~90x the relative error.
    ``data_unit`` / ``data_unit_m`` are the data-scale envelopes of the two
    bodies: err / max(|fi|, 1) <= unit * key * max|fk| / max(|fi|, 1), fitted
    over every field of :data:`DATA_FIELDS`; the data gate
    (:func:`wlsqm_tpu_torch.fitter.condprobe.data_edges`) reads them.  None
    disables that gate on that body.

    ``certified`` distinguishes a record backed by a hardware sweep (shipped
    or measured) from the fallback defaults: only certified records allow
    the certification gates to pass.
    """

    f64_unit: float
    f64_cert_unit: float
    f64_unit_m: float
    f64_cert_unit_m: float
    est_f64_cert_unit: float | None = None
    est_f64_cert_unit_m: float | None = None
    data_unit: float | None = None
    data_unit_m: float | None = None
    beyond_parity_floor: float = BEYOND_PARITY_FLOOR
    kernel_max_floor: float = KERNEL_MAX_FLOOR
    certified: bool = True
    source: str = "shipped"   # "shipped" | "measured" | "env" | "default"

    def units_for(self, assembly: str):
        """(central, envelope) for one kernel assembly."""
        if assembly == "moments":
            return self.f64_unit_m, self.f64_cert_unit_m
        return self.f64_unit, self.f64_cert_unit


#: the H100 sweep: ``calibrate_device()`` (7 radii x 2 weightings x 1,024
#: cases, 2D order 4, K = 30, both kernels at their default sweep count) as
#: ``chip_smoke.phase_calibrate`` ran it on an NVIDIA H100 80GB HBM3,
#: 700.00 W, with the rows kernel's warp body (2D order 4 has NO = 15) and
#: the moment kernel's thread body with its factor partly in shared memory
#: (its units re-measured when that body replaced the register one).  Edges
#: tol / (SAFETY * unit): cond·amp 28,158 (rows) and 21,105 (moments); key
#: 52,731 (rows) and 35,192 (moments).  The data units come from the same
#: sweep over the three fields of :data:`DATA_FIELDS`: data edge 312 on
#: key * max|fk| / max(|fi|, 1) for both bodies.
_H100 = dict(f64_unit=8.03e-16, f64_cert_unit=8.88e-16, f64_unit_m=6.18e-16,
             f64_cert_unit_m=1.18e-15, est_f64_cert_unit=4.74e-16,
             est_f64_cert_unit_m=7.10e-16, data_unit=8.01e-14, data_unit_m=8.01e-14)

#: shipped records, matched by lower-case substring of the device kind
_SHIPPED: tuple[tuple[str, dict], ...] = (
    ("h100", _H100),
    # CPU: the kernels' plain torch versions compute the same FP64 sums
    # there; the record exists so that the gate and ladder LOGIC tests,
    # which run on CPU hosts, exercise the shipped behavior
    ("cpu", _H100),
)

_ACTIVE: dict[str, DeviceCalibration] = {}
_WARNED: set[str] = set()


def device_kind() -> str:
    """Identifier of the device the kernels run on: the card's name as
    ``torch.cuda.get_device_name`` gives it, or ``'cpu'`` without a card."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def _store_path() -> str:
    return os.path.join(native.BUILD_ROOT, "device_calibration.json")


def _key(kind: str) -> str:
    return f"v{VERSION}:{kind}"


def _from_record(rec: dict, source: str) -> DeviceCalibration | None:
    def opt(name):
        return None if rec.get(name) is None else float(rec[name])

    try:
        return DeviceCalibration(
            f64_unit=float(rec["f64_unit"]),
            f64_cert_unit=float(rec["f64_cert_unit"]),
            f64_unit_m=float(rec.get("f64_unit_m", rec["f64_unit"])),
            f64_cert_unit_m=float(rec.get("f64_cert_unit_m", rec["f64_cert_unit"])),
            est_f64_cert_unit=opt("est_f64_cert_unit"),
            est_f64_cert_unit_m=opt("est_f64_cert_unit_m"),
            data_unit=opt("data_unit"),
            data_unit_m=opt("data_unit_m"),
            beyond_parity_floor=float(rec.get("beyond_parity_floor",
                                              BEYOND_PARITY_FLOOR)),
            kernel_max_floor=float(rec.get("kernel_max_floor", KERNEL_MAX_FLOOR)),
            certified=bool(rec.get("certified", True)),
            source=source)
    except (KeyError, TypeError, ValueError):
        return None


def _load_store(path: str, kind: str, source: str):
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    rec = data.get(_key(kind)) if isinstance(data, dict) else None
    return _from_record(rec, source) if isinstance(rec, dict) else None


def _persist(kind: str, cal: DeviceCalibration) -> None:
    """Record a measured calibration (atomic replace, best-effort)."""
    path = _store_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        rec = dataclasses.asdict(cal)
        rec.pop("source", None)
        data[_key(kind)] = rec
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)
    except OSError:  # read-only directory: the in-process record stands
        pass


def active() -> DeviceCalibration:
    """The calibration record for the current device kind.

    Resolution order: env override file -> persisted measured record ->
    shipped table -> uncertified defaults (with a one-time warning).
    Cached per device kind for the process.
    """
    kind = device_kind()
    cal = _ACTIVE.get(kind)
    if cal is not None:
        return cal
    env = os.environ.get("WLSQM_TPU_CALIBRATION")
    if env:
        cal = _load_store(env, kind, "env")
    if cal is None:
        cal = _load_store(_store_path(), kind, "measured")
    if cal is None:
        for pat, rec in _SHIPPED:
            if pat in kind.lower():
                cal = DeviceCalibration(**rec, certified=True, source="shipped")
                break
    if cal is None:
        cal = DeviceCalibration(**_H100, certified=False, source="default")
        if kind not in _WARNED:
            _WARNED.add(kind)
            warnings.warn(
                f"no accuracy calibration for device kind {kind!r}: "
                "certified kernel routing is disabled (batches take the "
                "uncertified or engine rungs).  Run `python -m "
                "wlsqm_tpu_torch.fitter.calibration` once on this hardware "
                "(the record persists in the package's build directory) to "
                "enable it.",
                stacklevel=2)
    _ACTIVE[kind] = cal
    return cal


def _reset_cache() -> None:
    """Testing hook: drop the per-process record cache."""
    _ACTIVE.clear()


# ---------------------------------------------------------------- harness

def _calibration_field(x):
    """The sweep's field family (the JAX package's): sin 3x cos 2y + 0.3 x y."""
    return np.sin(3 * x[..., 0]) * np.cos(2 * x[..., -1]) + 0.3 * x[..., 0] * x[..., -1]


#: the fields of the data-scale sweep: the calibration family, a
#: low-frequency one (the regression gate's expert field, DOFs of the size of
#: the values) and a near-linear one (high-order DOFs zero); the data units
#: are the worst over all three
DATA_FIELDS = (
    _calibration_field,
    lambda x: np.sin(x[..., 0]) * np.cos(x[..., -1]),
    lambda x: 1.0 + 0.1 * x[..., 0],
)


def _problem(rng, B, K, radius, dimension, field=_calibration_field):
    xi = rng.uniform(-1, 1, (B, dimension))
    xk = xi[:, None, :] + rng.uniform(-radius, radius, (B, K, dimension))
    return xk, field(xk), xi


def data_ratio(fi, fk, nk):
    """Per-case data scale of the data gate: max |fk| over each case's
    ``nk`` neighbours over max(|fi|, 1).  Tensors (B, NO), (B, K), (B,)."""
    valid = torch.arange(fk.shape[1], device=fk.device)[None, :] < nk[:, None]
    fk_max = torch.where(valid, fk.abs(), 0.0).amax(1)
    return fk_max / fi.abs().amax(1).clamp_min(1.0)


def _strong_oracle(xk, xi, fk, weighting, dimension, order=4):
    """Radius-scaled f64 normal-equations solve + one long-double-residual
    refinement per case, in NumPy on the host."""
    no = defs.number_of_dofs(dimension, order)
    exp = tables.EXPONENTS[dimension][:no]
    invf = tables.INV_FACT[dimension][:no]
    deg = exp.sum(-1)
    d = xk - xi[:, None, :]
    d2 = (d ** 2).sum(-1)
    r = np.sqrt(d2.max(-1))
    t = d / r[:, None, None]
    C = invf[None, None, :] * np.prod(
        t[:, :, None, :] ** exp[None, None, :, :], axis=-1)
    if weighting == defs.WEIGHT_CENTER:
        w = 1e-4 + (1 - 1e-4) * (
            1 - np.sqrt(d2 / d2.max(-1, keepdims=True))) ** 2
    else:
        w = np.ones_like(d2)
    A = np.einsum("bki,bk,bkj->bij", C, w, C)
    b = np.einsum("bkj,bk->bj", C, w * fk)
    x = np.linalg.solve(A, b[..., None])[..., 0]
    Cl = C.astype(np.longdouble)
    wl = w.astype(np.longdouble)
    fl = fk.astype(np.longdouble)
    xl = x.astype(np.longdouble)
    resid = np.einsum("bkj,bk->bj", Cl,
                      wl * (fl - np.einsum("bkj,bj->bk", Cl, xl)))
    dx = np.linalg.solve(A, resid.astype(np.float64)[..., None])[..., 0]
    x = (xl + dx.astype(np.longdouble)).astype(np.float64)
    return x / (r[:, None].astype(np.float64) ** deg[None, :])


def _reduced_oracle(xk, xi, fk, fi0, KN, weighting, dimension, order=4):
    """:func:`_strong_oracle` for a fit whose DOFs ``KN`` are known: their
    part moved to the data side, the reduced system solved in the same
    radius-scaled coordinates (f64 normal equations, one long-double
    residual refinement); the known DOFs are fi0's."""
    no = defs.number_of_dofs(dimension, order)
    exp = tables.EXPONENTS[dimension][:no]
    invf = tables.INV_FACT[dimension][:no]
    deg = exp.sum(-1)
    UN = [j for j in range(no) if j not in KN]
    d = xk - xi[:, None, :]
    d2 = (d ** 2).sum(-1)
    r = np.sqrt(d2.max(-1))
    t = d / r[:, None, None]
    C = invf[None, None, :] * np.prod(t[:, :, None, :] ** exp[None, None, :, :], axis=-1)
    if weighting == defs.WEIGHT_CENTER:
        w = 1e-4 + (1 - 1e-4) * (1 - np.sqrt(d2 / d2.max(-1, keepdims=True))) ** 2
    else:
        w = np.ones_like(d2)
    g = fi0[:, KN] * r[:, None] ** deg[None, KN]
    fe = fk - np.einsum("bkj,bj->bk", C[..., KN], g)
    Cu = C[..., UN]
    A = np.einsum("bki,bk,bkj->bij", Cu, w, Cu)
    x = np.linalg.solve(A, np.einsum("bkj,bk->bj", Cu, w * fe)[..., None])[..., 0]
    Cl, wl, fl, xl = (a.astype(np.longdouble) for a in (Cu, w, fe, x))
    resid = np.einsum("bkj,bk->bj", Cl, wl * (fl - np.einsum("bkj,bj->bk", Cl, xl)))
    dx = np.linalg.solve(A, resid.astype(np.float64)[..., None])[..., 0]
    x = (xl + dx.astype(np.longdouble)).astype(np.float64)
    out = np.array(fi0[:, :no], dtype=np.float64)
    out[:, UN] = x / r[:, None] ** deg[None, UN]
    return out


def oracle_case_errors(fits, xk, fk, nk, xi, fi0, KN, weighting, dimension, order):
    """Per-case L∞ error of each fit in ``fits`` (tensors (B, NO)) against
    :func:`_reduced_oracle` (the strong oracle when ``KN`` is empty),
    relative to max(|ref|, 1): one case at a time on its own nk neighbours,
    on the host.  For a few hundred cases (those past a key edge), not a
    batch.  fi0 (B, >=NO) holds the known values (None without knowns)."""
    a = [t.detach().cpu().numpy() for t in (xk, fk, xi)]
    n = nk.cpu().numpy()
    g = (fi0.detach().cpu().numpy() if fi0 is not None
         else np.zeros((len(n), defs.number_of_dofs(dimension, order))))
    got = [f.detach().cpu().numpy() for f in fits]
    out = np.empty((len(fits), len(n)))
    for j in range(len(n)):
        s = slice(j, j + 1)
        ref = _reduced_oracle(a[0][s, :n[j]], a[2][s], a[1][s, :n[j]], g[s], list(KN),
                              weighting, dimension, order)[0]
        for i, f in enumerate(got):
            out[i, j] = np.abs(f[j] - ref).max() / max(np.abs(ref).max(), 1.0)
    return out


#: headroom the certified edge keeps to the parity bar: the edge is the
#: largest swept cond·amp (or key) whose running worst-err envelope stays
#: below tol / CERT_HEADROOM; it absorbs sweep-to-sweep scatter
CERT_HEADROOM = 5.0

#: margin for a worst measured per-case unit against under-prediction (the
#: JAX package's constant, kept for a record fitted by other means)
CERT_MARGIN = 1.6

#: floor for a fitted unit: a sweep can never certify tighter than the f64
#: oracle's own arithmetic
UNIT_FLOOR = 1e-16


def calibrate_device(*, batch: int = 1024, seed: int = 20260817,
                     radii=(0.03, 0.05, 0.1, 0.15, 0.3, 0.6, 1.0),
                     persist: bool = True, device=None,
                     refine_steps: int | None = None) -> DeviceCalibration:
    """Measure this device's kernel accuracy units and persist them.

    Runs both kernels (basis-rows AND moment assembly, each with its
    per-case key) on a 2D order-4 sweep over neighborhood radii and both
    weightings, compares every case against the long-double-refined oracle,
    and fits each body's certification units with the edge-anchored rule
    (see ``cert`` below) plus the central batch-max units that drive the
    regime splits.  The geometry units come from the first of
    :data:`DATA_FIELDS` (its draws are those of the JAX package's harness);
    the data-scale units from the same sweep over every one of them, each
    after the first on geometry drawn from its own seed.  Persists the record in the
    build directory and installs it for the process either way.
    ``device``: the card by default; ``refine_steps``: the kernels' default.
    """
    from wlsqm_tpu_torch.fitter import condprobe
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    device = config.resolve_device(device)
    K = 30
    cas = []
    ests = {"rows": [], "mom": []}
    errs = {"rows": [], "mom": []}
    # the data gate's quantities, over every field: err / max(|ref|, 1)
    # against key * max|fk| / max(|fi|, 1), both from the kernel's own fi
    data_errs = {"rows": [], "mom": []}
    data_keys = {"rows": [], "mom": []}
    rs = {} if refine_steps is None else dict(refine_steps=refine_steps)
    for f_i, field in enumerate(DATA_FIELDS):
        rng = np.random.default_rng(seed + f_i)
        for weighting in (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER):
            for radius in radii:
                xk, fk, xi = _problem(rng, batch, K, radius, 2, field)
                ref = _strong_oracle(xk, xi, fk, weighting, 2)
                scale = np.abs(ref).max(-1)
                xk_t, fk_t, xi_t = (config.as_tensor(a, device) for a in (xk, fk, xi))
                nk = torch.full((batch,), K, dtype=torch.int32, device=device)
                com = dict(dimension=2, order=4, weighting=weighting, emit_cond=True,
                           **rs)
                fi_r, _, _, est_r = fit_rows.fit_rows(xk_t, fk_t, nk, xi_t, **com)
                fi_m, est_m = fit_kernel.fit_kernel(xk_t, fk_t, nk, xi_t, **com)
                for key, fi, est in (("rows", fi_r, est_r), ("mom", fi_m, est_m)):
                    gate = np.asarray((est * data_ratio(fi, fk_t, nk)).cpu())
                    fi = np.asarray(fi.cpu())
                    err = np.abs(fi - ref).max(-1)
                    data_errs[key].append(err / np.maximum(scale, 1.0))
                    data_keys[key].append(gate)
                    if f_i == 0:
                        # the split-route envelopes calibrate against the
                        # KERNEL-emitted key — the exact value the runtime
                        # gate will compare against
                        errs[key].append(err / scale)
                        ests[key].append(np.asarray(est.cpu()))
                if f_i == 0:
                    cond, amp = condprobe.probe(xk_t, nk, xi_t, 4, weighting,
                                                dimension=2, sample=batch)
                    cas.append(cond * amp)
    ca = np.concatenate(cas)
    nbatch = len(cas)
    AUTO_TOL, SAFETY = condprobe.AUTO_TOL, condprobe.SAFETY

    def cert(key, x=ca, errs=errs):
        """Edge-anchored certification unit against ``x`` (cond·amp, the
        per-case key, or the data gate's key times the data scale).

        Find the largest swept x below which every measured error keeps
        :data:`CERT_HEADROOM` to the parity bar, then return the unit that
        places the gate ``unit * x * SAFETY <= tol`` exactly at that edge.
        Sound on the sweep by construction: every case the gate would
        certify has measured err <= tol / CERT_HEADROOM.  A NaN x (a
        degenerate case) sorts last and certifies nothing.
        """
        e = np.concatenate(errs[key])
        order_i = np.argsort(x)
        run = np.maximum.accumulate(e[order_i])
        ok = (run <= AUTO_TOL / CERT_HEADROOM) & np.isfinite(x[order_i])
        if not ok.any():
            return AUTO_TOL / SAFETY  # edge 1: certifies nothing real
        edge = float(x[order_i][ok][-1])
        return max(AUTO_TOL / (SAFETY * edge), UNIT_FLOOR)

    def central(key):
        # worst batch-max ratio (the SAFETY of the routing gate absorbs the
        # scatter around it)
        e = np.concatenate(errs[key])
        return max(max(float(b.max() / c.max())
                       for b, c in zip(np.array_split(e, nbatch),
                                       np.array_split(ca, nbatch))),
                   UNIT_FLOOR)

    cal = DeviceCalibration(
        f64_unit=central("rows"), f64_cert_unit=cert("rows"),
        f64_unit_m=central("mom"), f64_cert_unit_m=cert("mom"),
        est_f64_cert_unit=cert("rows", np.concatenate(ests["rows"])),
        est_f64_cert_unit_m=cert("mom", np.concatenate(ests["mom"])),
        data_unit=cert("rows", np.concatenate(data_keys["rows"]), data_errs),
        data_unit_m=cert("mom", np.concatenate(data_keys["mom"]), data_errs),
        certified=True, source="measured")
    kind = device_kind()
    _ACTIVE[kind] = cal
    if persist:
        _persist(kind, cal)
    return cal


def main() -> None:  # pragma: no cover - thin CLI
    cal = calibrate_device()
    print(f"device kind:  {device_kind()}")
    for f in dataclasses.fields(cal):
        print(f"{f.name:22s} {getattr(cal, f.name)}")
    print(f"persisted in {_store_path()}")


if __name__ == "__main__":  # pragma: no cover
    main()
