"""Seeded problem batches for the port's tests.

Inputs are made with NumPy so that the JAX package and the port see the
same numbers; padded neighbor slots hold NaN, which neither may read.
"""

import numpy as np

from wlsqm_tpu_torch.fitter import calibration, condprobe, defs


def roomy_units(monkeypatch):
    """Install a certified record whose units are so small that every
    finite-conditioned case certifies: routing is then by configuration alone
    (which kernel body covers it), the subject of the tests that ask for it."""
    cal = calibration.DeviceCalibration(
        f64_unit=1e-24, f64_cert_unit=1e-24, f64_unit_m=1e-24, f64_cert_unit_m=1e-24,
        est_f64_cert_unit=1e-24, est_f64_cert_unit_m=1e-24, source="measured")
    monkeypatch.setattr(condprobe, "_units", lambda: cal)
    return cal


def cloud(rng, B, K, dim, *, orders=(4,), weightings=(defs.WEIGHT_CENTER,),
          ragged=True, knowns=False, radius=(0.05, 1.0)):
    """A batch of B neighborhoods of K points in ``dim`` dimensions.

    Per-case order and weighting are drawn from ``orders``/``weightings``;
    the radius is log-uniform in ``radius``.  With ``ragged``, odd cases
    keep nk in [1.5 NO, K] neighbors (the JAX package's routing rule for a
    well-posed fit).  With ``knowns``, each active DOF is known with
    probability 0.2 and its value is taken from ``fi0``.
    """
    order = rng.choice(orders, B).astype(np.int32)
    weighting = rng.choice(weightings, B).astype(np.int32)
    no = np.array([defs.number_of_dofs(dim, int(o)) for o in order])
    xi = rng.uniform(-1, 1, (B, dim))
    r = np.exp(rng.uniform(np.log(radius[0]), np.log(radius[1]), B))
    xk = xi[:, None, :] + r[:, None, None] * rng.uniform(-1, 1, (B, K, dim))
    fk = (np.sin(1.3 * xk[..., 0]) * np.cos(0.7 * xk[..., -1])
          + 0.5 * xk[..., 0] * xk[..., -1] + 0.01 * rng.standard_normal((B, K)))
    nk = np.full(B, K, np.int32)
    if ragged:
        lo = np.minimum((3 * no) // 2, K)
        odd = np.arange(B) % 2 == 1
        nk[odd] = rng.integers(lo[odd], K + 1)
        pad = np.arange(K)[None, :] >= nk[:, None]
        xk[pad] = np.nan
        fk[pad] = np.nan
    kn = np.zeros(B, np.int64)
    if knowns:
        bits = (rng.uniform(size=(B, no.max())) < 0.2) & (np.arange(no.max()) < no[:, None])
        kn = (bits * (1 << np.arange(no.max()))).sum(axis=1).astype(np.int64)
    NO = defs.number_of_dofs(dim, max(orders))
    fi0 = rng.standard_normal((B, NO))
    return dict(xk=xk, fk=fk, nk=nk, xi=xi, order=order, knowns=kn,
                weighting=weighting, fi0=fi0, NO=NO)


def rel_err(got, ref):
    """Worst per-case L∞ error relative to max(|ref|, 1) over the case.

    Arrays are (B, ...); NaN must sit at the same places in both.
    """
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    nan = np.isnan(ref)
    assert (np.isnan(got) == nan).all(), "NaN pattern differs"
    got = np.where(nan, 0.0, got)
    ref = np.where(nan, 0.0, ref)
    scale = np.maximum(np.abs(ref).max(axis=1), 1.0)
    return float((np.abs(got - ref).max(axis=1) / scale).max())
