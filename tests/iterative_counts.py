"""ALGO_ITERATIVE counts of the JAX f64 engine on seeded clouds.

The reference for the rows kernel's iteration counts on the card.  The
clouds are made with NumPy from fixed seeds (:func:`clouds`), one for each
configuration of the rows grid (``tests/test_torch_cuda.py``,
``test_rows_kernel_matches_plain``: dims 1-3, orders 0-4, both weightings,
2,048 cases) and of the warp body's configurations
(``test_warp_body_matches_plain``: K = 53, 56, 130, 1,024 cases), at those
tests' sizes: ragged nk >= 1.5 NO (2 NO in 1D) with NaN in the padded slots,
a random knowns mask and random initial DOFs, ``max_iter`` 3.  The counts of
``wlsqm_tpu.fitter.engine.fit_batch(precision="f64", iterative=True)`` on
them are stored in ``iterative_counts_jax.npz`` (int8 per case, a key per
configuration); the card test and ``chip_smoke.phase_iterative_counts``
rebuild the same clouds and hold the kernel's and the plain version's
counts against them.  This module imports NumPy only at import time (the
card has no JAX); :func:`generate` imports JAX.

Regenerate (CPU, about a minute):

    python tests/iterative_counts.py
"""

from __future__ import annotations

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iterative_counts_jax.npz")
MAX_ITER = 3
K_BY_DIM = {1: 16, 2: 30, 3: 56}
GRID_B = 2048
WARP_B = 1024
WARP_K = (53, 56, 130)
WARP_CONFIGS = ((2, 4), (3, 3), (3, 4))   # fit_rows.warp_body: NO >= 11
_DOFS = {1: [1, 2, 3, 4, 5], 2: [1, 3, 6, 10, 15], 3: [1, 4, 10, 20, 35]}


def configs():
    """(key, dim, order, weighting, B, K, seed) of every configuration."""
    out = []
    for dim in (1, 2, 3):
        for order in range(5):
            for w in (1, 2):
                out.append(("grid_d%d_o%d_w%d" % (dim, order, w), dim, order, w, GRID_B,
                            K_BY_DIM[dim], 1000 * dim + 10 * order + w))
    for K in WARP_K:
        for dim, order in WARP_CONFIGS:
            for w in (1, 2):
                out.append(("warp_K%d_d%d_o%d_w%d" % (K, dim, order, w), dim, order, w,
                            WARP_B, K, 7 * K + 100 * dim + 10 * order + w))
    return out


def cloud(dim, order, B, K, seed):
    """xk (B, K, dim), fk (B, K), nk (B,) int32, xi (B, dim), fi0 (B, NO),
    knowns: the bench-like cloud of the card tests, made with NumPy."""
    rng = np.random.default_rng(seed)
    NO = _DOFS[dim][order]
    xi = (rng.uniform(size=(B, dim)) - 0.5) * 0.2
    xk = rng.uniform(-1.0, 1.0, (B, K, dim)) + xi[:, None, :]
    fk = np.sin(3 * xk[..., 0]) * np.cos(2 * xk[..., -1])
    lo = min(2 * NO if dim == 1 else (3 * NO) // 2, K)
    nk = rng.integers(lo, K + 1, B).astype(np.int32)
    nk[::2] = K
    pad = np.arange(K)[None, :] >= nk[:, None]
    xk[pad] = np.nan
    fk[pad] = np.nan
    fi0 = rng.standard_normal((B, NO))
    knowns = int(rng.integers(0, 1 << NO))
    return xk, fk, nk, xi, fi0, knowns


def clouds():
    """Every configuration: key -> (dim, order, weighting, cloud(...))."""
    return {key: (dim, order, w, cloud(dim, order, B, K, seed))
            for key, dim, order, w, B, K, seed in configs()}


def jax_counts(dim, order, weighting, xk, fk, nk, xi, fi0, knowns):
    """The JAX f64 engine's ALGO_ITERATIVE counts on one cloud."""
    import jax.numpy as jnp

    from wlsqm_tpu.fitter import engine

    B, NO = fi0.shape
    _, _, iters, _ = engine.fit_batch(
        jnp.asarray(xk), jnp.asarray(fk), jnp.asarray(nk), jnp.asarray(xi),
        jnp.asarray(fi0), jnp.full((B,), order, jnp.int32),
        jnp.full((B,), knowns, jnp.int64), jnp.full((B,), weighting, jnp.int32),
        dimension=dim, NO=NO, iterative=True, max_iter=MAX_ITER, precision="f64")
    return np.asarray(iters).astype(np.int8)


def generate(keys=None):
    """key -> counts, for ``keys`` (default: every configuration)."""
    out = {}
    for key, dim, order, w, B, K, seed in configs():
        if keys is None or key in keys:
            out[key] = jax_counts(dim, order, w, *cloud(dim, order, B, K, seed))
    return out


def load():
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


def shares(got, ref):
    """(equal, within one, histogram distance) of pooled counts against the
    reference: the histogram distance is sum |bincount difference| / 2 over
    the cases."""
    got, ref = np.concatenate(got), np.concatenate(ref)
    hist = np.abs(np.bincount(got, minlength=MAX_ITER + 1)
                  - np.bincount(ref, minlength=MAX_ITER + 1)).sum() / 2
    return (float((got == ref).mean()), float((np.abs(got - ref) <= 1).mean()),
            float(hist / len(ref)))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(PATH, **generate())
    print("wrote", PATH, os.path.getsize(PATH), "bytes")
