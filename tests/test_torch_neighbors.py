"""The port's neighbour search against the JAX package's.

Held to JAX's ``knn(backend="host")`` (its k-d tree, exact distances).
Neighbour indices are a choice among near-equal distances, so index sets
are compared only for queries whose k-th and (k+1)-th squared distances
are separated: by more than 1e-9 relative for the host backend (exact f64
distances), and by more than F32_GAP for the device backend, which ranks
with |q|² - 2 q·p + |p|² in float32 as the JAX package's does (on
[-1, 1]^dim its rounding stays under 4·dim·2^-24 ≈ 7e-7).  The distances
returned are always the exact f64 ones of the chosen points.
"""

import numpy as np
import pytest
import torch

from wlsqm_tpu.utils import neighbors as jneighbors
from wlsqm_tpu_torch.utils import neighbors

torch.set_num_threads(1)

F32_GAP = 1e-5


def _cloud(dim, seed, n=500, m=200):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, dim)), rng.uniform(-1, 1, (m, dim))


@pytest.mark.parametrize("backend", ["device", "tpu", "host"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_knn_matches_jax_host(dim, backend):
    pts, q = _cloud(dim, dim)
    k = 12
    ref_i, ref_d = (np.asarray(a) for a in jneighbors.knn(pts, q, k + 1, backend="host"))
    idx, d2 = neighbors.knn(pts, q, k, backend=backend, block=64, device="cpu")
    if backend != "host":
        assert isinstance(idx, torch.Tensor) and idx.device.type == "cpu"
        idx, d2 = idx.numpy(), d2.numpy()
    assert idx.shape == (len(q), k) and idx.dtype == np.int64
    np.testing.assert_allclose(d2, ((q[:, None, :] - pts[idx]) ** 2).sum(-1), rtol=1e-12)
    gap = ref_d[:, k] - ref_d[:, k - 1]
    if backend == "host":
        np.testing.assert_allclose(d2, ref_d[:, :k], rtol=1e-12, atol=1e-15)
        sep = gap > 1e-9 * ref_d[:, k]
    else:
        np.testing.assert_allclose(np.sort(d2, axis=1), ref_d[:, :k], rtol=0, atol=F32_GAP)
        sep = gap > F32_GAP
    assert sep.mean() > 0.8
    for a, b in zip(idx[sep], ref_i[sep, :k]):
        assert set(a.tolist()) == set(b.tolist())


def test_knn_k1_and_bad_backend():
    pts, q = _cloud(2, 9, n=500, m=50)
    i_h, d_h = neighbors.knn(pts, q, 1, backend="host")
    i_d, d_d = neighbors.knn(pts, q, 1, backend="device", device="cpu")
    assert i_h.shape == (50, 1) and d_h.shape == (50, 1)
    np.testing.assert_array_equal(i_h, i_d.numpy())
    np.testing.assert_allclose(d_h, d_d.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="backend"):
        neighbors.knn(pts, q, 3, backend="gpu")


@pytest.mark.parametrize("exclude_self", [False, True])
def test_build_neighborhoods_matches_jax(exclude_self):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (2000, 2))
    vals = np.sin(pts[:, 0]) * np.cos(pts[:, 1])
    xk, fk, nk = neighbors.build_neighborhoods(pts, vals, pts[:300], 10, backend="host",
                                               exclude_self=exclude_self, device="cpu")
    jxk, jfk, jnk = (np.asarray(a) for a in jneighbors.build_neighborhoods(
        pts, vals, pts[:300], 10, backend="host", exclude_self=exclude_self))
    np.testing.assert_array_equal(xk.numpy(), jxk)
    np.testing.assert_array_equal(fk.numpy(), jfk)
    np.testing.assert_array_equal(nk.numpy(), jnk)
    # the device backend: the same neighbourhoods up to float32 ranking ties
    xk_d, fk_d, _ = neighbors.build_neighborhoods(pts, vals, pts[:300], 10,
                                                  exclude_self=exclude_self, device="cpu")
    assert xk_d.shape == jxk.shape
    same = (np.sort(fk_d.numpy(), axis=1) == np.sort(jfk, axis=1)).all(axis=1)
    assert same.mean() > 0.95


@pytest.mark.parametrize("dim", [2, 3])
def test_radius_neighbors_matches_jax(dim):
    pts, q = _cloud(dim, 20 + dim, n=2000, m=100)
    got = neighbors.radius_neighbors(pts, q, 0.15)
    ref = jneighbors.radius_neighbors(pts, q, 0.15)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b)
