"""The port's native k-d tree, built here with g++, against scipy's cKDTree
and the JAX package's native tree (the same source), and
``neighbors.host_tree`` preferring it."""

import os

import numpy as np
import pytest
import scipy.spatial

from wlsqm_tpu import native as jnative
from wlsqm_tpu_torch import native
from wlsqm_tpu_torch.utils import neighbors


@pytest.fixture(scope="module")
def tree_lib():
    if not native.available():
        pytest.skip("no g++ on this host")
    return native.load()


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_knn_matches_scipy_and_the_jax_tree(tree_lib, dim):
    rng = np.random.default_rng(40 + dim)
    pts = rng.uniform(-1, 1, (3000, dim))
    q = rng.uniform(-1, 1, (400, dim))
    d, idx = native.KDTree(pts).query(q, k=9)
    ds, idxs = scipy.spatial.cKDTree(pts).query(q, k=9)
    np.testing.assert_array_equal(idx, idxs)
    np.testing.assert_allclose(d, ds, rtol=1e-15, atol=0)
    if jnative.available():
        dj, idxj = jnative.KDTree(pts).query(q, k=9)
        np.testing.assert_array_equal(idx, idxj)
        np.testing.assert_array_equal(d, dj)
    d1, i1 = native.KDTree(pts, nthreads=1).query(q[0], k=1)
    assert i1.shape == (1,) and i1[0] == idxs[0, 0]


def test_radius_matches_scipy(tree_lib):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (2000, 2))
    q = rng.uniform(-1, 1, (50, 2))
    got = native.KDTree(pts).query_ball_point(q, 0.1)
    want = scipy.spatial.cKDTree(pts).query_ball_point(q, 0.1)
    assert got == [sorted(w) for w in want]
    assert native.KDTree(pts).query_ball_point(q[0], 0.1) == sorted(want[0])


def test_build_lands_in_the_build_tree_keyed_by_host(tree_lib):
    """Built with g++ under build/wlsqm_tpu_torch/, not beside the source,
    and keyed by what -march=native means on this host."""
    assert tree_lib.path.startswith(native.BUILD_ROOT + os.sep)
    assert os.path.basename(os.path.dirname(tree_lib.path)).startswith("kdtree-")
    assert not os.path.exists(os.path.join(native.HERE, "_kdtree.so"))
    assert "march" in native._march_native("g++") or native._march_native("g++") == ""


def test_host_tree_prefers_the_native_tree(tree_lib, monkeypatch):
    rng = np.random.default_rng(9)
    pts = rng.uniform(-1, 1, (500, 2))
    assert isinstance(neighbors.host_tree(pts), native.KDTree)
    idx, d2 = neighbors.knn(pts, pts[:20], 5, backend="host")
    _, want = scipy.spatial.cKDTree(pts).query(pts[:20], k=5)
    np.testing.assert_array_equal(idx, want)
    monkeypatch.setattr(native, "available", lambda: False)
    assert isinstance(neighbors.host_tree(pts), scipy.spatial.cKDTree)
