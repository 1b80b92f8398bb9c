"""Neighbourhood construction: k-nearest and radius queries.

Port of :mod:`wlsqm_tpu.utils.neighbors`, with two interchangeable
backends for :func:`knn`:

* ``backend="device"`` (the JAX package's ``"tpu"`` is a synonym) —
  brute-force blocked distances and ``torch.topk`` on the device (the card
  unless ``device="cpu"``).  Keeps the data on the device; the cost is
  O(M·N) per query set.
* ``backend="host"`` — a k-d tree on all host cores (:func:`host_tree`):
  the package's native C++ tree (:class:`wlsqm_tpu_torch.native.KDTree`)
  where g++ is present, scipy's ``cKDTree`` otherwise.  Better for large
  clouds queried once (an IBVP cloud's setup).
"""

from __future__ import annotations

import numpy as np
import torch

from wlsqm_tpu_torch import config, native

__all__ = ["knn", "radius_neighbors", "build_neighborhoods", "host_tree"]

_BACKENDS = {"device": "device", "tpu": "device", "host": "host"}


def host_tree(points):
    """The best host k-d tree over ``points``: the native C++ tree, or
    scipy's ``cKDTree`` where there is no g++.  Both expose ``query(x, k)``
    and ``query_ball_point(x, r)``."""
    if native.available():
        return native.KDTree(np.asarray(points))
    import scipy.spatial

    return scipy.spatial.cKDTree(np.asarray(points))


def _knn_block(points, queries, k: int):
    """Brute-force k-NN of a query block: (N, dim) cloud, (M, dim) queries
    -> (M, k) indices and exact squared distances.

    The ranking uses the expansion |q - p|² = |q|² - 2 q·p + |p|² in
    float32, as the JAX package does; ties within float32 rounding may pick
    either neighbour.  The chosen k distances are then recomputed exactly in
    the input dtype.
    """
    p32 = points.to(torch.float32)
    q32 = queries.to(torch.float32)
    p2 = torch.sum(p32 * p32, dim=-1)
    q2 = torch.sum(q32 * q32, dim=-1)
    d2 = q2[:, None] - 2.0 * (q32 @ p32.T) + p2[None, :]
    idx = torch.topk(d2, k, dim=1, largest=False, sorted=True).indices
    diff = queries[:, None, :] - points[idx]
    return idx, torch.sum(diff * diff, dim=-1)


def knn(points, queries, k: int, backend: str = "device", block: int = 65536,
        device=None):
    """k nearest neighbours of each query point.

    Returns (indices (M, k) int64, squared distances (M, k) float64): NumPy
    arrays from the host backend, tensors on ``device`` from the device
    backend.  The device backend handles queries in blocks of at most
    ``block``, bounded so that the (block, N) float32 distance matrix stays
    near 1 GB.
    """
    if backend not in _BACKENDS:
        raise ValueError("backend must be one of %s; got %r" % (sorted(_BACKENDS), backend))
    if _BACKENDS[backend] == "host":
        d, idx = host_tree(points).query(np.asarray(queries), k=k, workers=-1)
        if k == 1:
            d = d[:, None]
            idx = idx[:, None]
        return idx.astype(np.int64), d * d

    device = config.resolve_device(device, points, queries)
    points = config.as_tensor(points, device)
    queries = config.as_tensor(queries, device)
    n = points.shape[0]
    block = max(256, min(block, int(2.5e8 // max(n, 1))))
    outs_i, outs_d = [], []
    for s in range(0, queries.shape[0], block):
        idx, d2 = _knn_block(points, queries[s:s + block], k)
        outs_i.append(idx)
        outs_d.append(d2)
    return torch.cat(outs_i, dim=0), torch.cat(outs_d, dim=0)


def radius_neighbors(points, queries, r: float, backend: str = "host"):
    """Indices of cloud points within radius r of each query (ragged).

    Returns a list of index arrays (host-side ragged structure; for the
    padded device representation use :func:`build_neighborhoods`).
    """
    return host_tree(points).query_ball_point(np.asarray(queries), r)


def build_neighborhoods(points, values, centers, k: int, backend: str = "device",
                        exclude_self: bool = False, device=None):
    """Assemble padded (xk, fk, nk) fit inputs from a global cloud.

    points  : (N, dim) cloud coordinates
    values  : (N,) data at the cloud points
    centers : (M, dim) fit origins
    k       : neighbours per fit

    Returns (xk (M, k, dim), fk (M, k), nk (M,)) tensors on ``device``, ready
    for :func:`wlsqm_tpu_torch.fit_many`.  With ``exclude_self`` the nearest
    neighbour (assumed to be the centre itself when centers ⊆ points) is
    dropped.
    """
    device = config.resolve_device(device, points, values, centers)
    kq = k + 1 if exclude_self else k
    idx, _ = knn(points, centers, kq, backend=backend, device=device)
    idx = config.as_tensor(idx, device, torch.int64)
    if exclude_self:
        idx = idx[:, 1:]
    xk = config.as_tensor(points, device)[idx]
    fk = config.as_tensor(values, device)[idx]
    nk = torch.full((idx.shape[0],), k, dtype=torch.int32, device=device)
    return xk, fk, nk
