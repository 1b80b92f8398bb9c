"""Distributed WLSQM pipeline: cloud in, global model out.

Counterpart of the JAX package's ``examples/distributed_pipeline.py``, on
the port's sharding layer (:mod:`wlsqm_tpu_torch.parallel.sharding`).
There a mesh is a list of devices and a sharded array a list of per-device
tensors.  The original lays the case axis over a mesh of eight virtual CPU
devices with ``shard_map``; here the mesh is :data:`SHARDS` logical shards
of one device (``make_mesh(devices=[device] * SHARDS)``), each shard's work
queued on a CUDA stream of its own on the card.  The JAX package's
collectives become copies: the coordinate all-gather is each shard holding
the whole cloud, the psum of the blend a sum over the shards.

  1. the cloud is laid over the mesh's case axis (``distribute``);
  2. neighbourhoods are assembled per shard (``sharded_build_neighborhoods``:
     the whole cloud on every shard, brute-force kNN on the device);
  3. every shard fits its own cases with the f64 engine
     (``sharded_fit_many``, no communication), held bit for bit against
     the engine on each shard's cases in turn, and against the one-device
     call on the DOFs scaled to the neighbourhood (each DOF times h^d, h
     the case's largest neighbour distance, d its derivative order) to
     1e-10 of max(|scaled fi|, 1).  The raw DOFs' distance is reported: on
     the CPU it is 0; on a card the engine's bits depend on the batch
     count (the shard-by-shard engine and the one-device call are the
     same function on the same cases), and a raw second derivative
     carries that rounding times h^-2 (h ~ 0.02 here);
  4. the patched global model is queried both ways: Voronoi-nearest and
     blended-continuous (``ExpertSolver.interpolate``'s two modes,
     reference: wlsqm/fitter/expert.pyx:830-986);
  5. a distributed IBVP-style stepping: prepare once, laid over the mesh;
     each step one shard-local gather of the field values and one
     multi-field solve per shard.

Run: python -m wlsqm_tpu_torch.examples.distributed_pipeline [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import engine, tables
from wlsqm_tpu_torch.parallel import sharding

#: logical shards of the one device (the original's eight virtual devices)
SHARDS = 8
N, K, ORDER, NO = 20_000, 16, 2, 6
WEIGHT_CENTER = 2
#: the sharded fit against the one-device call, on the scaled DOFs
ONE_DEVICE_TOL = 1e-10


def field(p):
    return np.sin(np.pi * p[:, 0]) * np.cos(np.pi * p[:, 1])


def run(device=None, shards: int = SHARDS) -> dict:
    """The pipeline on ``shards`` logical shards of ``device`` (the card
    unless ``device="cpu"``).  Returns the fitted DOFs, whether they are
    the engine's bits on each shard, their distance from the one-device
    call (raw and scaled to the neighbourhood), the neighbour indices (self
    excluded), the query errors, and the stepped field's shape and
    finiteness.  Raises if the sharded fit is not the engine's bits on its
    shards, its scaled DOFs are more than ONE_DEVICE_TOL off the one-device
    call's, or the stepped field is not finite."""
    device = config.resolve_device(device)
    mesh = sharding.make_mesh(devices=[device] * shards)
    n = sharding.pad_cases(N, len(mesh))
    rng = np.random.default_rng(42)
    pts = rng.uniform(-1.0, 1.0, (n, 2))
    vals = field(pts)
    pts_d, vals_d = sharding.distribute(mesh, pts, vals)

    # -- 1-2: neighbourhoods on the device
    xk, fk, nk = sharding.sharded_build_neighborhoods(mesh, pts_d, vals_d, pts_d, K,
                                                      exclude_self=True)

    # -- 3: sharded fit (origins at the cloud points)
    xk_rel = [x - p[:, None, :] for x, p in zip(xk, pts_d)]
    args = (np.zeros((n, 2)), np.zeros((n, NO)), np.full((n,), ORDER, np.int32),
            np.zeros((n,), np.int64), np.full((n,), WEIGHT_CENTER, np.int32))
    fi = sharding.sharded_fit_many(mesh, xk_rel, fk, nk, *args, dimension=2, NO=NO)[0]
    # held as chip_smoke.phase_sharded holds the engine: bit for bit against
    # the engine on each shard's cases in turn (what the shards' streams and
    # threads must not change), and to the one-device call on scaled DOFs
    args_s = [sharding.distribute(mesh, a) for a in args]
    own = torch.cat([engine.fit_batch(*a, dimension=2, NO=NO)[0]
                     for a in zip(xk_rel, fk, nk, *args_s)])
    one = engine.fit_batch(sharding.join(xk_rel), sharding.join(fk), sharding.join(nk),
                           *(torch.as_tensor(a, device=device) for a in args),
                           dimension=2, NO=NO)[0]
    fi_all = sharding.join(fi)
    bit_equal = torch.equal(fi_all, own)
    vs_one = float(((fi_all - one).abs().amax(1) / one.abs().amax(1).clamp_min(1.0)).max())
    h = sharding.join(xk_rel).norm(dim=-1).amax(1, keepdim=True)
    scale = h ** torch.tensor([tables.derivative_order(2, j) for j in range(NO)],
                              dtype=h.dtype, device=device)
    vs_one_scaled = float((((fi_all - one) * scale).abs().amax(1)
                           / (one * scale).abs().amax(1).clamp_min(1.0)).max())

    # -- 4: query the patched global model
    q = rng.uniform(-0.9, 0.9, (sharding.pad_cases(1_000, len(mesh)), 2))
    kw = dict(dimension=2, order=ORDER)
    near = sharding.join(sharding.sharded_interpolate_nearest(mesh, fi, pts, q, **kw))
    blend = sharding.sharded_interpolate_continuous(mesh, fi, pts, q, 0.08, **kw)
    dblend = sharding.sharded_interpolate_continuous(mesh, fi, pts, q, 0.08, diff=1, **kw)
    truth = field(q)
    dtruth = np.pi * np.cos(np.pi * q[:, 0]) * np.cos(np.pi * q[:, 1])

    # -- 5: distributed IBVP-style stepping
    idx = sharding.join(sharding.sharded_knn(mesh, pts_d, pts_d, K + 1)[0])[:, 1:]
    pts_t = torch.as_tensor(pts, device=device)
    prep_s = sharding.distribute(mesh, wtt.prepare(pts_t[idx], pts_t, order=ORDER,
                                                   weighting=WEIGHT_CENTER, device=device))
    v = torch.as_tensor(vals, device=device)
    u = torch.stack([v, v ** 2], dim=1)
    lap_idx = [wtt.i2_X2, wtt.i2_Y2]
    for _ in range(3):
        fku = sharding.sharded_gather_values(mesh, u, idx)              # (Bs, K, F) each
        fi_t, _ = sharding.sharded_solve_prepared(
            mesh, prep_s, [f.permute(2, 0, 1) for f in fku])            # (F, Bs, NO) each
        lap = torch.cat(fi_t, dim=1)[..., lap_idx].sum(-1)             # (F, N)
        u = u + 1e-4 * lap.T

    out = {"device": str(device), "shards": len(mesh), "n": n, "k": K,
           "fi": fi_all.cpu().numpy(), "idx": idx.cpu().numpy(),
           "fit_bit_equal_per_shard": bit_equal, "fit_vs_one_device": vs_one,
           "fit_vs_one_device_scaled": vs_one_scaled,
           "nearest_max_error": float(np.abs(near.cpu().numpy() - truth).max()),
           "continuous_max_error": float(np.abs(blend.cpu().numpy() - truth).max()),
           "ddx_blend_max_error": float(np.abs(dblend.cpu().numpy() - dtruth).max()),
           "stepped_finite": bool(torch.isfinite(u).all()), "stepped_shape": list(u.shape)}
    if not bit_equal:
        raise RuntimeError("the sharded fit differs from the engine on its shards")
    if not vs_one_scaled <= ONE_DEVICE_TOL:
        raise RuntimeError("the sharded fit is %.3e off the one-device call (scaled DOFs)"
                           % vs_one_scaled)
    if not out["stepped_finite"]:
        raise RuntimeError("the sharded stepping blew up: %s" % (out,))
    return out


if __name__ == "__main__":
    res = run(device="cpu" if "--cpu" in sys.argv[1:] else None)
    print(f"mesh: {res['shards']} logical shards of {res['device']}")
    print(f"sharded fit: the engine's bits on each shard: {res['fit_bit_equal_per_shard']}, "
          f"{res['fit_vs_one_device']:.1e} off the one-device call "
          f"({res['fit_vs_one_device_scaled']:.1e} on the scaled DOFs)")
    print(f"nearest    max |err| = {res['nearest_max_error']:.2e}")
    print(f"continuous max |err| = {res['continuous_max_error']:.2e}")
    print(f"d/dx blend max |err| = {res['ddx_blend_max_error']:.2e}")
    print(f"sharded stepping: u finite = {res['stepped_finite']}, "
          f"shape {tuple(res['stepped_shape'])}")
