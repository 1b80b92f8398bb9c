"""The port's sharding and driver examples against their JAX originals.

Each ``run(device="cpu")`` returns its schema and meets its original's bar:

* ``distributed_pipeline`` / ``jit_plan_sharding``: the sharded DOFs are the
  one-device call's bits here (the examples raise unless the engine's
  shards are its bits on their cases and the kernel's shards the
  one-device call's), and within 1e-10 of the JAX f64 engine on the same
  inputs (two f64 solves of one well-conditioned order-2 system);
* ``drivers_benchmark``: both batched solves under the reference's 1e-8
  residual bar.
"""

import jax.numpy as jnp
import numpy as np
import torch

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import engine as jengine
from wlsqm_tpu_torch.examples import (distributed_pipeline as dp, drivers_benchmark as db,
                                      jit_plan_sharding as jp)

torch.set_num_threads(1)

TOL = 1e-10


def rel_max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1.0))


def test_distributed_pipeline_is_bit_equal_and_the_engines():
    """Four logical CPU shards: the sharded fit is the engine's bits on each
    shard (the example raises otherwise) and, on the CPU, the one-device
    call's, and within 1e-10 of the JAX f64 engine on the example's
    neighbourhoods (the device kNN ranks in float32, as the JAX package's
    does, so a near tie may pick another neighbour than an exact tree: 6e-4
    apart on this cloud); the queries and the stepping come back finite and
    accurate."""
    res = dp.run(device="cpu", shards=4)
    assert res["device"] == "cpu" and res["shards"] == 4
    assert res["fit_bit_equal_per_shard"] and res["fit_vs_one_device"] == 0.0
    assert res["fit_vs_one_device_scaled"] == 0.0
    assert res["stepped_finite"]
    assert res["stepped_shape"] == [dp.N, 2]
    assert res["nearest_max_error"] < 1e-3 and res["continuous_max_error"] < 1e-3
    n = res["n"]
    pts = np.random.default_rng(42).uniform(-1.0, 1.0, (n, 2))
    idx = res["idx"]
    ref = jengine.fit_batch(
        jnp.asarray(pts[idx] - pts[:, None, :]), jnp.asarray(dp.field(pts)[idx]),
        jnp.full((n,), dp.K, jnp.int32), jnp.zeros((n, 2)), jnp.zeros((n, dp.NO)),
        jnp.full((n,), dp.ORDER, jnp.int32), jnp.zeros((n,), jnp.int64),
        jnp.full((n,), dp.WEIGHT_CENTER, jnp.int32), dimension=2, NO=dp.NO,
        precision="f64")[0]
    assert rel_max(res["fi"], np.asarray(ref)) <= TOL


def test_plan_replay_is_bit_equal_over_shards_and_the_engines():
    """The plan made once is replayed eagerly, in a loop and on eight
    logical shards: the shards' DOFs are the one-device call's bits, and
    within 1e-10 of the JAX f64 engine (``fit_many(backend="xla")``)."""
    res = jp.run(device="cpu")
    assert res["device"] == "cpu" and res["shards"] == jp.SHARDS
    assert res["sharded_bit_equal"] and res["fit_finite"] and res["relax_finite"]
    assert res["route"] in ("kernel", "kernel-split", "xla")
    rng = np.random.default_rng(0)
    xi = rng.uniform(-1, 1, (jp.B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.4, 0.4, (jp.B, jp.K, 2))
    ref = wt.fit_many(xk, np.sin(xk[..., 0]) * np.cos(xk[..., 1]), xi, order=jp.ORDER,
                      backend="xla", precision="f64")
    assert rel_max(res["fi"], np.asarray(ref.fi)) <= TOL


def test_drivers_benchmark_meets_the_residual_bar():
    """Every size of the sweep timed on all three paths, and both batched
    solves under the reference's 1e-8 residual bar at n = 15."""
    res = db.run(device="cpu")
    assert res["device"] == "cpu" and [r["n"] for r in res["rows"]] == list(db.SIZES)
    assert all(min(r["np_loop_s"], r["mgeneral_s"], r["device_chol_s"]) > 0
               for r in res["rows"])
    assert res["worst_residual_mgeneral"] < db.TOL
    assert res["worst_residual_device_chol"] < db.TOL
