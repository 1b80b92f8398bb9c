"""The port's sharding layer: sharded ≡ one device, and ≡ the JAX package.

The cases of tests/test_sharding.py that the port's functions cover, with
the mesh a list of four CPU devices (``["cpu"] * 4``, logical shards) held
bit for bit against the port's one-device call, and against the JAX
package's functions on its mesh of four virtual devices to the stated
tolerance.  The JAX test of collectives in the compiled fit has no
counterpart: a shard's work here is plain torch on its own tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wlsqm_tpu as wt
import wlsqm_tpu_torch as wtt
from torch_port_cases import rel_err
from wlsqm_tpu.fitter import defs
from wlsqm_tpu.fitter import engine as jengine
from wlsqm_tpu.fitter import interp as jinterp
from wlsqm_tpu.ops import gather as jgather
from wlsqm_tpu.parallel import sharding as jsharding
from wlsqm_tpu.utils import neighbors as jneighbors
from wlsqm_tpu_torch import api
from wlsqm_tpu_torch.fitter import engine
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows, gather
from wlsqm_tpu_torch.parallel import sharding

torch.set_num_threads(1)

MESH = sharding.make_mesh(devices=["cpu"] * 4)
TOL = 1e-10


def _join(shards):
    return sharding.join(shards).numpy()


def _problem(rng, ncases, npts):
    xk = rng.uniform(-1, 1, (ncases, npts, 2))
    x, y = xk[..., 0], xk[..., 1]
    fk = 1.0 + 2.0 * x + 3.0 * y + 4.0 * x * y + 5.0 * x ** 2 + 6.0 * y ** 2
    return (xk, fk, np.full(ncases, npts, np.int32), np.zeros((ncases, 2)),
            np.zeros((ncases, 6)), np.full(ncases, 2, np.int32), np.zeros(ncases, np.int64),
            np.full(ncases, wt.WEIGHT_UNIFORM, np.int32))


@pytest.mark.parametrize("ncases", [64, 61])
def test_sharded_equals_single_device(ncases):
    """sharded_fit_many on four shards is the one-device engine, bit for bit,
    even when the shards differ in size; and the JAX sharded fit to 1e-10."""
    args = _problem(np.random.default_rng(42), ncases, 25)
    out = sharding.sharded_fit_many(MESH, *args, dimension=2, NO=6)
    assert [len(s) for s in out[0]] == [len(t) for t in torch.tensor_split(
        torch.zeros(ncases), 4)]
    one = engine.fit_batch(*(torch.as_tensor(a) for a in args), dimension=2, NO=6)
    for got, want in zip(out, one):
        if want.numel():
            np.testing.assert_array_equal(_join(got), want.numpy())
    if ncases % 4 == 0:
        jfi = jsharding.sharded_fit_many(jsharding.make_mesh(4), *args, dimension=2, NO=6)[0]
        assert rel_err(_join(out[0]), np.asarray(jfi)) <= TOL


def test_sharded_iterative_and_sens():
    args = _problem(np.random.default_rng(43), 40, 20)
    fk = args[1] + 1e-3 * np.random.default_rng(1).standard_normal(args[1].shape)
    args = (args[0], fk) + args[2:]
    kw = dict(dimension=2, NO=6, do_sens=True, iterative=True, max_iter=3)
    fi, sens, it, _ = sharding.sharded_fit_many(MESH, *args, **kw)
    one = engine.fit_batch(*(torch.as_tensor(a) for a in args), **kw)
    np.testing.assert_array_equal(_join(fi), one[0].numpy())
    np.testing.assert_array_equal(_join(sens), one[1].numpy())
    np.testing.assert_array_equal(_join(it), one[2].numpy())


def test_replicated_coefficients_gathers_all():
    fi = np.random.default_rng(42).standard_normal((30, 6))
    rep = sharding.replicated_coefficients(MESH, sharding.distribute(MESH, fi))
    assert len(rep) == 4
    for r in rep:
        np.testing.assert_array_equal(r.numpy(), fi)


def test_pad_cases_and_make_mesh():
    assert sharding.pad_cases(10, 8) == 16
    assert sharding.pad_cases(16, 8) == 16
    assert sharding.pad_cases(1, 8) == 8
    assert sharding.make_mesh(2, devices=["cpu"] * 4) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh()


@pytest.mark.parametrize("dim,order,knowns", [(2, 2, 0), (2, 4, 0), (3, 2, 1)])
def test_sharded_pallas_equals_single_device(dim, order, knowns):
    """sharded_fit_pallas runs the kernels (their plain versions here) per
    shard: bit-equal to one call, and to the JAX f64 engine to 1e-10."""
    rng = np.random.default_rng(44)
    B, K = 256, 30 if dim == 2 else 20
    xk = rng.uniform(-1, 1, (B, K, dim))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., -1])
    nk = np.full(B, K, np.int32)
    xi = np.zeros((B, dim))
    NO = defs.number_of_dofs(dim, order)
    fi0 = np.zeros((B, NO))
    fi0[:, 0] = 0.25
    kw = dict(dimension=dim, order=order, weighting=wt.WEIGHT_CENTER, knowns=knowns)
    got = _join(sharding.sharded_fit_pallas(MESH, xk, fk, nk, xi, fi0, **kw))
    t = [torch.as_tensor(a) for a in (xk, fk, nk, xi, fi0)]
    if fit_kernel.supported(dim, order, knowns, wt.WEIGHT_CENTER):
        one = fit_kernel.fit_kernel(*t, **kw)     # the moment kernel: 3D and knowns too
    else:
        one = fit_rows.fit_rows(*t, **kw)[0]
    np.testing.assert_array_equal(got, one.numpy())
    jfi = jengine.fit_batch(*(jnp.asarray(a) for a in (xk, fk, nk, xi, fi0)),
                            jnp.full(B, order, jnp.int32), jnp.full(B, knowns, jnp.int64),
                            jnp.full(B, wt.WEIGHT_CENTER, jnp.int32), dimension=dim, NO=NO,
                            precision="f64")[0]
    assert rel_err(got, np.asarray(jfi)) <= TOL
    with pytest.raises(ValueError, match="no kernel covers"):
        sharding.sharded_fit_pallas(MESH, xk, fk, nk, xi, dimension=dim, order=5,
                                    weighting=wt.WEIGHT_CENTER)


def test_sharded_interpolate_continuous():
    """Per-shard partial sums added up (the JAX psum) equal the one-device
    blend, and the JAX package's, to 1e-12 (tests/test_sharding.py:133)."""
    rng = np.random.default_rng(42)
    B = 61
    xi = rng.uniform(-1, 1, (B, 2))
    fi = rng.normal(size=(B, 6))
    q = rng.uniform(-0.9, 0.9, (23, 2))
    num, den = jinterp.interpolate_continuous(fi, xi, q, 0.6, dimension=2, order=2)
    want = np.asarray(num) / np.asarray(den)
    got = sharding.sharded_interpolate_continuous(MESH, fi, xi, q, 0.6, dimension=2,
                                                  order=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    jgot = np.asarray(jsharding.sharded_interpolate_continuous(
        jsharding.make_mesh(4), fi, xi, q, 0.6, dimension=2, order=2))
    np.testing.assert_allclose(got, jgot, rtol=1e-12, atol=1e-14)


def test_sharded_knn_matches_single_device():
    rng = np.random.default_rng(42)
    N, M, k = 203, 45, 7
    pts = rng.uniform(-1, 1, (N, 2))
    q = rng.uniform(-1, 1, (M, 2))
    idx_j, d_j = jneighbors.knn(pts, q, k, backend="tpu")
    idx, d2 = sharding.sharded_knn(MESH, pts, q, k)
    for a, b in zip(np.asarray(idx_j), _join(idx)):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(np.sort(_join(d2), -1), np.sort(np.asarray(d_j), -1),
                               rtol=1e-12)


def test_sharded_build_neighborhoods_pipeline():
    """cloud -> sharded neighbourhoods -> sharded fit == the JAX host
    pipeline (tests/test_sharding.py:174)."""
    rng = np.random.default_rng(42)
    N, k = 160, 12
    pts = rng.uniform(-1, 1, (N, 2))
    vals = np.sin(pts[:, 0]) + pts[:, 1] ** 2
    xk, fk, nk = sharding.sharded_build_neighborhoods(MESH, pts, vals, pts, k,
                                                      exclude_self=True)
    xk, fk, nk = _join(xk), _join(fk), _join(nk)
    res = wtt.fit_many(xk - pts[:, None, :], fk, np.zeros((N, 2)), nk=nk, order=2,
                       device="cpu", backend="engine")
    xk0, fk0, nk0 = jneighbors.build_neighborhoods(pts, vals, pts, k, exclude_self=True)
    ref = wt.fit_many(np.asarray(xk0) - pts[:, None, :], fk0, np.zeros((N, 2)), nk=nk0,
                      order=2)
    np.testing.assert_allclose(res.fi.numpy(), np.asarray(ref.fi), rtol=0, atol=1e-9)


def test_sharded_interpolate_nearest():
    rng = np.random.default_rng(42)
    B, Q = 51, 29
    xi = rng.uniform(-1, 1, (B, 2))
    fi = rng.normal(size=(B, 6))
    q = rng.uniform(-1, 1, (Q, 2))
    got = _join(sharding.sharded_interpolate_nearest(MESH, fi, xi, q, dimension=2,
                                                     order=2))
    want = np.asarray(jsharding.sharded_interpolate_nearest(
        jsharding.make_mesh(4), fi, xi, q, dimension=2, order=2))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_sharded_gather_values_matches_global():
    rng = np.random.default_rng(42)
    n, B, K, F = 64, 61, 7, 3
    vals = rng.standard_normal((n, F))
    idx = rng.integers(0, n, (B, K))
    got = sharding.sharded_gather_values(MESH, sharding.distribute(MESH, vals), idx)
    np.testing.assert_array_equal(_join(got), vals[idx])


def _morton_cloud(rng, n, K):
    pts = rng.uniform(-1, 1, (n, 2))
    pts = pts[gather.morton_order(pts)]
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return pts, np.argsort(d2, axis=1)[:, 1:K + 1].astype(np.int32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_sharded_gather_values_window_plan(monkeypatch, dtype):
    """With a plan, each shard runs the kernel's wrapper on its own cases,
    whether or not the plan's blocks divide over the shards; bit-equal to
    fancy indexing, and to the JAX result within its pair encoding
    (tests/test_sharding.py:244)."""
    rng = np.random.default_rng(42)
    n, K, F = 2048, 8, 2
    pts, idx = _morton_cloud(rng, n, K)
    plan = gather.plan_window_gather(idx, n, window=256)
    assert plan is not None and plan.nblk % 4 == 0 and plan.nblk % 3 and plan.bad_blocks
    vals = (rng.standard_normal((n, F)) * 1000).astype(dtype)
    seen = []
    real = gather._gather
    monkeypatch.setattr(gather, "_gather",
                        lambda name, u, i: seen.append(i.shape[0]) or real(name, u, i))
    got = sharding.sharded_gather_values(MESH, torch.as_tensor(vals), idx, plan=plan)
    assert seen == [n // 4] * 4
    assert _join(got).shape == (n, K, F)
    np.testing.assert_array_equal(_join(got), vals[idx])
    if dtype == np.float64:
        jplan = jgather.plan_window_gather(idx, n, window=256)
        jgot = jsharding.sharded_gather_values(jsharding.make_mesh(4), jnp.asarray(vals),
                                               jnp.asarray(idx), plan=jplan)
        np.testing.assert_allclose(_join(got), np.asarray(jgot), rtol=4e-15, atol=1e-14)
    # blocks that do not divide over the shards: still one launch a shard
    seen.clear()
    got3 = sharding.sharded_gather_values(MESH[:3], torch.as_tensor(vals), idx, plan=plan)
    assert len(seen) == 3 and sum(seen) == n
    np.testing.assert_array_equal(_join(got3), vals[idx])
    # no plan: the plain gather, as in the reference
    seen.clear()
    got0 = sharding.sharded_gather_values(MESH, torch.as_tensor(vals), idx)
    assert seen == []
    np.testing.assert_array_equal(_join(got0), vals[idx])


def test_sharded_gather_values_refuses_a_stale_plan():
    """A plan built for another cloud or other indices raises, as
    gather_rows does, instead of gathering under it."""
    rng = np.random.default_rng(43)
    n, K = 512, 8
    pts, idx = _morton_cloud(rng, n, K)
    plan = gather.plan_window_gather(idx, n, window=256)
    v = torch.as_tensor(rng.standard_normal(n))
    with pytest.raises(ValueError, match="rebuild the plan"):
        sharding.sharded_gather_values(MESH, v[:-1], idx, plan=plan)
    with pytest.raises(ValueError, match="rebuild the plan"):
        sharding.sharded_gather_values(MESH, v, idx[:, :-1], plan=plan)
    with pytest.raises(ValueError, match="rebuild the plan"):
        sharding.sharded_gather_values(MESH, v, idx[:-32], plan=plan)


def test_gather_local_checks():
    rng = np.random.default_rng(7)
    n, K = 512, 8
    pts, idx = _morton_cloud(rng, n, K)
    plan = gather.plan_window_gather(idx, n, window=256)
    v = torch.as_tensor(rng.standard_normal(n))
    meta = np.asarray(plan.meta).reshape(plan.nblk, 3)
    kw = dict(window=plan.window, TKp=128, n_pad=plan.n_pad, T=plan.T)
    got = gather.gather_local(v, idx, meta, np.zeros(1, np.int32), **kw)
    np.testing.assert_array_equal(got.numpy(), v.numpy()[idx])
    with pytest.raises(ValueError, match="blocks"):
        gather.gather_local(v, idx[:-16], meta, np.zeros(1, np.int32), **kw)
    with pytest.raises(ValueError, match="layout"):
        gather.gather_local(v, idx, meta, np.zeros(1, np.int32), **dict(kw, TKp=64))
    with pytest.raises(ValueError, match="overflow rows"):
        gather.gather_local(v, idx, meta, np.array([n], np.int32), **kw)


def test_sharded_ibvp_step_matches_single_device():
    """A sharded IBVP step (shard-local gather + case-sharded prepared
    solve, two fields) is the one-device step bit for bit, and the JAX
    step to 1e-10 (tests/test_sharding.py:271)."""
    rng = np.random.default_rng(42)
    n, k = 64, 10
    pts = rng.uniform(0, 1, (n, 2))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1)[:, 1:k + 1]
    xk = pts[idx]
    u = np.stack([np.sin(np.pi * pts[:, 0]), np.cos(np.pi * pts[:, 1])], axis=1)

    prep = wtt.prepare(xk, pts, order=2, weighting=wtt.WEIGHT_CENTER, device="cpu")
    fk_1 = torch.as_tensor(u)[torch.as_tensor(idx)]
    fi_1, _ = wtt.solve(prep, fk_1.movedim(-1, 0))

    fk_s = sharding.sharded_gather_values(MESH, torch.as_tensor(u), idx)
    fi_s, sens = sharding.sharded_solve_prepared(
        MESH, sharding.distribute(MESH, prep), [f.movedim(-1, 0) for f in fk_s])
    assert sens is None
    np.testing.assert_array_equal(torch.cat(fi_s, dim=1).numpy(), fi_1.numpy())
    fi_w, sens_w = sharding.sharded_solve_prepared(MESH, prep, fk_1[..., 0], do_sens=True)
    one = wtt.solve(prep, fk_1[..., 0], do_sens=True)
    np.testing.assert_array_equal(_join(fi_w), one[0].numpy())
    np.testing.assert_array_equal(_join(sens_w), one[1].numpy())

    jprep = wt.prepare(jnp.asarray(xk), jnp.asarray(pts), order=2,
                       weighting=wt.WEIGHT_CENTER)
    jfi, _ = wt.solve(jprep, jnp.moveaxis(jnp.asarray(u)[jnp.asarray(idx)], -1, 0))
    for f in range(2):
        assert rel_err(fi_1.numpy()[f], np.asarray(jfi)[f]) <= TOL


def test_sharded_kernel_adjoint_matches_single_device():
    """Gradients of fit_rows_diffable per shard, summed: the one-device
    gradient bit for bit (tests/test_sharding.py:301)."""
    rng = np.random.default_rng(42)
    B, K = 256, 12
    xk = torch.as_tensor(rng.uniform(-1, 1, (B, K, 2)))
    fk = torch.sin(xk[..., 0]) * torch.cos(xk[..., 1])
    nk = torch.full((B,), K, dtype=torch.int32)
    xi = torch.zeros((B, 2), dtype=torch.float64)
    kw = dict(dimension=2, order=2, weighting=wt.WEIGHT_CENTER)

    f1 = fk.clone().requires_grad_(True)
    (fit_rows.fit_rows_diffable(xk, f1, nk, xi, **kw) ** 2).sum().backward()
    shards = sharding.distribute(MESH, xk, fk, nk, xi)
    grads = []
    for x, f, m, o in zip(*shards):
        f = f.clone().requires_grad_(True)
        (fit_rows.fit_rows_diffable(x, f, m, o, **kw) ** 2).sum().backward()
        grads.append(f.grad)
    np.testing.assert_array_equal(torch.cat(grads).numpy(), f1.grad.numpy())


def test_planned_route_per_shard_equals_one_device():
    """fit_many(plan=) on each shard's cases is the one-device planned call,
    bit for bit (tests/test_sharding.py:352, 398)."""
    rng = np.random.default_rng(42)
    B, K = 512, 14
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.3, 0.3, (B, K, 2))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])
    plan = api.plan_fit_many(xk, xi, order=2, weighting=defs.WEIGHT_CENTER, device="cpu")
    assert plan.route.path == "kernel"
    one = api.fit_many(xk, fk, xi, order=2, weighting=defs.WEIGHT_CENTER, plan=plan,
                       device="cpu").fi
    parts = [api.fit_many(x, f, o, order=2, weighting=defs.WEIGHT_CENTER, plan=plan,
                          device="cpu").fi
             for x, f, o in zip(*sharding.distribute(MESH, xk, fk, xi))]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), one.numpy())
