"""fit_stream of the port against the JAX package's, on the same inputs.

The ten cases of tests/test_stream.py: memmap input, a chunk that does not
divide the batch (the last chunk padded with its first row), per-case
parameter arrays sliced with the geometry, ``out=``, the refusals, and the
mesh forms (the port's ``mesh=["cpu"] * 4`` against the JAX mesh of four
virtual devices).  DOFs agree with the JAX stream to 1e-10 relative to
max(|ref|, 1) per case.  ALGO_ITERATIVE stops on exact stagnation of the
residual norm, so its counts are decided by last-bit ties wherever the
residual is roundoff, exact polynomial data included (on a quadratic, 44-52%
of the counts agree; ROADMAP "held bars"); the counts are held equal to the
JAX stream's on the cases whose data are zero, where both packages stop on
an exactly zero residual after one trip, and equal to the port's own
``fit_many`` on every case.  Each stream is also held bit for bit to the
port's ``fit_many`` on every padded chunk.
"""

import numpy as np
import pytest
import torch

from torch_port_cases import rel_err
from wlsqm_tpu import api as japi
from wlsqm_tpu.fitter import defs
from wlsqm_tpu.parallel import sharding as jsharding
from wlsqm_tpu_torch import api

torch.set_num_threads(1)

TOL = 1e-10
CPU4 = ["cpu"] * 4


def _problem(rng, B, K=12, dim=2, exact=False):
    """A cloud; with ``exact`` a quadratic, zero on the even cases (an exactly
    zero residual, on which every count is 1 in both packages)."""
    xi = rng.uniform(-1, 1, (B, dim))
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (B, K, dim))
    if exact:
        fk = 1.0 + 2.0 * xk[..., 0] - xk[..., 1] + 0.5 * xk[..., 0] * xk[..., 1]
        fk[::2] = 0.0
    else:
        fk = np.sin(xk[..., 0]) + 0.5 * xk[..., 1] ** 2
    return xk, fk, xi


def _counts(got, ref):
    """Equal counts on the zero-data cases, and refinement ran elsewhere."""
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got[::2], ref[::2])
    assert (got[::2] == 1).all() and got.max() >= 2


def _per_chunk(xk, fk, xi, chunk, plan, **kw):
    """fit_many(plan=) on each chunk, padded with its first row."""
    B = len(xk)
    out = []
    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)

        def pad(a):
            s = a[lo:hi]
            return np.concatenate([s, np.repeat(s[:1], chunk - (hi - lo), axis=0)])

        out.append(api.fit_many(pad(xk), pad(fk), pad(xi), plan=plan, device="cpu",
                                **kw).fi.numpy()[:hi - lo])
    return np.concatenate(out)


def test_stream_equals_fit_many_nondivisible_chunk():
    rng = np.random.default_rng(42)
    B = 103   # 2 chunks of 40 + a 23-case tail
    xk, fk, xi = _problem(rng, B)
    res = api.fit_stream(xk, fk, xi, chunk=40, order=2, device="cpu")
    assert isinstance(res.fi, np.ndarray)
    assert res.fi.shape == (B, defs.number_of_dofs(2, 2))
    assert rel_err(res.fi, np.asarray(japi.fit_stream(xk, fk, xi, chunk=40, order=2).fi)) <= TOL
    plan = api.plan_fit_many(xk[:40], xi[:40], order=2, device="cpu")
    np.testing.assert_array_equal(res.fi, _per_chunk(xk, fk, xi, 40, plan, order=2))


def _per_case(B):
    order = np.where(np.arange(B) % 3 == 0, 1, 2).astype(np.int32)
    knowns = np.where(np.arange(B) % 5 == 0, int(defs.b2_F), 0).astype(np.int64)
    fi_init = np.zeros((B, defs.number_of_dofs(2, 2)))
    fi_init[:, 0] = np.arange(B) * 0.01   # distinct known F per case
    weighting = np.where(np.arange(B) % 2 == 0, defs.WEIGHT_UNIFORM,
                         defs.WEIGHT_CENTER).astype(np.int32)
    return dict(order=order, knowns=knowns, weighting=weighting, fi_init=fi_init,
                max_order=2)


@pytest.mark.parametrize("mesh", [None, CPU4], ids=["one", "mesh4"])
def test_stream_per_case_parameter_arrays(mesh):
    """Per-case order/knowns/weighting/fi_init are sliced with the geometry:
    a mis-sliced array would pair case i's geometry with case j's order
    (tests/test_stream.py:35 and, with the mesh, :137)."""
    rng = np.random.default_rng(42)
    B = 77
    xk, fk, xi = _problem(rng, B, K=16)
    pc = _per_case(B)
    res = api.fit_stream(xk, fk, xi, chunk=32, mesh=mesh, device="cpu", **pc)
    jmesh = None if mesh is None else jsharding.make_mesh(4)
    ref = japi.fit_stream(xk, fk, xi, chunk=32, mesh=jmesh, **pc)
    assert rel_err(res.fi, np.asarray(ref.fi)) <= TOL
    kn = np.arange(B) % 5 == 0
    np.testing.assert_array_equal(res.fi[kn, 0], pc["fi_init"][kn, 0])
    whole = api.fit_many(xk, fk, xi, device="cpu", **pc).fi.numpy()
    assert rel_err(res.fi, whole) <= TOL


def test_stream_memmap_input_and_out(tmp_path):
    rng = np.random.default_rng(42)
    B, K = 61, 12
    xk, fk, xi = _problem(rng, B, K=K)
    mm_path = tmp_path / "xk.dat"
    mm = np.memmap(mm_path, dtype=np.float64, mode="w+", shape=(B, K, 2))
    mm[:] = xk
    mm.flush()
    out = np.zeros((B, defs.number_of_dofs(2, 2)))
    res = api.fit_stream(np.memmap(mm_path, dtype=np.float64, mode="r", shape=(B, K, 2)),
                         fk, xi, chunk=16, order=2, out=out, device="cpu")
    assert res.fi is out
    assert rel_err(out, np.asarray(japi.fit_stream(xk, fk, xi, chunk=16, order=2).fi)) <= TOL
    plan = api.plan_fit_many(xk[:16], xi[:16], order=2, device="cpu")
    np.testing.assert_array_equal(out, _per_chunk(xk, fk, xi, 16, plan, order=2))


def test_stream_iterative_returns_counts():
    """Counts come back per case, equal to the JAX stream's on exact data
    (tests/test_stream.py:76)."""
    rng = np.random.default_rng(42)
    B = 50
    xk, fk, xi = _problem(rng, B, K=14, exact=True)
    kw = dict(order=2, iterative=True, max_iter=3)
    res = api.fit_stream(xk, fk, xi, chunk=24, device="cpu", **kw)
    ref = japi.fit_stream(xk, fk, xi, chunk=24, **kw)
    assert rel_err(res.fi, np.asarray(ref.fi)) <= TOL
    _counts(res.iterations, ref.iterations)
    # noisy data: the counts still come back for every case
    xk, fk, xi = _problem(rng, B, K=14)
    res = api.fit_stream(xk, fk, xi, chunk=24, device="cpu", **kw)
    whole = api.fit_many(xk, fk, xi, device="cpu", **kw)
    np.testing.assert_array_equal(res.iterations, whole.iterations.numpy())


def test_stream_rejects_do_sens_and_debug():
    rng = np.random.default_rng(42)
    xk, fk, xi = _problem(rng, 8)
    for bad in ("do_sens", "debug"):
        with pytest.raises(ValueError, match="do_sens"):
            api.fit_stream(xk, fk, xi, chunk=4, device="cpu", **{bad: True})


def test_stream_out_shape_validated():
    rng = np.random.default_rng(42)
    xk, fk, xi = _problem(rng, 8)
    with pytest.raises(ValueError, match="out must have shape"):
        api.fit_stream(xk, fk, xi, chunk=4, order=2, out=np.zeros((8, 3)), device="cpu")


def test_stream_sharded_equals_fit_many():
    """fit_stream(mesh=...) over four CPU shards: each chunk (rounded up to a
    multiple of the shards) split over them, equal to the JAX sharded stream
    and bit-equal to the port's fit_many(plan=) on each shard's cases
    (tests/test_stream.py:96)."""
    rng = np.random.default_rng(42)
    B = 150   # 4 chunks of 40 (10 a shard), padded tail of 30
    xk, fk, xi = _problem(rng, B, K=14)
    plan = api.plan_fit_many(xk, xi, order=2, device="cpu")
    res = api.fit_stream(xk, fk, xi, chunk=40, order=2, mesh=CPU4, plan=plan)
    assert isinstance(res.fi, np.ndarray)
    jplan = japi.plan_fit_many(xk, xi, order=2)
    ref = japi.fit_stream(xk, fk, xi, chunk=40, order=2, mesh=jsharding.make_mesh(4),
                          plan=jplan)
    assert rel_err(res.fi, np.asarray(ref.fi)) <= TOL
    np.testing.assert_array_equal(res.fi, _per_chunk(xk, fk, xi, 10, plan, order=2))


def test_stream_sharded_heterogeneous_nk_and_counts():
    """Ragged neighbour counts and iteration counts survive the sharded
    stream (tests/test_stream.py:113)."""
    rng = np.random.default_rng(42)
    B, K = 96, 16
    xk, fk, xi = _problem(rng, B, K=K, exact=True)
    nk = rng.integers(10, K + 1, B).astype(np.int32)
    kw = dict(order=2, iterative=True, max_iter=3)
    plan = api.plan_fit_many(xk, xi, nk=nk, order=2, iterative=True, device="cpu")
    res = api.fit_stream(xk, fk, xi, nk=nk, chunk=32, mesh=CPU4, plan=plan, **kw)
    jplan = japi.plan_fit_many(xk, xi, nk=nk, order=2, iterative=True)
    ref = japi.fit_stream(xk, fk, xi, nk=nk, chunk=32, mesh=jsharding.make_mesh(4),
                          plan=jplan, **kw)
    assert rel_err(res.fi, np.asarray(ref.fi)) <= TOL
    _counts(res.iterations, ref.iterations)
    whole = api.fit_many(xk, fk, xi, nk=nk, plan=plan, device="cpu", **kw)
    np.testing.assert_array_equal(res.iterations, whole.iterations.numpy())


def test_stream_sharded_mixed_order_iterative_counts():
    """Mixed orders over the mesh with refinement: the counts scatter back
    to the right cases (tests/test_stream.py:162)."""
    rng = np.random.default_rng(42)
    B = 60
    xk, fk, xi = _problem(rng, B, K=14, exact=True)
    order = np.where(np.arange(B) % 2 == 0, 2, 1).astype(np.int32)
    kw = dict(order=order, max_order=2, iterative=True, max_iter=3)
    res = api.fit_stream(xk, fk, xi, chunk=24, mesh=CPU4, **kw)
    ref = japi.fit_stream(xk, fk, xi, chunk=24, mesh=jsharding.make_mesh(4), **kw)
    assert rel_err(res.fi, np.asarray(ref.fi)) <= TOL
    _counts(res.iterations, ref.iterations)
    whole = api.fit_many(xk, fk, xi, device="cpu", **kw)
    np.testing.assert_array_equal(res.iterations, whole.iterations.numpy())
