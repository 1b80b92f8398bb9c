"""The port's window gather against the JAX package's.

``morton_order`` and every ``GatherPlan`` field must equal the JAX
package's exactly (the plan is integer bookkeeping).  ``gather_rows`` and
``gather_rows_pair`` on CPU tensors run the plain version, ``u[idx]``, and
must equal the JAX package's interpreted Pallas kernel bit for bit.  The
CUDA kernel itself is checked on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from wlsqm_tpu.ops import gather as jgather
from wlsqm_tpu.ops import twofloat as tf
from wlsqm_tpu_torch.ops import gather
from wlsqm_tpu_torch.utils.interop import gather_plan_from_fields

torch.set_num_threads(1)


def _local_idx(rng, n, B, K, spread=40):
    base = rng.integers(0, n, B)
    base.sort()
    return np.clip(base[:, None] + rng.integers(-spread, spread, (B, K)),
                   0, n - 1).astype(np.int32)


def _three_clusters(rng, n, B, K, every):
    """tests/test_gather.py's overflow idx: every ``every``-th block of 16
    cases reads from three far-apart clusters."""
    base = rng.integers(0, 200, (B, 1))
    idx = base + rng.integers(0, 30, (B, K))
    three = (np.arange(B) // gather.BLOCK_T) % every == 0
    pick = rng.integers(0, 3, (B, K))
    idx = np.where(three[:, None] & (pick == 1), 30000 + rng.integers(0, 30, (B, K)), idx)
    idx = np.where(three[:, None] & (pick == 2), 59000 + rng.integers(0, 30, (B, K)), idx)
    return idx.astype(np.int32)


def _seam(rng, n, B, K):
    base = rng.integers(0, 400, (B, 1))
    near = base + rng.integers(0, 40, (B, K))
    far = 45000 + base + rng.integers(0, 40, (B, K))
    return np.where(rng.random((B, K)) < 0.5, far, near).astype(np.int32)


def _idx_set(name):
    rng = np.random.default_rng(IDX_SETS.index(name))
    if name == "local":
        return _local_idx(rng, 5000, 2048, 28), 5000
    if name == "ragged_tail":
        return _local_idx(rng, 3000, gather.BLOCK_T * 3 + 17, 11, spread=25), 3000
    if name == "end_of_array":
        return np.full((gather.BLOCK_T, 8), 599, np.int32), 600
    if name == "seam":
        return _seam(rng, 50000, 1024, 16), 50000
    if name == "three_clusters":
        return _three_clusters(rng, 60000, 512, 12, every=8), 60000
    if name == "nonlocal":
        return rng.integers(0, 100000, (4096, 20)).astype(np.int32), 100000
    raise KeyError(name)


IDX_SETS = ["local", "ragged_tail", "end_of_array", "seam", "three_clusters", "nonlocal"]


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_morton_order_matches_jax(dim):
    rng = np.random.default_rng(dim)
    pts = rng.uniform(-1, 1, (4096, dim) if dim > 1 else 4096)
    pts[7] = pts[11]                      # a tie: the stable sort keeps the order
    np.testing.assert_array_equal(gather.morton_order(pts), jgather.morton_order(pts))


@pytest.mark.parametrize("name", IDX_SETS)
def test_plan_matches_jax(name):
    idx, n = _idx_set(name)
    ref = jgather.plan_window_gather(idx, n)
    got = gather.plan_window_gather(idx, n)
    if name == "nonlocal":
        assert ref is None and got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.coverage == ref.coverage
    if name == "three_clusters":
        assert 0 < len(got.bad_blocks) < got.nblk
    # the same plan from a tensor of indices
    assert gather.plan_window_gather(torch.as_tensor(idx), n) == got


@pytest.mark.parametrize("name", ["local", "ragged_tail", "end_of_array", "seam",
                                  "three_clusters"])
def test_plan_carried_from_jax(name):
    idx, n = _idx_set(name)
    ref = jgather.plan_window_gather(idx, n)
    carried = gather_plan_from_fields(dataclasses.asdict(ref))
    assert carried == gather.plan_window_gather(idx, n)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(n))
    assert torch.equal(gather.gather_rows(u, idx, carried), u[torch.as_tensor(idx).long()])
    with pytest.raises(ValueError, match="missing"):
        gather_plan_from_fields({k: v for k, v in dataclasses.asdict(ref).items()
                                 if k != "meta"})


@pytest.mark.parametrize("F,dtype", [(1, np.float64), (3, np.float64), (1, np.float32),
                                     (2, np.float32)])
def test_gather_rows_matches_jax_kernel(F, dtype):
    """Bit-exact against the interpreted TPU kernel, NaN, ±0 and ±inf
    included, on a ragged tail and a plan with overflow blocks."""
    rng = np.random.default_rng(F)
    n, B, K = 60000, 16 * 20 + 5, 12
    idx = _three_clusters(rng, n, B, K, every=8)
    plan = gather.plan_window_gather(idx, n)
    assert plan.bad_blocks
    u = rng.standard_normal((n, F) if F > 1 else n).astype(dtype)
    u.reshape(-1)[::11] = np.nan
    u.reshape(-1)[1::11] = -0.0
    u.reshape(-1)[2::11] = np.inf
    u.reshape(-1)[3::11] = -np.inf
    ref = np.asarray(jgather.gather_rows(u, idx, jgather.plan_window_gather(idx, n),
                                         interpret=True))
    before = gather.LAUNCHES
    got = gather.gather_rows(torch.as_tensor(u), torch.as_tensor(idx), plan)
    assert gather.LAUNCHES == before        # the CPU never launches the kernel
    assert got.dtype == torch.as_tensor(u).dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("F", [5, 8])
def test_gather_rows_matches_jax_kernel_on_wide_f64_rows(F):
    """f64 rows of 5 and 8 fields (40 and 64 bytes: the Euler step's flux
    rows are the second) on a small Morton-ordered cloud's neighbourhoods,
    bit-exact against the interpreted TPU kernel, NaN, ±0 and ±inf
    included."""
    rng = np.random.default_rng(40 + F)
    pts = rng.uniform(-1.0, 1.0, (3000, 2))
    pts = pts[gather.morton_order(pts)]
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1)[:, :24].astype(np.int32)
    n = len(pts)
    u = rng.standard_normal((n, F))
    u.reshape(-1)[::11] = np.nan
    u.reshape(-1)[1::11] = -0.0
    u.reshape(-1)[2::11] = np.inf
    u.reshape(-1)[3::11] = -np.inf
    ref = np.asarray(jgather.gather_rows(u, idx, jgather.plan_window_gather(idx, n),
                                         interpret=True))
    got = gather.gather_rows_plain(torch.as_tensor(u), torch.as_tensor(idx))
    assert got.shape == ref.shape == (n, 24, F)
    np.testing.assert_array_equal(got.numpy().view(np.uint8), ref.view(np.uint8))
    np.testing.assert_array_equal(
        gather.gather_rows(torch.as_tensor(u), idx, gather.plan_window_gather(idx, n))
        .numpy().view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_gather_rows_integer_payloads(dtype):
    rng = np.random.default_rng(5)
    idx, n = _local_idx(rng, 3000, 500, 9), 3000
    plan = gather.plan_window_gather(idx, n)
    u = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (n, 2)), dtype=dtype)
    assert torch.equal(gather.gather_rows(u, idx, plan), u[torch.as_tensor(idx).long()])


@pytest.mark.parametrize("F", [1, 2])
def test_gather_rows_pair_matches_jax_kernel(F):
    import jax.numpy as jnp

    rng = np.random.default_rng(10 + F)
    n, B, K = 5000, 1024, 24
    idx = _local_idx(rng, n, B, K)
    u = rng.standard_normal((n, F) if F > 1 else n)
    up = tf.from_f64(jnp.asarray(u))
    ref_hi, ref_lo = jgather.gather_rows_pair(up, idx, jgather.plan_window_gather(idx, n),
                                              interpret=True)
    hi, lo = gather.gather_rows_pair((np.asarray(up[0]), np.asarray(up[1])), idx,
                                     gather.plan_window_gather(idx, n))
    assert hi.dtype == lo.dtype == torch.float32
    np.testing.assert_array_equal(hi.numpy(), np.asarray(ref_hi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(ref_lo))


def test_validation_errors_match_jax():
    """The JAX package's messages for a shape or plan mismatch; the port also
    rejects a plan built for other indices, out-of-range indices and 2-byte
    payloads."""
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    n, B, K = 4000, 512, 16
    idx = _local_idx(rng, n, B, K)
    jplan = jgather.plan_window_gather(idx, n)
    plan = gather.plan_window_gather(idx, n)
    u = rng.standard_normal(n)
    cases = [
        ("identical shapes", lambda g, p, arr: g.gather_rows_pair(
            (arr(u.astype(np.float32)), arr(np.zeros(n - 1, np.float32))), idx, p)),
        ("rebuild the plan", lambda g, p, arr: g.gather_rows(arr(np.zeros(n + 128)), idx, p)),
        ("rebuild the plan", lambda g, p, arr: g.gather_rows_pair(
            (arr(np.zeros(n - 8, np.float32)), arr(np.zeros(n - 8, np.float32))), idx, p)),
    ]
    for match, call in cases:
        with pytest.raises(ValueError, match=match):
            call(jgather, jplan, jnp.asarray)
        with pytest.raises(ValueError, match=match):
            call(gather, plan, torch.as_tensor)
    with pytest.raises(ValueError, match="rebuild the plan"):
        gather.gather_rows(torch.as_tensor(u), idx[:, :8], plan)
    with pytest.raises(ValueError, match="rebuild the plan"):
        gather.gather_rows(torch.as_tensor(u), np.concatenate([idx, idx]), plan)
    with pytest.raises(TypeError, match="4- and 8-byte"):
        gather.gather_rows(torch.zeros(n, dtype=torch.int16), idx, plan)
    for bad in (-1, n):
        wrong = idx.copy()
        wrong[3, 2] = bad
        with pytest.raises(ValueError, match=r"\[0, 4000\)"):
            gather.plan_window_gather(wrong, n)


@pytest.mark.parametrize("row_bytes,u_off,out_off,want", [
    (8, 0, 0, 8),        # f64 F = 1, int64, f32 pair F = 2: 8-byte pieces
    (24, 0, 0, 8),       # f64 F = 3
    (4, 0, 0, 4),        # f32 / int32 F = 1
    (12, 0, 0, 4),       # f32 F = 3
    (16, 0, 0, 16),      # f64 F = 2: whole 16-byte rows
    (16, 8, 0, 8),       # ... u offset by one f64 element: no 16-byte loads
    (16, 4, 0, 4),       # ... by one f32 element
    (8, 4, 0, 4),        # f32 F = 2 offset by one element
    (24, 8, 0, 8),
    (8, 0, 8, None),     # out not 16-byte aligned: the word copy
    (20, 0, 0, 4),       # five words (f32 F = 5): the run-time width
    (48, 0, 0, 16),      # twelve words (f64 F = 6)
    (64, 0, 0, 16),      # f64 F = 8, the Euler step's rows: four 16-byte pieces
    (64, 8, 0, 8),       # ... u offset by one f64 element
    (64, 4, 0, 4),       # ... by one f32 element
    (64, 0, 8, None),    # ... out offset by one f64 element: the word copy
    (32, 0, 0, 16),      # f64 F = 4
    (40, 0, 0, 8),       # f64 F = 5: 8-byte pieces
    (40, 8, 0, 8),
    (40, 0, 4, None),
    (28, 0, 0, 4),       # f32 F = 7
    (56, 0, 0, 8),       # f64 F = 7
    (80, 0, 0, 16),      # twenty words (f32 F = 20, f64 F = 10)
    (2, 0, 0, None),     # not whole words
])
def test_vector_plan(row_bytes, u_off, out_off, want):
    """The kernel instance comes from the row width and the pointers'
    alignment: never from a failed launch."""
    base = 1 << 20
    assert gather._vector_plan(row_bytes, base + u_off, base + out_off) == want
    if want is not None:
        assert row_bytes % want == 0 and (base + u_off) % want == 0


def test_vector_plan_of_a_pair_takes_the_less_aligned_plane():
    assert gather._vector_plan(16, (1 << 20) | ((1 << 20) + 8), 1 << 20) == 8
