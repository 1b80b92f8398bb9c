"""The moment-assembly kernel's plain version, on the CPU.

Held to the JAX f64 engine at 1e-10 (the repo's parity bar: the moment
form and the basis-row form round differently, by ~cond * eps), and to
the JAX TPU kernel run as its own tests run it — the Pallas interpreter on
XLA:CPU, in f32-pair arithmetic — at that test's f32-grade 5e-6
(tests/test_pallas_fit.py:84).  The CUDA kernel itself is tested on the card
by tests/test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_cases import cloud, rel_err
from wlsqm_tpu.fitter import engine as jengine
from wlsqm_tpu.ops import pallas_fit
from wlsqm_tpu.ops.pallas_fit import fit_pallas
from wlsqm_tpu_torch.fitter import calibration, condprobe, defs
from wlsqm_tpu_torch.ops import fit_kernel

torch.set_num_threads(1)

PARITY = 1e-10


def _t(case):
    return [torch.as_tensor(case[k]) for k in ("xk", "fk", "nk", "xi")]


def _jax_engine(case, order):
    B = len(case["nk"])
    NO = defs.number_of_dofs(2, order)
    fi, *_ = jengine.fit_batch(
        *(jnp.asarray(case[k]) for k in ("xk", "fk", "nk", "xi")),
        jnp.zeros((B, NO)), jnp.full((B,), order, jnp.int32),
        jnp.zeros((B,), jnp.int64), jnp.asarray(case["weighting"]),
        dimension=2, NO=NO)
    return np.asarray(fi)


@pytest.mark.parametrize("weighting", [defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_plain_matches_jax_engine(order, weighting):
    rng = np.random.default_rng(10 * order + weighting)
    case = cloud(rng, 256, 30, 2, orders=(order,), weightings=(weighting,),
                 radius=(0.01, 1.0))
    got = fit_kernel.fit_moments_plain(*_t(case), dimension=2, order=order,
                                       weighting=weighting).numpy()
    assert np.isfinite(got).all()
    assert rel_err(got, _jax_engine(case, order)) <= PARITY


@pytest.mark.parametrize("weighting", [defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER])
def test_degenerate_neighborhood_is_guarded(weighting):
    """h² = 0 (every neighbor at xi): order 0 is the weighted mean, as in
    the engine; above it the f64 engine's Cholesky fails (NaN) while the
    TPU kernel's pivot guard gives the mean and zero derivatives — the
    port follows the kernel."""
    rng = np.random.default_rng(3)
    case = cloud(rng, 8, 30, 2, orders=(0,), weightings=(weighting,))
    case["xk"][:] = np.where(np.isnan(case["xk"]), np.nan, case["xi"][:, None, :])
    mean = np.nanmean(case["fk"], axis=1)    # both weightings are 1 at d = 0
    got0 = fit_kernel.fit_moments_plain(*_t(case), dimension=2, order=0,
                                        weighting=weighting).numpy()
    assert rel_err(got0, _jax_engine(case, 0)) <= PARITY
    np.testing.assert_allclose(got0[:, 0], mean, rtol=1e-14)
    got = fit_kernel.fit_moments_plain(*_t(case), dimension=2, order=4,
                                       weighting=weighting).numpy()
    np.testing.assert_allclose(got[:, 0], mean, rtol=1e-14)
    assert (got[:, 1:] == 0).all()


def test_plain_matches_interpreted_tpu_kernel():
    rng = np.random.default_rng(11)
    B, K, order = 256, 24, 2
    case = cloud(rng, B, K, 2, orders=(order,), weightings=(defs.WEIGHT_CENTER,),
                 radius=(0.01, 1.0))
    case["xk"][:2] = np.where(np.isnan(case["xk"][:2]), np.nan,
                              case["xi"][:2, None, :])   # two h² = 0 cases
    ref = np.asarray(fit_pallas(
        *(jnp.asarray(case[k]) for k in ("xk", "fk", "nk", "xi")), dimension=2,
        order=order, weighting=defs.WEIGHT_CENTER, interpret=True, tile_s=2,
        refine_steps=2, assembly="moments"))
    got = fit_kernel.fit_moments_plain(*_t(case), dimension=2, order=order,
                                       weighting=defs.WEIGHT_CENTER).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-6


@pytest.mark.parametrize("dim,order,K", [
    pytest.param(1, 4, 12, id="1-4"), pytest.param(3, 2, 56, id="3-2"),
    pytest.param(3, 4, 56, id="3-4"),
    # the smoke's dim1 path (1D order 4, K = 15) and dim3_thread path (3D
    # order 2, K = 48): the moment kernel's 1D and 3D thread-body instances
    pytest.param(1, 4, 15, id="1-4-K15"), pytest.param(3, 2, 48, id="3-2-K48")])
def test_plain_covers_other_dimensions(dim, order, K):
    rng = np.random.default_rng(dim + order + (K if K in (15, 48) else 0))
    case = cloud(rng, 128, K, dim, orders=(order,), weightings=(1, 2),
                 radius=(0.3, 1.0))
    B = 128
    NO = defs.number_of_dofs(dim, order)
    ref, *_ = jengine.fit_batch(
        *(jnp.asarray(case[k]) for k in ("xk", "fk", "nk", "xi")),
        jnp.zeros((B, NO)), jnp.full((B,), order, jnp.int32),
        jnp.zeros((B,), jnp.int64), jnp.asarray(case["weighting"]),
        dimension=dim, NO=NO)
    for wm in (1, 2):
        sel = case["weighting"] == wm
        sub = {k: case[k][sel] for k in ("xk", "fk", "nk", "xi")}
        got = fit_kernel.fit_moments_plain(*_t(sub), dimension=dim, order=order,
                                           weighting=wm).numpy()
        assert rel_err(got, np.asarray(ref)[sel]) <= PARITY


def test_fit_kernel_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(12)
    case = cloud(rng, 64, 30, 2)
    before = fit_kernel.LAUNCHES
    a = fit_kernel.fit_kernel(*_t(case), dimension=2, order=4,
                              weighting=defs.WEIGHT_CENTER)
    b = fit_kernel.fit_moments_plain(*_t(case), dimension=2, order=4,
                                     weighting=defs.WEIGHT_CENTER)
    assert torch.equal(a, b)
    assert fit_kernel.LAUNCHES == before


def test_refine_steps_converge():
    """More sweeps move the answer toward the engine, never away."""
    rng = np.random.default_rng(13)
    case = cloud(rng, 256, 30, 2, radius=(0.01, 1.0))
    ref = _jax_engine(case, 4)
    errs = [rel_err(fit_kernel.fit_moments_plain(
        *_t(case), dimension=2, order=4, weighting=defs.WEIGHT_CENTER,
        refine_steps=r).numpy(), ref) for r in (0, 1, 2)]
    assert errs[1] <= PARITY and errs[2] <= PARITY
    assert errs[1] <= errs[0] * 1.5


def test_supported_predicate():
    """The kernel's coverage is the TPU moment body's: dims 1-3, orders 0-4,
    one order, knowns mask and weighting (UNIFORM or CENTER), the basic
    algorithm and ALGO_ITERATIVE; sensitivities need the rows kernel."""
    S = fit_kernel.supported
    assert S(2, 4, 0, defs.WEIGHT_CENTER)
    assert S(2, np.full(4, 0), np.zeros(4), np.full(4, defs.WEIGHT_UNIFORM))
    assert S(3, 4, 0, defs.WEIGHT_CENTER)
    assert S(1, 2, 0, defs.WEIGHT_CENTER)
    assert S(2, 2, defs.b2_F, 1)
    assert S(3, 4, 1 << 34, 2)
    assert not S(4, 2, 0, 1)
    assert not S(2, 5, 0, 1)
    assert not S(2, np.array([2, 3]), 0, 1)
    assert not S(2, 2, np.array([0, 1]), 1)
    assert not S(2, 2, 0, np.array([1, 2]))
    assert not S(2, 2, 0, 3)
    assert not S(2, 2, 0, 1, do_sens=True)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_route_predicates_are_the_jax_packages(dim):
    """auto_ok and cert_ok equal pallas_fit.moment_auto_ok and
    moment_cert_ok wherever the TPU's VMEM term does not bind (this
    kernel takes any K)."""
    checked = 0
    for order in range(5):
        for K in (8, 16, 30, 48, 64):
            if not pallas_fit.moment_vmem_ok(dim, order, K):
                continue
            assert fit_kernel.auto_ok(dim, order) == pallas_fit.moment_auto_ok(dim, order, K)
            assert fit_kernel.cert_ok(dim, order) == pallas_fit.moment_cert_ok(dim, order, K)
            checked += 1
    assert checked >= 20
    assert fit_kernel.MOMENT_AUTO_NM == pallas_fit.MOMENT_AUTO_NM


def _knowns_cases(NO):
    """knowns masks: none, the value, and the highest DOF (a higher bit)."""
    return sorted({0, 1, 1 << (NO - 1)})


def _grid_case(dim, order, B=96, K=None):
    """A ragged bench-like cloud in ``dim`` dimensions (1D at nk >= 2 NO,
    where its order 4 is conditioned inside 1e-10) with random fi_init."""
    import iterative_counts

    seed = 77 + 10 * dim + order
    if K is None:
        K = {1: 16, 2: 30, 3: 56}[dim]
    else:
        seed += 1000 * K
    xk, fk, nk, xi, fi0, _ = iterative_counts.cloud(dim, order, B, K, seed)
    return xk, fk, nk, xi, fi0


@pytest.mark.parametrize("dim,order,K", [
    *(pytest.param(d, o, None, id="%d-%d" % (d, o)) for o in range(5) for d in (1, 2, 3)),
    # the smoke's dim1 path (1D order 4, K = 15) and dim3_thread path (3D
    # order 2, K = 48): the moment kernel's 1D and 3D thread-body instances
    pytest.param(1, 4, 15, id="1-4-K15"), pytest.param(3, 2, 48, id="3-2-K48")])
def test_plain_with_knowns_and_iterative_matches_jax_engine(dim, order, K):
    """The plain version against the JAX f64 engine on dims 1-3 x orders 0-4
    x knowns {0, the value, the highest DOF}, basic and max_iter = 3, both
    weightings: 1e-10 relative to max(|ref|, 1); the known DOFs are
    fi_init's bits; the counts are per-case integers in [0, 3].  On the
    smoke's dim1 configuration (which runs max_iter = 3) the counts, pooled
    over knowns and weightings, are also held to the JAX engine's by
    tests/iterative_counts.py's tally: >= 50% equal and >= 80% within one
    (the dim3_thread path runs the basic fit; its counts lean as C6 says,
    0.39 equal, 0.81 within one here)."""
    import iterative_counts

    xk, fk, nk, xi, fi0 = _grid_case(dim, order, K=K)
    B, NO = fi0.shape
    got, want = [], []
    for kn in _knowns_cases(NO):
        for mi in (0, 3):
            for w in (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER):
                ref, _, it_ref, _ = jengine.fit_batch(
                    *(jnp.asarray(a) for a in (xk, fk, nk, xi, fi0)),
                    jnp.full((B,), order, jnp.int32), jnp.full((B,), kn, jnp.int64),
                    jnp.full((B,), w, jnp.int32), dimension=dim, NO=NO,
                    iterative=mi > 0, max_iter=mi, precision="f64")
                out = fit_kernel.fit_moments_plain(
                    *(torch.as_tensor(a) for a in (xk, fk, nk, xi, fi0)), dimension=dim,
                    order=order, weighting=w, knowns=kn, max_iter=mi)
                fi = (out[0] if mi else out).numpy()
                assert rel_err(fi, np.asarray(ref)) <= PARITY, (kn, mi, w)
                KN = fit_kernel.known_dofs(kn, dim, order)
                np.testing.assert_array_equal(fi[:, KN], fi0[:, KN])
                if mi:
                    it = out[1].numpy()
                    assert out[1].dtype == torch.int32 and it.min() >= 0 and it.max() <= mi
                    got.append(it)
                    want.append(np.asarray(it_ref))
    if K is not None and dim == 1:
        equal, within, _ = iterative_counts.shares(got, want)
        assert equal >= 0.5 and within >= 0.8, (equal, within)


def test_plain_iterative_counts_against_the_jax_engines():
    """ALGO_ITERATIVE counts of the moment body against the JAX f64 engine's
    stored counts, on the seeded clouds of tests/iterative_counts.py (the
    first 256 cases of each grid configuration, knowns masks and initial
    DOFs included), pooled: at least half equal (ROADMAP C2's bar), and at
    least 88% within one, under C2's 90%: measured 0.889 here.  The DOFs
    hold 1e-10 of the rows body's.

    Why the bar is under C2's, witnessed here: the moment body's corrective
    refit is a refinement step on the moment store (pallas_fit.py
    l.817-885), and its counts are bimodal.  It gives 2 on 5.1% of the
    cases where the engine gives 2 on 25.7% (asserted: under half the
    engine's share), so where the engine settles after two trips it
    stops after one or runs all three, and the misses go both ways (584
    cases at 1 where the engine gives 3, 265 at 3 where it gives 1).  Its
    one-trip stops are mostly exact fixed points of the sweep: on 68% of
    them the first refit leaves fi's bits unchanged (asserted: >= 60%).
    Which end a case takes follows the size of the system: one trip on
    59-100% of the cases with NO <= 4, three on 81-89% at 2D order 4, more
    than the engine's 63-73% there (asserted), which is the iterative
    path's configuration (97.6% three trips on the card).

    The rows body does not share that shape on these cases (asserted): it
    gives 2 on 22.3% (engine 25.7%), its one-trip stops are exact fixed
    points on 29% (the moment body's 68%), and it holds 0.908 within one.
    So the lean is the moment body's, not these clouds'; that it is the
    moment design's and not the port's is
    test_the_count_lean_is_the_jax_moment_kernels'."""
    import iterative_counts

    from wlsqm_tpu_torch.ops import fit_rows

    stored = iterative_counts.load()
    got, ref, fixed, o4, rows, fixed_r = [], [], [], [], [], []
    n = 256
    for key, dim, order, w, B, Kc, seed in iterative_counts.configs():
        if not key.startswith("grid_"):
            continue
        xk, fk, nk, xi, fi0, kn = iterative_counts.cloud(dim, order, B, Kc, seed)
        t = [torch.as_tensor(a[:n]) for a in (xk, fk, nk, xi, fi0)]
        kw = dict(dimension=dim, order=order, weighting=w, knowns=kn)
        fi, it = fit_kernel.fit_moments_plain(*t, max_iter=iterative_counts.MAX_ITER, **kw)
        fi_r, it_r, _ = fit_rows.fit_rows_plain(*t, max_iter=iterative_counts.MAX_ITER, **kw)
        assert rel_err(fi.numpy(), fi_r.numpy()) <= PARITY, key
        f0 = fit_kernel.fit_moments_plain(*t, **kw)
        f1, _ = fit_kernel.fit_moments_plain(*t, max_iter=1, **kw)
        fixed.append((f0.view(torch.int64) == f1.view(torch.int64)).all(1).numpy())
        r0 = fit_rows.fit_rows_plain(*t, **kw)[0]
        r1 = fit_rows.fit_rows_plain(*t, max_iter=1, **kw)[0]
        fixed_r.append((r0.view(torch.int64) == r1.view(torch.int64)).all(1).numpy())
        rows.append(it_r.numpy())
        got.append(it.numpy())
        ref.append(stored[key][:n])
        if (dim, order) == (2, 4):
            o4.append((float((got[-1] == 3).mean()), float((ref[-1] == 3).mean())))
    equal, within, _ = iterative_counts.shares(got, ref)
    assert equal >= 0.5 and within >= 0.88, (equal, within)
    g, r, f = (np.concatenate(a) for a in (got, ref, fixed))
    assert float((g == 1).mean()) > float((r == 1).mean())
    assert float((g == 2).mean()) < 0.5 * float((r == 2).mean())
    assert float(f[g == 1].mean()) >= 0.6
    assert all(mine > theirs for mine, theirs in o4), o4
    gr, fr = np.concatenate(rows), np.concatenate(fixed_r)
    assert iterative_counts.shares(rows, ref)[1] >= 0.9
    assert float((gr == 2).mean()) > 0.75 * float((r == 2).mean())
    assert float(fr[gr == 1].mean()) < 0.5 * float(f[g == 1].mean())


#: grid configurations of tests/iterative_counts.py where the f64 engine stops
#: after two trips on more than half of the cases (CENTER, orders 1-2)
C6_WITNESS = ("grid_d1_o1_w2", "grid_d1_o2_w2", "grid_d2_o1_w2")


def test_the_count_lean_is_the_jax_moment_kernels():
    """ROADMAP C6 on the stored clouds: the moment body's bimodal counts
    are the moment design's, which the JAX package's moment kernel shares.
    Witness: that kernel (``fit_pallas(assembly="moments")``, run
    interpreted on the CPU; here a witness of its counts, not an oracle of
    its values) on the first 1,024 cases of each C6_WITNESS cloud, pooled:
    it gives 2 on 5.8% of the cases where the f64 engine gives 2 on 54.0%
    and the port's moment body on 8.3% (asserted: both under a quarter of
    the engine's share), the port's rows body on 44.4% (asserted: over
    three quarters); within one of the engine the JAX moment kernel holds
    0.807, the port's moment body 0.826 and its rows body 0.897 (asserted:
    the port's moment body no lower than the JAX kernel's share less three
    binomial standard deviations)."""
    import iterative_counts

    from wlsqm_tpu.ops import pallas_fit
    from wlsqm_tpu_torch.ops import fit_rows

    stored = iterative_counts.load()
    cfg = {c[0]: c for c in iterative_counts.configs()}
    n = 1024
    got = {"jax": [], "moments": [], "rows": [], "engine": []}
    for key in C6_WITNESS:
        _, dim, order, w, B, Kc, seed = cfg[key]
        arrs = [a[:n] for a in iterative_counts.cloud(dim, order, B, Kc, seed)[:5]]
        kn = iterative_counts.cloud(dim, order, B, Kc, seed)[5]
        kw = dict(dimension=dim, order=order, weighting=w, knowns=kn,
                  max_iter=iterative_counts.MAX_ITER)
        out = pallas_fit.fit_pallas(*(jnp.asarray(a) for a in arrs), interpret=True,
                                    assembly="moments", **kw)
        t = [torch.as_tensor(a) for a in arrs]
        got["jax"].append(np.asarray(out[1]))
        got["moments"].append(fit_kernel.fit_moments_plain(*t, **kw)[1].numpy())
        got["rows"].append(fit_rows.fit_rows_plain(*t, **kw)[1].numpy())
        got["engine"].append(stored[key][:n])
    c = {k: np.concatenate(v) for k, v in got.items()}
    two = {k: float((v == 2).mean()) for k, v in c.items()}
    pm1 = {k: float((np.abs(v - c["engine"]) <= 1).mean()) for k, v in c.items()}
    assert two["jax"] < 0.25 * two["engine"] and two["moments"] < 0.25 * two["engine"], two
    assert two["rows"] > 0.75 * two["engine"], two
    sigma = (pm1["jax"] * (1 - pm1["jax"]) / len(c["engine"])) ** 0.5
    assert pm1["moments"] >= pm1["jax"] - 3 * sigma, pm1


#: the JAX moment kernel's within-one share against the f64 engine on the TPU
#: (benchmarks/r5_iter_moment.json ``moments_count_agree_pm1``, 2,048 cases)
R5_MOMENT_PM1 = 0.986


@functools.cache
def _r5_cases():
    """The configuration of benchmarks/run_r5_iter_moment.py (2D, order 4,
    K = 30, WEIGHT_CENTER, xi = 0, xk uniform in [-1, 1]^2, fk = sin(3x)
    cos(2y) + 0.01 N(0, 1), max_iter 3) on two seeded NumPy batches of
    1,024, with the JAX f64 engine's counts."""
    out = []
    for seed in (5, 6):
        rng = np.random.default_rng(seed)
        B, K = 1024, 30
        xk = rng.uniform(-1, 1, (B, K, 2))
        fk = np.sin(3 * xk[..., 0]) * np.cos(2 * xk[..., -1]) + 0.01 * rng.standard_normal((B, K))
        nk, xi = np.full(B, K, np.int32), np.zeros((B, 2))
        _, _, it, _ = jengine.fit_batch(
            *(jnp.asarray(a) for a in (xk, fk, nk, xi)), jnp.zeros((B, 15)),
            jnp.full((B,), 4, jnp.int32), jnp.zeros((B,), jnp.int64),
            jnp.full((B,), defs.WEIGHT_CENTER, jnp.int32), dimension=2, NO=15,
            iterative=True, max_iter=3, precision="f64")
        out.append(([torch.as_tensor(a) for a in (xk, fk, nk, xi)], np.asarray(it)))
    return out


@pytest.mark.parametrize("refine_steps", [1, 2])
def test_iterative_counts_on_the_reference_configuration(refine_steps):
    """ROADMAP C6, measured: on the configuration where the JAX moment
    kernel agreed within one with the f64 engine on 98.6% of 2,048 cases
    (on the TPU, refine_steps 2), the port's plain moment body agrees on
    98.1% (refine_steps 1, the port's default) and 98.3% (2) of 2,048, and
    the rows body on 97.5% and 97.3%: within three binomial standard
    deviations of the reference's share (0.0078 at 2,048 cases): here the
    port's moment body is where the reference's kernel is, and the second
    sweep buys nothing worth a change of K1's bits (the lean on the stored
    clouds is the moment design's: test_the_count_lean_is_the_jax_moment_kernels).  Asserted: the moment
    body within 3 sigma of 0.986 at both settings, the rows body at 0.97."""
    from wlsqm_tpu_torch.ops import fit_rows

    kw = dict(dimension=2, order=4, weighting=defs.WEIGHT_CENTER, max_iter=3,
              refine_steps=refine_steps)
    shares = {}
    for name, fn in (("moments", fit_kernel.fit_moments_plain),
                     ("rows", fit_rows.fit_rows_plain)):
        within = [np.abs(fn(*t, **kw)[1].numpy() - it) <= 1 for t, it in _r5_cases()]
        shares[name] = float(np.concatenate(within).mean())
    n = sum(len(it) for _, it in _r5_cases())
    sigma = (R5_MOMENT_PM1 * (1 - R5_MOMENT_PM1) / n) ** 0.5
    assert shares["moments"] >= R5_MOMENT_PM1 - 3 * sigma, shares
    assert shares["rows"] >= 0.97, shares


def test_fit_kernel_outputs_in_fit_pallas_order():
    """fi alone; (fi, iters) with max_iter; the key last with emit_cond."""
    xk, fk, nk, xi, fi0 = _grid_case(2, 2, B=32)
    t = [torch.as_tensor(a) for a in (xk, fk, nk, xi, fi0)]
    kw = dict(dimension=2, order=2, weighting=defs.WEIGHT_CENTER, knowns=1)
    fi = fit_kernel.fit_kernel(*t, **kw)
    fi2, it = fit_kernel.fit_kernel(*t, max_iter=2, **kw)
    fi3, it3, key = fit_kernel.fit_kernel(*t, max_iter=2, emit_cond=True, **kw)
    fi4, key4 = fit_kernel.fit_kernel(*t, emit_cond=True, **kw)
    assert fi.shape == (32, 6) and it.shape == (32,) and key.shape == (32,)
    assert torch.equal(fi2, fi3) and torch.equal(it, it3) and torch.equal(fi, fi4)
    assert torch.equal(key, key4)
    np.testing.assert_array_equal(fi[:, 0].numpy(), fi0[:, 0])


# ---------------------------------------------------------------------------
# The conditioning key (emit_cond)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighting", [defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_plain_key_is_the_library_key(order, weighting):
    """The plain version's key, from its own factor, against cond_key (batched
    library calls): 1e-8 relative, both float64 (the key's own sensitivity is
    ~cond * 2^-53); fi is the same bits with and without the key."""
    from wlsqm_tpu_torch.fitter import condprobe

    rng = np.random.default_rng(20 + 10 * order + weighting)
    case = cloud(rng, 256, 30, 2, orders=(order,), weightings=(weighting,),
                 radius=(0.05, 1.0))
    kw = dict(dimension=2, order=order, weighting=weighting)
    fi, key = fit_kernel.fit_kernel(*_t(case), emit_cond=True, **kw)
    assert torch.equal(fi, fit_kernel.fit_kernel(*_t(case), **kw))
    assert key.shape == (256,) and key.dtype == torch.float64
    ref = condprobe.cond_key(case["xk"], case["nk"], case["xi"], device="cpu", **kw)
    torch.testing.assert_close(key, ref, rtol=1e-8, atol=0)
    assert bool((key >= 1.0).all())              # cond_2 >= 1, amp >= 1


def test_plain_key_folds_in_the_radius_amplification():
    """key = (the scale-free key) * max(inv_s, 1)^order: shrinking a cloud by
    2^-3 multiplies an order-4 key by 2^12, growing it leaves the key alone."""
    rng = np.random.default_rng(31)
    case = cloud(rng, 64, 30, 2, radius=(0.5, 0.6), ragged=False)
    kw = dict(dimension=2, order=4, weighting=defs.WEIGHT_CENTER, emit_cond=True)
    xk, fk, nk, xi = _t(case)
    _, key = fit_kernel.fit_kernel(xk, fk, nk, xi, **kw)
    _, small = fit_kernel.fit_kernel(xi[:, None, :] + (xk - xi[:, None, :]) / 8, fk, nk, xi,
                                     **kw)
    _, large = fit_kernel.fit_kernel(xi[:, None, :] + (xk - xi[:, None, :]) * 8, fk, nk, xi,
                                     **kw)
    torch.testing.assert_close(small, key * 2.0 ** 12, rtol=1e-9, atol=0)
    torch.testing.assert_close(large, key, rtol=1e-9, atol=0)


def test_plain_key_matches_interpreted_tpu_kernel_key():
    """The key the interpreted Pallas moment kernel emits (f32 inside, as
    tests/test_split.py runs it) against the plain version's: 5e-2 relative."""
    rng = np.random.default_rng(32)
    B, K, order = 256, 24, 2
    case = cloud(rng, B, K, 2, orders=(order,), weightings=(defs.WEIGHT_CENTER,),
                 radius=(0.1, 1.0))
    _, ref = fit_pallas(
        *(jnp.asarray(case[k]) for k in ("xk", "fk", "nk", "xi")), dimension=2,
        order=order, weighting=defs.WEIGHT_CENTER, interpret=True, tile_s=2,
        refine_steps=2, assembly="moments", emit_cond=True)
    _, key = fit_kernel.fit_moments_plain(*_t(case), dimension=2, order=order,
                                          weighting=defs.WEIGHT_CENTER, emit_cond=True)
    rel = np.abs(key.numpy() - np.asarray(ref)) / key.numpy()
    assert rel.max() <= 5e-2 and np.median(rel) <= 2e-3


def _c3_sweep(radii=(0.03, 0.1, 0.3, 1.0), B=512):
    """3D order 4 through the plain moment chains against the JAX f64
    engine, K = 48, CENTER, one radius per batch: per-case error (relative
    to max(|ref|, 1)) and the engine's cond·amp (its scaled condition number
    times the radius amplification max(inv_s, 1)^4).  Returns (errors,
    cond·amp) over all radii.  By hand:

        python -c "import sys; sys.path.insert(0, 'tests'); import test_torch_fit_kernel as t; print(t._c3_summary())"
    """
    NO = defs.number_of_dofs(3, 4)
    errs, cas = [], []
    for r in radii:
        case = cloud(np.random.default_rng(int(r * 1000)), B, 48, 3, radius=(r, r))
        t = _t(case)
        got = fit_kernel.fit_moments_plain(*t, dimension=3, order=4,
                                           weighting=defs.WEIGHT_CENTER).numpy()
        ref, _, _, cond = jengine.fit_batch(
            *(jnp.asarray(case[k]) for k in ("xk", "fk", "nk", "xi")),
            jnp.zeros((B, NO)), jnp.full((B,), 4, jnp.int32), jnp.zeros((B,), jnp.int64),
            jnp.full((B,), defs.WEIGHT_CENTER, jnp.int32), dimension=3, NO=NO, debug=True)
        ref = np.asarray(ref)
        assert np.isfinite(got).all()
        inv_s = fit_kernel._prescale(t[0], t[2], t[3])[3].numpy()
        errs.append(np.abs(got - ref).max(1) / np.maximum(np.abs(ref).max(1), 1.0))
        cas.append(np.asarray(cond) * np.maximum(inv_s, 1.0) ** 4)
    return np.concatenate(errs), np.concatenate(cas)


def _moment_edge():
    """The moment body's cond·amp edge of the shipped H100 record."""
    return condprobe.AUTO_TOL / (condprobe.SAFETY * calibration._H100["f64_cert_unit_m"])


def _c3_summary(radii=(0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0), B=1024):
    err, ca = _c3_sweep(radii, B)
    under = ca < _moment_edge()
    over = err > PARITY
    return {"cases": len(err), "under_edge": int(under.sum()),
            "worst_under_edge": float(err[under].max()), "worst": float(err.max()),
            "max_cond_amp": float(ca.max()),
            "first_break_cond_amp": float(ca[over].min()) if over.any() else None}


def test_3d_order4_moment_chains_hold_parity_in_f64():
    """3D order 4 (NO = 35, moments to degree 8) through the plain moment
    chains against the JAX f64 engine over a radius sweep like
    chip_smoke.phase_radius_sweep: held to PARITY on every case whose
    engine cond·amp is under the moment body's cond·amp edge of the shipped
    H100 record.  In the JAX package's f32 pairs these chains broke its
    certification envelope (docs/kernel.md:261-273); in f64 the sweep found
    no break, under the edge or far past it (ROADMAP B7)."""
    err, ca = _c3_sweep()
    under = ca < _moment_edge()
    assert under.sum() >= 200
    assert err[under].max() <= PARITY


def _adversarial_h2(B=3 * 64, K=30, seed=4):
    """Neighbourhoods whose h² is an exact power of four, one ulp of the
    coordinate either side of it (where ceil(0.5 log2) and an exact frexp
    rule part), plus nk = 0 and NaN padding."""
    rng = np.random.default_rng(seed)
    h = np.ldexp(1.0, np.arange(B) % 64 - 32)
    step = np.repeat([-1.0, 0.0, 1.0], 64)[:B]
    xk = rng.uniform(-1e-3, 1e-3, (B, K, 2)) * h[:, None, None]
    xk[:, 0, 0] = np.nextafter(h, h + step)
    xk[:, 0, 1] = 0.0
    nk = rng.integers(1, K + 1, B).astype(np.int32)
    nk[:16] = 0
    xk[np.arange(K)[None, :] >= nk[:, None]] = np.nan
    return torch.as_tensor(xk), torch.as_tensor(nk), torch.zeros((B, 2), dtype=torch.float64)


def test_case_exponent_is_prescale_bit_for_bit():
    """The plain twin of the kernel's own scale gives _prescale's e_s bit for
    bit on the adversarial cases and on a ragged cloud."""
    xk, nk, xi = _adversarial_h2()
    case = cloud(np.random.default_rng(5), 512, 30, 2, radius=(1e-3, 1e3))
    for x, n, o in ((xk, nk, xi), (_t(case)[0], _t(case)[2], _t(case)[3])):
        e_ref = fit_kernel._prescale(x, n, o)[2]
        e = fit_kernel._case_exponent(x, n, o)
        assert torch.equal(e.view(torch.int64), e_ref.view(torch.int64))
    # some cases one ulp above a power of four keep the exponent, s² < h²
    # (an exact frexp rule would round them up): the kernel follows _prescale
    delta, _, e_adv, _ = fit_kernel._prescale(xk, nk, xi)
    h2 = (delta * delta).sum(-1).amax(-1)
    assert bool((torch.ldexp(torch.ones_like(e_adv), (2 * e_adv).long()) < h2).any())


def test_store_descale_is_the_wrapper_descale_bit_for_bit():
    """(y s) * ldexp(fact, -e deg), the kernel's de-scale in its stores,
    equals out * _dof_scale(e) bit for bit: every factor is exact."""
    rng = np.random.default_rng(6)
    for order in range(defs.MAX_ORDER + 1):
        NO = defs.number_of_dofs(2, order)
        e = torch.as_tensor(rng.integers(-60, 60, 1024).astype(np.float64))
        ys = torch.as_tensor(rng.standard_normal((1024, NO)) * 10.0 ** rng.integers(-8, 8, (1024, 1)))
        a = ys * fit_kernel._store_scale(e, 2, order)
        b = ys * fit_kernel._dof_scale(e, 2, order)
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("order", [3, 4])
def test_warp_triangle_table_is_the_moment_slots(order):
    """The warp body's generated ``tri_at`` table: one entry per packed lower
    entry (i, m), m <= i, in packed order, naming its row, its column and
    the lattice index of the moment e_i + e_m (moment_lattice); the slot
    table it reads in the sweep is symmetric (it reads slot(m, j) for
    A[j, m]); the header carries the same values."""
    import re

    from wlsqm_tpu_torch.fitter import tables

    NO = defs.number_of_dofs(3, order)
    exp = tables.EXPONENTS[3][:NO]
    _, _, index = fit_kernel.moment_lattice(3, 2 * order)
    tri = fit_kernel.warp_triangle(3, order)
    assert len(tri) == NO * (NO + 1) // 2
    for idx, v in enumerate(tri):
        i, m, slot = v & 0xFF, (v >> 8) & 0xFF, v >> 16
        assert m <= i < NO and idx == i * (i + 1) // 2 + m
        assert slot == index[tuple(int(a) for a in exp[i] + exp[m])]
    slots = fit_kernel.moment_slots(3, order)
    assert np.array_equal(slots, slots.T)
    header = fit_kernel.tables_header()
    block = header[header.index("struct MomentTables<3, %d>" % order):]
    body = re.search(r"unsigned tri_at\(int i\) \{\s*static const unsigned v\[\] = \{([^}]*)\}",
                     block)
    assert [int(t) for t in body.group(1).split(",")] == tri


def test_warp_body_pair_rows_and_product_map():
    """The warp body's assembly forms the fragment of product row p from the
    ladder rows ``pab_at(p)`` names, a | b << 4 for the p-th (x, y) pair of
    the 3D lattice by degree (the rows the moment product's map was made
    for); the tiles pad the pairs to NPP, a multiple of 8, with (0, 0), and
    the map drops those rows and the columns past 3 ORDER + 1, and past the
    first TJ1 row tiles every product of columns 8-15 (which the kernel does
    not form); the header carries the same values."""
    import re

    header = fit_kernel.tables_header()
    for order in (3, 4):
        block = header[header.index("struct MomentTables<3, %d>" % order):]
        npp = int(re.search(r"NPP = (\d+);", block).group(1))
        pairs = fit_kernel._warp_pairs(order)
        rows = fit_kernel._warp_pair_rows(order)
        assert len(rows) == npp and npp % 8 == 0 and 0 <= npp - len(pairs) < 8
        assert [(v & 15, v >> 4) for v in rows[:len(pairs)]] == pairs
        assert all(v == 0 for v in rows[len(pairs):])
        assert sorted(pairs) == sorted((a, b) for a in range(2 * order + 1)
                                       for b in range(2 * order + 1) if a + b <= 2 * order)
        pmap = fit_kernel._warp_product_map(order)
        assert all(pmap[p * 16 + c] == 255 for p in range(len(pairs), npp) for c in range(16))
        assert all(pmap[p * 16 + c] == 255 for p in range(npp)
                   for c in range(3 * order + 2, 16))
        tj1 = int(re.search(r"TJ1 = (\d+);", block).group(1))
        assert tj1 == fit_kernel._warp_rhs_tiles(order) == 2
        assert all(pmap[p * 16 + c] == 255 for p in range(8 * tj1, npp) for c in range(8, 16))
        assert all(a + b > order for a, b in pairs[8 * tj1:])
        body = re.search(r"int pab_at\(int i\) \{\s*static const unsigned char v\[\] = "
                         r"\{([^}]*)\}", block)
        assert [int(t) for t in body.group(1).split(",")] == rows
