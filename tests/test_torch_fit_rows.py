"""The rows-body kernel's plain version and its route, on the CPU.

Held to the JAX f64 engine (``wlsqm_tpu.fitter.engine.fit_batch``) and the
JAX f64 route (``wlsqm_tpu.fit_many(backend="xla", precision="f64")``) on
the same NumPy inputs.  Tolerance: 1e-10 relative to max(|ref|, 1) per case,
the repo's parity bar, for fi and sens; the two solve the same system by
different f64 arithmetic (Jacobi-scaled Cholesky plus one sweep through the
rows here, Ruiz-scaled Cholesky there), which differ by ~cond · eps.  NaN
must sit in the same places (known sens columns).

ALGO_ITERATIVE stops on EXACT l∞-norm stagnation, so its counts are decided
by last-bit ties and two f64 implementations agree only by chance on each
case: per configuration they agree on 34-100% of cases and within one
iteration on 78-100% (measured on these clouds), pooled over the grid on
58-65% and 93-94%.  The bound is the engine port's roundoff bound
(tests/test_torch_engine.py), ≥ 50% equal and ≥ 90% within one, held pooled
over the grid.

The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wlsqm_tpu as wt
import wlsqm_tpu_torch as wtt
from torch_port_cases import cloud, rel_err, roomy_units
from wlsqm_tpu.fitter import engine as jengine
from wlsqm_tpu_torch.fitter import defs, engine, tables
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

torch.set_num_threads(1)

PARITY = 1e-10
K_BY_DIM = {1: 12, 2: 30, 3: 56}
RADIUS = (0.05, 1.0)
CPU = "cpu"


def _t(case, keys=("xk", "fk", "nk", "xi", "fi0")):
    return [torch.as_tensor(case[k]) for k in keys]


def _jax_engine(case, dim, order, knowns, weighting, **kw):
    B = len(case["nk"])
    NO = defs.number_of_dofs(dim, order)
    out = jengine.fit_batch(
        *(jnp.asarray(case[k]) for k in ("xk", "fk", "nk", "xi")),
        jnp.asarray(case["fi0"][:, :NO]), jnp.full((B,), order, jnp.int32),
        jnp.full((B,), knowns, jnp.int64), jnp.full((B,), weighting, jnp.int32),
        dimension=dim, NO=NO, **kw)
    return [np.asarray(a) for a in out]


def _case(dim, order, weighting, seed, B=128):
    rng = np.random.default_rng(seed)
    case = cloud(rng, B, K_BY_DIM[dim], dim, orders=(order,),
                 weightings=(weighting,), radius=RADIUS)
    knowns = int(rng.integers(0, 1 << defs.number_of_dofs(dim, order)))
    return case, knowns


@pytest.mark.parametrize("weighting", [defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_plain_matches_jax_engine(dim, order, weighting):
    """fi and sens, without knowns and with a random knowns mask."""
    case, kn = _case(dim, order, weighting, seed=100 * dim + 10 * order + weighting)
    for knowns in (0, kn):
        fi, iters, sens = fit_rows.fit_rows_plain(
            *_t(case), dimension=dim, order=order, weighting=weighting,
            knowns=knowns, do_sens=True)
        jfi, jsens, _, _ = _jax_engine(case, dim, order, knowns, weighting,
                                       do_sens=True)
        assert rel_err(fi.numpy(), jfi) <= PARITY
        assert rel_err(sens.numpy(), jsens) <= PARITY     # NaN places included
        assert (iters == 0).all()
        KN = fit_rows.known_dofs(knowns, dim, order)
        np.testing.assert_array_equal(fi.numpy()[:, KN], case["fi0"][:, KN])


def test_plain_iterative_matches_jax_engine():
    """ALGO_ITERATIVE (max_iter 3, random knowns masks) over every dimension,
    order and weighting: fi per configuration, counts pooled (see above)."""
    equal = within_one = total = 0
    for dim in (1, 2, 3):
        for order in range(5):
            for wm in (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER):
                case, kn = _case(dim, order, wm, seed=7 + 100 * dim + 10 * order + wm)
                fi, iters, sens = fit_rows.fit_rows_plain(
                    *_t(case), dimension=dim, order=order, weighting=wm,
                    knowns=kn, max_iter=3)
                jfi, _, jit, _ = _jax_engine(case, dim, order, kn, wm,
                                             iterative=True, max_iter=3)
                assert rel_err(fi.numpy(), jfi) <= PARITY, (dim, order, wm)
                KN = fit_rows.known_dofs(kn, dim, order)
                np.testing.assert_array_equal(fi.numpy()[:, KN], case["fi0"][:, KN])
                it = iters.numpy()
                assert sens is None and it.min() >= 1 and it.max() <= 3
                equal += (it == jit).sum()
                within_one += (np.abs(it - jit) <= 1).sum()
                total += len(it)
    assert equal / total >= 0.5
    assert within_one / total >= 0.9


def test_basis_rows_are_the_engine_basis_without_factorials():
    rng = np.random.default_rng(5)
    for dim in (1, 2, 3):
        d = rng.uniform(-1, 1, (16, 7, dim))
        for order in range(5):
            NO = defs.number_of_dofs(dim, order)
            got = fit_rows.basis_rows(torch.as_tensor(d), dim, order)
            ref = engine.basis(torch.as_tensor(d), dim, NO)
            inv = torch.as_tensor(tables.INV_FACT[dim][:NO])
            assert torch.equal(got * inv, ref)
            assert np.array_equal(got.numpy() * tables.INV_FACT[dim][:NO],
                                  np.asarray(jengine.basis(jnp.asarray(d), dim, NO)))


def test_tables_header_holds_every_exponent():
    text = fit_rows.tables_header()
    for dim in (1, 2, 3):
        for order in range(5):
            NO = defs.number_of_dofs(dim, order)
            head = "template <> struct RowsTables<%d, %d> {" % (dim, order)
            block = text[text.index(head):].split("};")[0]
            assert "static constexpr int NO = %d;" % NO in block
            exp = tables.EXPONENTS[dim][:NO]
            for j in range(NO):
                for a in range(dim):
                    if exp[j, a]:
                        assert "case %d: return %d;" % (j * dim + a, exp[j, a]) in block


def test_sens_plan_routes_to_the_rows_kernel_and_matches_jax():
    """The slice's path: plan_fit_many(do_sens=True) -> fit_many(plan=)."""
    rng = np.random.default_rng(21)
    B, K = 512, 30
    xk = rng.uniform(-1.0, 1.0, (B, K, 2))
    fk = np.sin(3.0 * xk[..., 0]) * np.cos(2.0 * xk[..., 1]) + 0.01 * rng.standard_normal((B, K))
    xi = np.zeros((B, 2))
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER)
    plan = wtt.plan_fit_many(xk, xi, do_sens=True, device=CPU, **kw)
    r = plan.route
    assert (r.path, r.kernel_precision, r.assembly) == ("kernel", "f64", "rows")
    assert r.refine_steps == fit_rows.DEFAULT_REFINE_STEPS
    res = wtt.fit_many(xk, fk, xi, do_sens=True, plan=plan, device=CPU, **kw)
    ref = wt.fit_many(xk, fk, xi, backend="xla", precision="f64", do_sens=True, **kw)
    assert res.fi.shape == (B, 15) and res.sens.shape == (B, K, 15)
    assert rel_err(res.fi.numpy(), np.asarray(ref.fi)) <= PARITY
    assert rel_err(res.sens.numpy(), np.asarray(ref.sens)) <= PARITY
    assert (res.iterations == 0).all()


def test_dim3_and_iterative_plans_route_to_the_rows_kernel(monkeypatch):
    roomy_units(monkeypatch)      # routing by configuration: every case certifies
    rng = np.random.default_rng(22)
    case = cloud(rng, 64, 56, 3, orders=(4,), radius=(0.3, 1.0))
    plan = wtt.plan_fit_many(case["xk"], case["xi"], nk=case["nk"], order=4, weighting=2,
                             device=CPU)
    assert (plan.route.path, plan.route.assembly) == ("kernel", "rows")
    res = wtt.fit_many(case["xk"], case["fk"], case["xi"], nk=case["nk"], order=4,
                       weighting=2, plan=plan, device=CPU)
    ref = wt.fit_many(case["xk"], case["fk"], case["xi"], nk=case["nk"], order=4,
                      weighting=2, backend="xla", precision="f64")
    assert rel_err(res.fi.numpy(), np.asarray(ref.fi)) <= PARITY
    # ALGO_ITERATIVE in 2D: the moment kernel covers it, as in the JAX package
    xk2 = cloud(rng, 8, 30, 2, ragged=False)["xk"]
    it = wtt.plan_fit_many(xk2, None, order=4, iterative=True, device=CPU).route
    assert (it.path, it.assembly) == ("kernel", "moments")
    # below K >= 1.5 NO the plan keeps the engine, as in the JAX package
    short = wtt.plan_fit_many(case["xk"][:, :48], case["xi"], order=4, device=CPU)
    assert short.route.path == "xla"


def test_auto_batch_splits_between_the_kernels_and_the_engine(monkeypatch):
    """Per-case orders and knowns at K = 20: every group goes to the moment
    kernel, knowns included (to the rows kernel when sens are asked for),
    order 4 (K < 1.5 NO) to one engine call; the whole matches the JAX f64
    route, sens included.  Routing by configuration: the record certifies
    every case."""
    roomy_units(monkeypatch)
    calls = {"moments": 0, "rows": 0, "engine": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fit_kernel, "fit_kernel", spy("moments", fit_kernel.fit_kernel))
    monkeypatch.setattr(fit_rows, "fit_rows", spy("rows", fit_rows.fit_rows))
    monkeypatch.setattr(engine, "fit_batch", spy("engine", engine.fit_batch))
    rng = np.random.default_rng(23)
    case = cloud(rng, 384, 20, 2, orders=(2, 3, 4), weightings=(1, 2), radius=(0.3, 1.0))
    case["knowns"][::3] = wt.b2_F | wt.b2_Y
    args = (case["xk"], case["fk"], case["xi"])
    kw = dict(nk=case["nk"], order=case["order"], knowns=case["knowns"],
              weighting=case["weighting"], fi_init=case["fi0"])
    for do_sens in (False, True):
        res = wtt.fit_many(*args, do_sens=do_sens, device=CPU, **kw)
        ref = wt.fit_many(*args, backend="xla", precision="f64", do_sens=do_sens, **kw)
        assert rel_err(res.fi.numpy(), np.asarray(ref.fi)) <= PARITY
        if do_sens:
            assert rel_err(res.sens.numpy(), np.asarray(ref.sens)) <= PARITY
    # per call 2 weightings x orders {2, 3} x knowns {0, mask}: without sens
    # every group takes the moment kernel; with sens every group the rows
    assert calls == {"moments": 8, "rows": 8, "engine": 2}


def test_iterative_auto_counts_come_from_the_rows_kernel(monkeypatch):
    roomy_units(monkeypatch)          # routing by configuration, not by conditioning
    rng = np.random.default_rng(24)
    case = cloud(rng, 256, 30, 2, orders=(3,), weightings=(2,), radius=(0.3, 1.0))
    args = (case["xk"], case["fk"], case["xi"])
    kw = dict(nk=case["nk"], order=3, weighting=2, iterative=True, max_iter=4)
    res = wtt.fit_many(*args, device=CPU, **kw)
    # ALGO_ITERATIVE in 2D is the moment kernel's since it covers it, as in
    # the JAX package; the rows kernel is reached by a plan that names it
    direct = fit_kernel.fit_kernel(*_t(case, ("xk", "fk", "nk", "xi")), dimension=2,
                                   order=3, weighting=2, max_iter=4)
    assert torch.equal(res.fi, direct[0]) and torch.equal(res.iterations, direct[1])
    plan = wtt.plan_fit_many(case["xk"], case["xi"], nk=case["nk"], order=3, weighting=2,
                             iterative=True, device=CPU)
    rows = wtt.fit_many(*args, device=CPU, plan=dataclasses.replace(
        plan, route=dataclasses.replace(plan.route, assembly="rows")), **kw)
    rdirect = fit_rows.fit_rows(*_t(case, ("xk", "fk", "nk", "xi")), dimension=2,
                                order=3, weighting=2, max_iter=4)
    assert torch.equal(rows.fi, rdirect[0]) and torch.equal(rows.iterations, rdirect[1])
    ref = wt.fit_many(*args, backend="xla", precision="f64", **kw)
    assert rel_err(res.fi.numpy(), np.asarray(ref.fi)) <= PARITY
    assert 1 <= int(res.iterations.min()) and int(res.iterations.max()) <= 4


@pytest.mark.parametrize("knowns", [0, int(defs.b2_F)])
def test_diffable_gradient_matches_jax_engine_grad(knowns):
    """grad in fk through the sensitivities equals jax.grad of the JAX f64
    engine fit; xk, xi and fi_init get no gradient."""
    rng = np.random.default_rng(25 + knowns)
    B, K, order = 64, 20, 2
    NO = defs.number_of_dofs(2, order)
    xk = rng.uniform(-1.0, 1.0, (B, K, 2))
    fk = np.sin(1.1 * xk[..., 0]) * np.cos(0.9 * xk[..., 1])
    xi = rng.uniform(-0.1, 0.1, (B, 2))
    gi = np.zeros((B, NO))
    gi[:, 0] = 0.3
    nk = np.full(B, K, np.int32)
    wm = defs.WEIGHT_CENTER

    def loss_engine(f):
        fi = jengine.fit_batch(jnp.asarray(xk), f, jnp.asarray(nk), jnp.asarray(xi),
                               jnp.asarray(gi), jnp.full((B,), order, jnp.int32),
                               jnp.full((B,), knowns, jnp.int64),
                               jnp.full((B,), wm, jnp.int32), dimension=2, NO=NO,
                               precision="f64")[0]
        return (fi ** 2).sum()

    ge = np.asarray(jax.grad(loss_engine)(jnp.asarray(fk)))
    t = {k: torch.tensor(v, requires_grad=k != "nk") for k, v in
         dict(xk=xk, fk=fk, xi=xi, gi=gi, nk=nk).items()}
    fi = fit_rows.fit_rows_diffable(t["xk"], t["fk"], t["nk"], t["xi"], t["gi"],
                                    dimension=2, order=order, weighting=wm,
                                    knowns=knowns)
    (fi ** 2).sum().backward()
    scale = np.abs(ge).max()
    assert np.abs(t["fk"].grad.numpy() - ge).max() <= PARITY * scale
    assert t["xk"].grad is None and t["xi"].grad is None and t["gi"].grad is None
    if knowns:
        np.testing.assert_array_equal(fi.detach().numpy()[:, 0], gi[:, 0])
    with pytest.raises(ValueError):
        fit_rows.fit_rows_diffable(t["xk"], t["fk"], t["nk"], t["xi"], dimension=2,
                                   order=5, weighting=wm)


@pytest.mark.parametrize("weighting", [defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER])
def test_degenerate_neighborhood_is_guarded(weighting):
    """Every neighbour at xi: the pivot guard gives the weighted mean and
    zero derivatives, as the moment kernel does (the f64 engine gives NaN)."""
    rng = np.random.default_rng(26)
    case = cloud(rng, 8, 30, 2, orders=(0,), weightings=(weighting,))
    case["xk"][:] = np.where(np.isnan(case["xk"]), np.nan, case["xi"][:, None, :])
    mean = np.nanmean(case["fk"], axis=1)
    for order in (0, 4):
        fi, _, sens = fit_rows.fit_rows_plain(*_t(case), dimension=2, order=order,
                                              weighting=weighting, do_sens=True)
        np.testing.assert_allclose(fi.numpy()[:, 0], mean, rtol=1e-14)
        assert (fi.numpy()[:, 1:] == 0).all() and np.isfinite(sens.numpy()).all()


def test_fit_rows_on_cpu_runs_the_plain_version():
    case, kn = _case(2, 3, defs.WEIGHT_CENTER, seed=27, B=64)
    before = fit_rows.LAUNCHES
    kw = dict(dimension=2, order=3, weighting=defs.WEIGHT_CENTER, knowns=kn,
              do_sens=True, max_iter=2)
    a = fit_rows.fit_rows(*_t(case), **kw)
    b = fit_rows.fit_rows_plain(*_t(case), **kw)
    for x, y in zip(a, b):
        assert torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0))
    assert fit_rows.LAUNCHES == before


def test_launch_refuses_cpu_tensors():
    """The kernel's launcher checks its tensors before any build or launch."""
    case, _ = _case(2, 2, defs.WEIGHT_UNIFORM, seed=28, B=16)
    xk, fk, nk, xi, _ = _t(case)
    B, K, _ = xk.shape
    with pytest.raises(ValueError, match="CUDA device"):
        fit_rows._launch(xk, fk, nk.to(torch.int32), xi, xi[:, 0].clone(), None,
                         torch.empty(B, 6, dtype=torch.float64), None, None,
                         order=2, weighting=1, knowns=0, refine_steps=1, max_iter=0)
    with pytest.raises(ValueError, match="missing"):
        fit_rows._launch(xk, fk, nk.to(torch.int32), xi, xi[:, 0].clone(), None,
                         torch.empty(B, 6, dtype=torch.float64), None, None,
                         order=2, weighting=1, knowns=1, refine_steps=1, max_iter=0)


def test_supported_predicate():
    S = fit_rows.supported
    assert S(2, 4, 0, defs.WEIGHT_CENTER)
    assert S(3, 4, defs.b3_F | defs.b3_XYZ, defs.WEIGHT_UNIFORM)
    assert S(1, np.full(4, 0), np.full(4, 3), np.full(4, defs.WEIGHT_UNIFORM))
    assert not S(4, 2, 0, 1)
    assert not S(2, 5, 0, 1)
    assert not S(2, np.array([2, 3]), 0, 1)
    assert not S(2, 2, np.array([0, 1]), 1)
    assert not S(2, 2, 0, np.array([1, 2]))
    assert not S(2, 2, 0, 3)


# ---------------------------------------------------------------------------
# The conditioning key (emit_cond)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [1, 2, 3])
def test_plain_key_is_the_library_key(dim):
    """Every order, both weightings, a random knowns mask: the plain version's
    key against cond_key (batched library calls) to 1e-8 relative, the same
    for the basic fit, with sens and with ALGO_ITERATIVE, and every other
    output the same bits with and without the key."""
    from wlsqm_tpu_torch.fitter import condprobe

    for order in range(5):
        for wm in (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER):
            case, kn = _case(dim, order, wm, seed=300 + 100 * dim + 10 * order + wm, B=96)
            for knowns in (0, kn):
                kw = dict(dimension=dim, order=order, weighting=wm, knowns=knowns)
                ref = condprobe.cond_key(case["xk"], case["nk"], case["xi"], device=CPU, **kw)
                keys = []
                for extra in ({}, dict(do_sens=True), dict(max_iter=2)):
                    with_key = fit_rows.fit_rows(*_t(case), emit_cond=True, **kw, **extra)
                    without = fit_rows.fit_rows(*_t(case), **kw, **extra)
                    assert len(with_key) == 4 and len(without) == 3
                    for x, y in zip(with_key, without):
                        assert (x is None) == (y is None)
                        if x is not None:
                            assert torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0))
                    keys.append(with_key[3])
                assert torch.equal(keys[0], keys[1]) and torch.equal(keys[0], keys[2])
                fin = torch.isfinite(ref)
                assert torch.equal(fin, torch.isfinite(keys[0]) & (keys[0] < 1e25))
                torch.testing.assert_close(keys[0][fin], ref[fin], rtol=1e-8, atol=0)


def test_plain_key_of_a_known_dof_is_the_reduced_systems():
    """Known DOFs are identity rows and columns: the key is that of the
    reduced system, never above the full system's by more than the row-sum
    norm allows, and equal to the moment body's key when nothing is known."""
    rng = np.random.default_rng(41)
    case = cloud(rng, 128, 30, 2, radius=(0.2, 1.0))
    kw = dict(dimension=2, order=4, weighting=defs.WEIGHT_CENTER, emit_cond=True)
    full = fit_rows.fit_rows(*_t(case), **kw)[3]
    mom = fit_kernel.fit_kernel(*_t(case, ("xk", "fk", "nk", "xi")), **kw)[1]
    torch.testing.assert_close(full, mom, rtol=1e-8, atol=0)
    all_known = fit_rows.fit_rows(*_t(case), knowns=(1 << 15) - 1, **kw)[3]
    amp = fit_kernel.cond_amp_factor(fit_kernel._prescale(*_t(case, ("xk", "nk", "xi")))[3], 4)
    torch.testing.assert_close(all_known, np.sqrt(15.0) * amp, rtol=1e-12, atol=0)
    one = fit_rows.fit_rows(*_t(case), knowns=int(defs.b2_F), **kw)[3]
    assert bool((one < full * 1.0001).all())


# ---------------------------------------------------------------------------
# The kernel's two bodies: the rule that picks one, and the warp body's size
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448     # shared memory one H100 block can have (227 KB)


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_body_rule_and_shared_memory(dim, order):
    """A compile-time rule on NO picks the body; the warp body's shared
    memory does not grow with K and fits a block with sens and the key; the
    generated header carries both."""
    NO = defs.number_of_dofs(dim, order)
    assert fit_rows.warp_body(dim, order) == (NO >= fit_rows.WARP_MIN_NO)
    if (dim, order) == (3, 4):
        assert fit_rows.warp_body(dim, order)        # NO = 35 is never a thread body
    sizes = {(s, c): fit_rows.warp_smem_bytes(dim, order, s, c)
             for s in (False, True) for c in (False, True)}
    assert sizes[True, False] == sizes[True, True] >= sizes[False, True] > sizes[False, False]
    # neighbours come 32 at a time, so the size takes no K: any K fits
    assert max(sizes.values()) <= SMEM_LIMIT and all(v % 8 == 0 for v in sizes.values())
    head = "template <> struct RowsTables<%d, %d> {" % (dim, order)
    text = fit_rows.tables_header()
    block = text[text.index(head):].split("};")[0]
    assert ("static constexpr bool kWarp = %s;" % str(fit_rows.warp_body(dim, order)).lower()
            in block)
    assert ("kSmemBase = %d, kSmemKey = %d, kSmemSens = %d;"
            % (sizes[False, False], sizes[False, True], sizes[True, False]) in block)


def test_plain_matches_jax_engine_at_the_adjoint_configuration():
    """The adjoint example's launch (2D, order 2, K = 12, CENTER, do_sens,
    the thread body) on 1,024 cases of its grid: fi and sens of the plain
    version against the JAX f64 engine's, 1e-10 relative to max(|ref|, 1)."""
    from wlsqm_tpu_torch.examples import adjoint_data_recovery as ad

    p = ad.problem(32, device=CPU)
    B, order, wm = len(p.pts), 2, defs.WEIGHT_CENTER
    fk = p.u_obs[p.idx]
    fi, iters, sens = fit_rows.fit_rows_plain(p.xk, fk, p.nk, p.xi, dimension=2, order=order,
                                              weighting=wm, do_sens=True)
    case = dict(xk=p.xk.numpy(), fk=fk.numpy(), nk=p.nk.numpy(), xi=p.xi.numpy(),
                fi0=np.zeros((B, 6)))
    jfi, jsens, _, _ = _jax_engine(case, 2, order, 0, wm, do_sens=True)
    assert B == 1024 and sens.shape == (B, ad.K, 6) and (iters == 0).all()
    assert rel_err(fi.numpy(), jfi) <= PARITY
    assert rel_err(sens.numpy(), jsens) <= PARITY


@pytest.mark.parametrize("weighting", [defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER])
def test_plain_matches_jax_engine_3d_order4_ragged_k53(weighting):
    """The warp body's configuration at K = 53 (no multiple of 4, above one
    chunk of 32): fi and sens with and without a knowns mask, padded slots
    NaN; and ALGO_ITERATIVE's fi."""
    rng = np.random.default_rng(53 + weighting)
    case = cloud(rng, 96, 53, 3, orders=(4,), weightings=(weighting,), radius=RADIUS)
    assert np.isnan(case["xk"]).any()                 # ragged: NaN in padded slots
    kn = int(rng.integers(0, 1 << 35))
    for knowns in (0, kn):
        fi, _, sens = fit_rows.fit_rows_plain(*_t(case), dimension=3, order=4,
                                              weighting=weighting, knowns=knowns,
                                              do_sens=True)
        jfi, jsens, _, _ = _jax_engine(case, 3, 4, knowns, weighting, do_sens=True)
        assert rel_err(fi.numpy(), jfi) <= PARITY
        assert rel_err(sens.numpy(), jsens) <= PARITY
    fi, _, _ = fit_rows.fit_rows_plain(*_t(case), dimension=3, order=4, weighting=weighting,
                                       knowns=kn, max_iter=3)
    jfi, _, _, _ = _jax_engine(case, 3, 4, kn, weighting, iterative=True, max_iter=3)
    assert rel_err(fi.numpy(), jfi) <= PARITY


@pytest.mark.parametrize("key", ["grid_d1_o2_w2", "grid_d2_o4_w1", "warp_K53_d3_o4_w2"])
def test_stored_jax_iteration_counts_are_current(key):
    """tests/iterative_counts_jax.npz, the JAX f64 engine's ALGO_ITERATIVE
    counts that the card holds the rows kernel's counts against, is what the
    generator gives today on a slice of its configurations (a 1D, a 2D and
    a 3D warp-body one), case for case."""
    import iterative_counts

    stored = iterative_counts.load()
    assert set(stored) == {c[0] for c in iterative_counts.configs()}
    got = iterative_counts.generate({key})[key]
    assert got.dtype == np.int8 and got.min() >= 1 and got.max() <= iterative_counts.MAX_ITER
    np.testing.assert_array_equal(got, stored[key])


@pytest.mark.parametrize("dim", [1, 2])
def test_plain_iterative_counts_at_the_thread_body_staging_edge(dim):
    """ROADMAP C7 on the CPU: at the rows thread body's staging-edge K (the
    largest K whose offsets it stages, K (dim + 2) = 255: 1D K = 85, 2D
    K = 63), the plain version's ALGO_ITERATIVE counts against the JAX f64
    engine's (max_iter 3, every thread-body order, both weightings, a random
    knowns mask and fi_init, ragged nk with NaN padding: the clouds of
    tests/iterative_counts.py, 256 cases each), pooled by its tally: >= 50%
    equal and >= 80% within one, and the histogram distance held to the 0.1
    bar.  Measured here: 1D 0.670 equal, 0.940 within one, histogram
    distance 0.008; 2D 0.606, 0.914, 0.022.  So at that K the plain
    arithmetic's own counts sit well inside the bar against the reference:
    the drift at that K is not the plain version's."""
    import iterative_counts

    K = {1: 85, 2: 63}[dim]
    got, ref = [], []
    for order in range(5):
        if fit_rows.warp_body(dim, order):
            continue
        for w in (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER):
            xk, fk, nk, xi, fi0, kn = iterative_counts.cloud(dim, order, 256, K,
                                                             50 * K + 10 * order + w)
            _, it, _ = fit_rows.fit_rows_plain(
                *(torch.as_tensor(a) for a in (xk, fk, nk, xi, fi0)), dimension=dim,
                order=order, weighting=w, knowns=kn, max_iter=iterative_counts.MAX_ITER)
            got.append(it.numpy().astype(np.int64))
            ref.append(iterative_counts.jax_counts(dim, order, w, xk, fk, nk, xi, fi0,
                                                   kn).astype(np.int64))
    equal, within, apart = iterative_counts.shares(got, ref)
    assert equal >= 0.5 and within >= 0.8 and apart <= 0.1, (equal, within, apart)
