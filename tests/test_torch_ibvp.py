"""The prepare-once / solve-many route and the IBVP heat step, port vs JAX.

``wtt.prepare`` / ``wtt.solve`` against ``wt.prepare`` / ``wt.solve`` at
precision f64 on the same NumPy inputs, errors relative to max(|ref|, 1)
per case.  The basic solve is one unrefined Cholesky solve, so two f64
implementations differ by about cond · eps: at orders 0-2 (the IBVP's
order 2 among them) fi and sens agree within 1e-12 (measured ≤ 1.9e-13
over dims 1-3 and both scalings); at orders 3-4 within 1e-11, the bound
tests/test_torch_engine.py holds unrefined DOFs to (measured ≤ 2.7e-12).
ALGO_ITERATIVE counts follow exact-stagnation ties, so they are held
pooled: >= 50% equal and >= 90% within one, the bound of
tests/test_torch_engine.py (measured 63% and 94%).  The heat step
runs through the port with ``device="cpu"`` and through JAX with
``u[idx]``: twenty steps agree within 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial
import torch

import wlsqm_tpu as wt
import wlsqm_tpu_torch as wtt
from torch_port_cases import cloud, rel_err
from wlsqm_tpu_torch.examples import ibvp_heat
from wlsqm_tpu_torch.ops import gather
from wlsqm_tpu_torch.utils.interop import prepared_from_numpy

torch.set_num_threads(1)

TOL = 1e-12
TOL_UNREFINED = 1e-11
K_BY_DIM = {1: 16, 2: 30, 3: 56}


def _case(dim, seed, B=256, orders=(0, 1, 2, 3, 4), knowns=True):
    rng = np.random.default_rng(seed)
    return cloud(rng, B, K_BY_DIM[dim], dim, orders=orders, weightings=(1, 2),
                 knowns=knowns, radius=(0.3, 1.0))


def _both(case, **kw):
    geo = dict(nk=case["nk"], order=case["order"], knowns=case["knowns"],
               weighting=case["weighting"], **kw)
    jprep = wt.prepare(jnp.asarray(case["xk"]), jnp.asarray(case["xi"]),
                       **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                          for k, v in geo.items()})
    prep = wtt.prepare(case["xk"], case["xi"], device="cpu", **geo)
    return jprep, prep


@pytest.mark.parametrize("orders,tol", [((0, 1, 2), TOL), ((3, 4), TOL_UNREFINED)])
@pytest.mark.parametrize("scaling", ["ruiz", "jacobi"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_prepare_solve_matches_jax(dim, scaling, orders, tol):
    case = _case(dim, 10 * dim + len(scaling), orders=orders)
    jprep, prep = _both(case, scaling=scaling)
    assert (prep.ncases, prep.no_max) == (jprep.ncases, jprep.no_max)
    jfi, jsens = wt.solve(jprep, jnp.asarray(case["fk"]), jnp.asarray(case["fi0"]),
                          do_sens=True)
    fi, sens = wtt.solve(prep, case["fk"], case["fi0"], do_sens=True)
    assert fi.device.type == "cpu"
    assert rel_err(fi.numpy(), np.asarray(jfi)) <= tol
    assert rel_err(sens.numpy(), np.asarray(jsens)) <= tol
    fi_b, sens_b = wtt.solve(prep, case["fk"])          # fi_init=None: zeros
    jfi_b, _ = wt.solve(jprep, jnp.asarray(case["fk"]))
    assert sens_b is None and rel_err(fi_b.numpy(), np.asarray(jfi_b)) <= tol


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_multi_field_is_one_solve_per_field(dim):
    """fk (F, B, K): one multi-RHS solve equals F single solves (and JAX's
    vmap over fields); sens carries the field axis."""
    case = _case(dim, 40 + dim, orders=(0, 1, 2))
    jprep, prep = _both(case)
    rng = np.random.default_rng(dim)
    fk = np.stack([case["fk"], 2.0 * case["fk"] + 1.0,
                   case["fk"] + 0.1 * rng.standard_normal(case["fk"].shape)])
    fi0 = np.stack([case["fi0"]] * 3)
    fi, sens = wtt.solve(prep, fk, fi0, do_sens=True)
    jfi, jsens = wt.solve(jprep, jnp.asarray(fk), jnp.asarray(fi0), do_sens=True)
    assert fi.shape == (3, 256, case["NO"]) and sens.shape == (3, 256, K_BY_DIM[dim],
                                                               case["NO"])
    for f in range(3):
        one, one_sens = wtt.solve(prep, fk[f], fi0[f], do_sens=True)
        assert rel_err(fi[f].numpy(), one.numpy()) <= TOL
        assert torch.equal(sens[f].nan_to_num(), one_sens.nan_to_num())
        assert rel_err(fi[f].numpy(), np.asarray(jfi[f])) <= TOL
        assert rel_err(sens[f].numpy(), np.asarray(jsens[f])) <= TOL


@pytest.mark.parametrize("fields", [False, True])
def test_iterative_matches_jax(fields):
    equal = within = total = 0
    for dim in (1, 2, 3):
        case = _case(dim, 60 + dim)
        jprep, prep = _both(case)
        fk = np.stack([case["fk"], -case["fk"]]) if fields else case["fk"]
        fi0 = np.stack([case["fi0"]] * 2) if fields else case["fi0"]
        jfi, _, jit = wt.solve(jprep, jnp.asarray(fk), jnp.asarray(fi0), iterative=True,
                               max_iter=3)
        fi, sens, it = wtt.solve(prep, fk, fi0, iterative=True, max_iter=3)
        assert sens is None and it.shape == fk.shape[:-1]
        got, ref = fi.reshape(-1, case["NO"]).numpy(), np.asarray(jfi).reshape(-1, case["NO"])
        assert rel_err(got, ref) <= TOL
        it, jit = it.numpy().ravel(), np.asarray(jit).ravel()
        equal += int((it == jit).sum())
        within += int((np.abs(it - jit) <= 1).sum())
        total += it.size
    assert equal / total >= 0.5 and within / total >= 0.9


def test_carried_prepared_solves_like_the_ports_own():
    case = _case(2, 70, orders=(0, 1, 2))
    jprep, prep = _both(case)
    fields = {f.name: (tuple(np.asarray(a) for a in getattr(jprep, f.name))
                       if f.name == "fac" else getattr(jprep, f.name))
              for f in dataclasses.fields(jprep)
              if f.name not in ("dimension", "solver", "precision")}
    fields = {k: None if v is None else v if k == "fac" else np.asarray(v)
              for k, v in fields.items()}
    carried = prepared_from_numpy(fields, dimension=jprep.dimension, solver=jprep.solver,
                                  precision=jprep.precision, device="cpu")
    fk = np.stack([case["fk"], 3.0 * case["fk"]])
    a, sa = wtt.solve(carried, fk, do_sens=True)
    b, sb = wtt.solve(prep, fk, do_sens=True)
    assert rel_err(a.reshape(-1, case["NO"]).numpy(), b.reshape(-1, case["NO"]).numpy()) <= TOL
    assert rel_err(sa[0].numpy(), sb[0].numpy()) <= TOL


def _gate_cloud(n=4096, K=28, seed=11):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 2))
    pts = pts[gather.morton_order(pts)]
    _, idx = scipy.spatial.cKDTree(pts).query(pts, k=K)
    return pts, idx.astype(np.int32)


def test_gate_row_heat_step_matches_jax():
    """Twenty steps of the gather gate row's step (order 2, uniform, Jacobi
    scaling, K = 28 with self, u += 1e-5 (X2 + Y2)): the port through
    gather_rows + solve on the CPU, JAX through u[idx] + solve."""
    pts, idx = _gate_cloud()
    plan = gather.plan_window_gather(idx, len(pts))
    assert plan is not None and plan.coverage > 0.75
    jprep = wt.prepare(jnp.asarray(pts)[idx], jnp.asarray(pts), order=2, scaling="jacobi")
    prep = wtt.prepare(pts[idx], pts, order=2, scaling="jacobi", device="cpu")
    u0 = np.sin(3 * pts[:, 0]) * np.cos(2 * pts[:, 1])
    jidx = jnp.asarray(idx)

    @jax.jit
    def jstep(u):
        fi, _ = wt.solve(jprep, u[jidx])
        return u + 1e-5 * (fi[:, wt.i2_X2] + fi[:, wt.i2_Y2])

    uj, ut = jnp.asarray(u0), torch.as_tensor(u0)
    tidx = torch.as_tensor(idx)
    for _ in range(20):
        uj = jstep(uj)
        fi, _ = wtt.solve(prep, gather.gather_rows(ut, tidx, plan))
        ut = ut + 1e-5 * (fi[:, wtt.i2_X2] + fi[:, wtt.i2_Y2])
    assert np.abs(ut.numpy() - np.asarray(uj)).max() <= TOL


def test_heat_example_on_the_cpu():
    res = ibvp_heat.run(device="cpu")
    assert res["max_error"] < ibvp_heat.TOL
    assert len(res["field_max_errors"]) == 3
    assert max(res["field_max_errors"]) < ibvp_heat.TOL
    assert res["coverage"] > 0.75 and res["gather_launches"] == 0


def test_prepare_and_solve_reject_what_is_not_ported():
    """Every solver of the JAX package is accepted ("lu" and "chol_unrolled"
    solve as "chol" does, to roundoff and bit for bit); unknown names and
    precisions are refused."""
    case = _case(2, 80, B=16, orders=(2,), knowns=False)
    ref = wtt.solve(wtt.prepare(case["xk"], case["xi"], nk=case["nk"], device="cpu"),
                    case["fk"])[0]
    for solver in ("lu", "chol_unrolled"):
        prep = wtt.prepare(case["xk"], case["xi"], nk=case["nk"], solver=solver,
                           device="cpu")
        assert prep.solver == solver
        fi = wtt.solve(prep, case["fk"])[0]
        if solver == "chol_unrolled":
            assert torch.equal(fi, ref)
        assert rel_err(fi.numpy(), ref.numpy()) <= 1e-11
    with pytest.raises(ValueError, match="unknown solver"):
        wtt.prepare(case["xk"], case["xi"], solver="qr", device="cpu")
    with pytest.raises(ValueError, match="f64"):
        wtt.prepare(case["xk"], case["xi"], precision="bogus", device="cpu")
    wtt.prepare(case["xk"], case["xi"], precision="ds", device="cpu")   # a JAX name: f64
    with pytest.raises(ValueError, match="matching xk"):
        wtt.prepare(case["xk"], case["xi"][:3], device="cpu")
    prep = wtt.prepare(case["xk"], case["xi"], nk=case["nk"], device="cpu")
    with pytest.raises(ValueError, match="mixed_steps"):
        wtt.solve(prep, case["fk"], mixed_steps=2)
    with pytest.raises(ValueError, match="matching the prepared geometry"):
        wtt.solve(prep, case["fk"][:, :5])
    with pytest.raises(ValueError, match="fi_init"):
        wtt.solve(prep, case["fk"], np.zeros((16, 3)))


def test_prepare_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = _case(2, 81, B=16, orders=(2,), knowns=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wtt.prepare(case["xk"], case["xi"])
