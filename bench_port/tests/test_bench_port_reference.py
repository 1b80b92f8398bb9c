"""The plain references against the port's CPU paths at tiny sizes."""

import math

import numpy as np
import pytest
import torch

import bench_port_cases
from bench_port import harness
from bench_port.lib import clouds, wls_ref

TOL = 1e-10     # the package's parity bar, relative to max(|ref|, 1)


@pytest.fixture(scope="module")
def wtt():
    torch.set_num_threads(1)
    import wlsqm_tpu_torch

    return wlsqm_tpu_torch


@pytest.mark.parametrize("backend", ["kernel", "engine"])
@pytest.mark.parametrize("do_sens", [False, True])
def test_fit_reference_matches_the_port(wtt, backend, do_sens):
    """On the CPU ``backend="kernel"`` runs the kernels' plain versions (the
    moment body, or the rows body with sens)."""
    mix = {"geometry": "uniform", "radius": 1.0, "offset": 0.1, "noise": 0.01}
    xk, fk, xi = clouds.fit_batch(1024, 30, 2, mix, clouds.generator(3, "cpu"), "cpu")
    res = wtt.fit_many(xk, fk, xi, order=4, weighting=wtt.WEIGHT_CENTER, do_sens=do_sens,
                       backend=backend, device="cpu")
    ref = harness.load_cell("fit2d_o4_k30.sens").reference
    fi, sens = ref.fit_blocks(xk, fk, xi, order=4, center=True, sens=do_sens, block=300)
    assert float(ref.gap(res.fi, fi).max()) < TOL
    if do_sens:
        assert float(ref.gap(res.sens, sens).max()) < TOL


def test_the_condition_bounds_a_normal_equations_solve(wtt):
    """The reference's per-case condition: the port's f64 engine (normal
    equations) on the irregular mix stays within a few u times it, and the
    condition is the Skeel condition worked out directly from the
    normal matrix of the unscaled problem."""
    mix = {"geometry": "log_radius", "radii": [0.1, 1.0]}
    xk, fk, xi = clouds.fit_batch(1024, 30, 2, mix, clouds.generator(11, "cpu"), "cpu")
    fi, _, kappa = wls_ref.fit(xk, fk, xi, order=4, center=True, cond=True)
    res = wtt.fit_many(xk, fk, xi, order=4, weighting=wtt.WEIGHT_CENTER, backend="engine",
                       device="cpu")
    u = 2.0 ** -53
    assert float((wls_ref.gap(res.fi, fi) / (u * kappa)).max()) < 8
    # directly, on a few cases: C the factorial-scaled monomials of the raw offsets
    exps = wls_ref.EXPONENTS[2][:15]
    for c in range(8):
        d = xk[c] - xi[c]
        r = (d * d).sum(-1).sqrt()
        w = wls_ref.ALPHA + (1 - wls_ref.ALPHA) * (1 - r / r.max()) ** 2
        C = torch.stack([d[:, 0] ** a * d[:, 1] ** b / (math.factorial(a) * math.factorial(b))
                         for a, b in exps], -1)
        N = C.T @ (w[:, None] * C)
        v = torch.linalg.inv(N).abs() @ (C.abs().T @ (w * (C.abs() @ fi[c].abs() + fk[c].abs())))
        want = float(v.max() / fi[c].abs().max().clamp_min(1.0))
        assert abs(float(kappa[c]) / want - 1) < 1e-6


@pytest.mark.parametrize("dim,order", [(1, 4), (2, 2), (3, 2)])
def test_fit_reference_other_shapes(wtt, dim, order):
    mix = {"geometry": "uniform", "radius": 1.0, "offset": 0.2, "noise": 0.0}
    K = 3 * wls_ref.dofs(dim, order)
    xk, fk, xi = clouds.fit_batch(256, K, dim, mix, clouds.generator(4, "cpu"), "cpu")
    res = wtt.fit_many(xk, fk, xi, order=order, weighting=wtt.WEIGHT_UNIFORM,
                       backend="engine", device="cpu")
    fi, _ = wls_ref.fit(xk, fk, xi, order=order, center=False)
    assert float(wls_ref.gap(res.fi, fi).max()) < TOL


def test_the_reference_recovers_a_polynomial():
    """Exact data of an order-4 polynomial: the DOFs are its derivatives."""
    g = torch.Generator().manual_seed(5)
    xk = torch.rand((64, 30, 2), generator=g, dtype=torch.float64) - 0.5
    xi = torch.zeros((64, 2), dtype=torch.float64)
    x, y = xk[..., 0], xk[..., 1]
    fk = 1 + 2 * x - y + 3 * x * y + x ** 3 - 0.5 * x ** 2 * y ** 2
    fi, _ = wls_ref.fit(xk, fk, xi, order=4, center=True)
    want = torch.zeros(15, dtype=torch.float64)
    # F X Y X2 XY Y2 X3 X2Y XY2 Y3 X4 X3Y X2Y2 XY3 Y4
    want[[0, 1, 2, 4, 6, 12]] = torch.tensor([1, 2, -1, 3, 6, -2], dtype=torch.float64)
    assert float((fi - want).abs().max()) < 1e-11


def test_heat_reference_matches_the_ports_step(wtt):
    """One explicit step of the heat cell at 4,096 points: the port's
    prepare, gather and solve against the reference's brute-force
    neighbours and fit."""
    from wlsqm_tpu_torch.ops import gather
    from wlsqm_tpu_torch.utils import neighbors

    cell = harness.load_cell("heat2d_o2_k28.step_f1")
    ref, K = cell.reference, cell.config["k"]
    pts, interior = clouds.heat_cloud(4096, cell.traffic, clouds.generator(6, "cpu"), "cpu")
    perm = torch.as_tensor(gather.morton_order(pts.numpy()))
    pts, interior = pts[perm], interior[perm]
    idx, _ = neighbors.knn(pts.numpy(), pts.numpy(), K, backend="host")
    idx = torch.as_tensor(idx.astype(np.int64))
    prep = wtt.prepare(pts[idx], pts, order=2, weighting=wtt.WEIGHT_CENTER, device="cpu")
    u = torch.sin(math.pi * pts[:, 0]) * torch.sin(math.pi * pts[:, 1])
    fi, _ = wtt.solve(prep, u[idx])
    dt_nu = [0.00216 / 4096]
    u_next = torch.where(interior, u + dt_nu[0] * (fi[:, wtt.i2_X2] + fi[:, wtt.i2_Y2]), u)
    at = interior.nonzero().squeeze(1)[::7]
    nbr = ref.knn(pts, pts[at], K)
    # the same neighbourhoods (an edge's corner point is there twice, so
    # compare the points' distances, not their indices)
    def dist(j):
        return torch.sort(((pts[j] - pts[at][:, None, :]) ** 2).sum(-1), 1).values

    assert torch.equal(dist(nbr), dist(idx[at]))
    fi_ref, u_ref = ref.step(pts[nbr], pts[at], u[nbr], u[at], interior[at], dt_nu,
                             order=2, center=True)
    assert float(ref.gap(fi[at], fi_ref).max()) < TOL
    assert float(ref.gap(u_next[at, None], u_ref[:, None]).max()) < 1e-15


@pytest.mark.parametrize("name,overrides", [(c, {}) for c in bench_port_cases.CELLS] + [
    ("heat2d_o2_k28.step_f1", {"fields": 3, "dt_nu_over_h2": [0.000864, 0.001512, 0.00216]})])
def test_cells_pass_on_the_cpu(name, overrides):
    """Every cell's whole run (set-up, window, check) at the tiny size, with
    the port's CPU paths as the program; the stepper also with three fields."""
    out, _ = bench_port_cases.run_cell(name, overrides=overrides)
    assert out["correct"], (name, out["checks"])
    assert out["attempted"] > 0 and out["failed"] == 0
