"""The port's Euler flow (``wlsqm_tpu_torch/examples/euler_flow.py``) against
the plain reference of the benchmark's ``euler2d_o3_k24`` configuration
(``bench_port/configs/euler2d_o3_k24_ref.py``), stage by stage, at nside 32
on the CPU: the reference's brute-force periodic neighbourhoods, each
stage's right-hand side and next state, and the float32 reference failing
the same bar.  Also: the step's hook leaves the step bit for bit as it was,
and the cloud's seed keeps the example's cloud by default."""

import ast
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402
from wlsqm_tpu_torch.examples import euler_flow as ef  # noqa: E402

REF_PATH = os.path.join(ROOT, "bench_port", "configs", "euler2d_o3_k24_ref.py")
NSIDE, SEED = 32, 2**31 + 5
#: the bar of each stage against the reference, relative to max(|ref|, 1)
TOL = 1e-10


@pytest.fixture(scope="module")
def ref():
    return harness.load_module(REF_PATH)


@pytest.fixture(scope="module")
def flow():
    return ef.setup(NSIDE, ef.K, device="cpu", seed=SEED)


def _perturbed(flow, seed=7):
    """The vortex with a seeded perturbation of 1e-3 relative to U."""
    U = flow.initial()
    g = torch.Generator().manual_seed(seed)
    return U * (1 + 1e-3 * torch.randn(U.shape, generator=g, dtype=U.dtype))


def _stages(flow, U, dt):
    """Each stage's (W, r) through the step's hook, and the step's result."""
    kept = []
    out = flow.step(U, dt, keep=lambda stage, W, r: kept.append((stage, W.clone(), r.clone())))
    assert [s for s, _, _ in kept] == [0, 1, 2]
    return [(W, r) for _, W, r in kept], out


def _gap(ref, got, want):
    return float(ref.gap(got, want).max())


def test_knn_periodic_gives_the_example_neighbourhoods(ref, flow):
    xk, own, _ = ef.periodic_neighbours(flow.pts, ef.K)
    pts = torch.as_tensor(flow.pts)
    gx, gown = ref.knn_periodic(pts, pts, ef.K)
    # the same set a point, in whatever order: sorted by owner
    a, b = np.argsort(own, 1), torch.argsort(gown, 1)
    np.testing.assert_array_equal(np.take_along_axis(own, a, 1),
                                  torch.gather(gown, 1, b).numpy())
    np.testing.assert_array_equal(np.take_along_axis(xk, a[..., None], 1),
                                  torch.gather(gx, 1, b[..., None].expand(-1, -1, 2)).numpy())
    assert not (gown == torch.arange(len(pts))[:, None]).any()      # self excluded


def _reference_stages(ref, flow, stages, U, dtype=torch.float64):
    pts = torch.as_tensor(flow.pts)
    xk, own = ref.knn_periodic(pts, pts, ef.K)
    dt = ef.cfl_dt(NSIDE)
    return [ref.stage(xk, pts, W[own], W, U, dt, s, dtype=dtype)
            for s, (W, _) in enumerate(stages)]


def test_each_stage_matches_the_reference(ref, flow):
    """r = -(F_x + G_y) of every stage, each stage's next state and the
    step's result within 1e-10 of the reference, from the program's own
    stage states."""
    U = _perturbed(flow)
    stages, out = _stages(flow, U, ef.cfl_dt(NSIDE))
    want = _reference_stages(ref, flow, stages, U)
    nxt = [stages[1][0], stages[2][0], out]
    for s, ((_, r), (r_ref, u_ref)) in enumerate(zip(stages, want)):
        assert _gap(ref, r, r_ref) <= TOL, s
        assert _gap(ref, nxt[s], u_ref) <= TOL, s
    assert _gap(ref, out, U) > 1e-6                 # the state did move


def test_the_float32_reference_fails_the_bar(ref, flow):
    U = _perturbed(flow)
    stages, _ = _stages(flow, U, ef.cfl_dt(NSIDE))
    want = _reference_stages(ref, flow, stages, U)
    got = _reference_stages(ref, flow, stages, U, dtype=torch.float32)
    assert max(_gap(ref, g[0], w[0]) for g, w in zip(got, want)) > TOL
    assert max(_gap(ref, g[1], w[1]) for g, w in zip(got, want)) > TOL


def test_the_hook_leaves_the_step_bit_for_bit(flow):
    """With and without the hook, and against the step's SSP-RK3 as the
    example wrote it before the hook."""
    U, dt = _perturbed(flow), ef.cfl_dt(NSIDE)
    plain = flow.step(U, dt)
    hooked = flow.step(U, dt, keep=lambda *a: None)
    U1 = U + dt * flow.rhs(U)
    U2 = 0.75 * U + 0.25 * (U1 + dt * flow.rhs(U1))
    written = U / 3.0 + 2.0 / 3.0 * (U2 + dt * flow.rhs(U2))
    assert torch.equal(plain, hooked) and torch.equal(plain, written)


def test_the_default_seed_keeps_the_example_cloud():
    rng = np.random.default_rng(42)
    g = (np.arange(NSIDE) + 0.5) * (ef.L / NSIDE)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    pts += rng.uniform(-0.25, 0.25, pts.shape) * (ef.L / NSIDE)
    pts %= ef.L
    default = ef.setup(NSIDE, ef.K, device="cpu")
    np.testing.assert_array_equal(default.pts, pts[ef.gth.morton_order(pts)])
    np.testing.assert_array_equal(default.pts,
                                  ef.setup(NSIDE, ef.K, device="cpu", seed=ef.SEED).pts)
    assert not np.array_equal(default.pts, ef.cloud(NSIDE, SEED))


def test_the_reference_imports_nothing_of_the_port():
    tree = ast.parse(open(REF_PATH).read())
    tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not tops & {"wlsqm_tpu_torch", "wlsqm_tpu", "jax", "jaxlib"}, tops
    assert tops <= {"__future__", "torch", "bench_port"}, tops
