"""The CUDA kernels on the card: against their plain versions, and on the route.

These tests need an NVIDIA card, nvcc and no JAX; here they skip.  On the
card run them without the JAX test fixtures:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance 1e-10 relative to max(|ref|, 1) per case: each kernel and its
plain version compute the same sums in another order (and with FMA
contraction), which differs by ~cond * eps; nk >= 1.5 NO keeps cond modest.
ALGO_ITERATIVE counts are decided by exact-stagnation ties, so they are held
pooled over the grid: >= 50% equal, >= 80% within one, and per-configuration
count histograms at most 0.1 apart (summed |difference| / 2 over all cases;
chip_smoke.py checks that no constant count passes this bar).  The rows kernel against its
plain version measured 57% and 88% over the 2D grid on an H100: FMA
contraction and the summation order move the last bit of the residual
norms, and with it the tie.  Data fk = 0 has no tie: both stop after one
trip.
"""

import numpy as np
import pytest
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

pytestmark = pytest.mark.cuda

PARITY = 1e-10


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cloud(dev, B, K, order, seed, dim=2, lo=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    xk = torch.rand((B, K, dim), generator=g, device=dev, dtype=torch.float64) * 2 - 1
    xi = (torch.rand((B, dim), generator=g, device=dev, dtype=torch.float64) - 0.5) * 0.2
    xk = xk + xi[:, None, :]
    fk = torch.sin(3 * xk[..., 0]) * torch.cos(2 * xk[..., -1])
    if lo is None:
        lo = (3 * wtt.number_of_dofs(dim, order)) // 2
    nk = torch.randint(min(lo, K), K + 1, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    nk[::2] = K
    pad = torch.arange(K, device=dev)[None, :] >= nk[:, None]
    xk[pad] = torch.nan
    fk = fk.masked_fill(pad, torch.nan)
    return xk, fk, nk, xi


def _rel(a, b):
    return ((a - b).abs().amax(1) / b.abs().amax(1).clamp_min(1.0)).max().item()


@pytest.mark.parametrize("weighting", [wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_kernel_matches_plain(dev, order, weighting):
    xk, fk, nk, xi = _cloud(dev, 4096, 30, order, seed=order)
    before = fit_kernel.LAUNCHES
    got = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=order,
                                weighting=weighting)
    torch.cuda.synchronize()
    assert fit_kernel.LAUNCHES == before + 1
    ref = fit_kernel.fit_moments_plain(xk, fk, nk, xi, dimension=2, order=order,
                                       weighting=weighting)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= PARITY


def test_cuda_call_never_runs_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(fit_kernel, "fit_moments_plain", boom)
    monkeypatch.setattr(fit_kernel, "_solve_moments", boom)
    xk, fk, nk, xi = _cloud(dev, 1000, 30, 4, seed=9)
    before = fit_kernel.LAUNCHES
    fi = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=4,
                               weighting=wtt.WEIGHT_CENTER)
    torch.cuda.synchronize()
    assert fit_kernel.LAUNCHES == before + 1
    assert torch.isfinite(fi).all()


def test_kernel_rejects_what_it_does_not_cover(dev):
    xk, fk, nk, xi = _cloud(dev, 256, 30, 4, seed=1)
    with pytest.raises(ValueError):
        fit_kernel._launch(xk, fk, nk, xi, xi[:, 0], torch.empty(
            (256, 15), dtype=torch.float64, device=dev), order=4, weighting=3,
            refine_steps=1)
    with pytest.raises(ValueError):
        fit_kernel.fit_kernel(xk.float(), fk, nk, xi, dimension=2, order=4,
                              weighting=wtt.WEIGHT_CENTER)


def test_planned_route_launches_the_kernel(dev):
    xk, fk, nk, xi = _cloud(dev, 8192, 30, 4, seed=2)
    plan = wtt.plan_fit_many(xk, xi, order=4, weighting=wtt.WEIGHT_CENTER)
    assert plan.route.path == "kernel"
    before = fit_kernel.LAUNCHES
    res = wtt.fit_many(xk, fk, xi, nk=nk, order=4, weighting=wtt.WEIGHT_CENTER,
                       plan=plan)
    eng = wtt.fit_many(xk, fk, xi, nk=nk, order=4, weighting=wtt.WEIGHT_CENTER,
                       backend="engine")
    torch.cuda.synchronize()
    assert fit_kernel.LAUNCHES == before + 1
    assert res.fi.device.type == "cuda"
    assert _rel(res.fi, eng.fi) <= PARITY


# ---------------------------------------------------------------------------
# The rows kernel (csrc/fit_rows.cu)
# ---------------------------------------------------------------------------

K_BY_DIM = {1: 16, 2: 30, 3: 56}


def _rel_nan(a, b):
    """_rel with NaN required at the same places in both (known sens columns)."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    a, b = (torch.nan_to_num(x).reshape(len(x), -1) for x in (a, b))
    return _rel(a, b)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_rows_kernel_matches_plain(dev, dim):
    """Every order and weighting, with sens, a random knowns mask and
    max_iter 3; counts pooled over the dimension's grid.  1D keeps nk >= 2 NO
    (chip_smoke.py's phase_rows_vs_plain says why)."""
    g = torch.Generator().manual_seed(dim)
    equal = within = apart = total = 0
    for order in range(5):
        NO = wtt.number_of_dofs(dim, order)
        for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
            xk, fk, nk, xi = _cloud(dev, 2048, K_BY_DIM[dim], order, 10 * order + w, dim,
                                    lo=2 * NO if dim == 1 else None)
            fi0 = torch.randn((2048, NO), dtype=torch.float64, device=dev)
            kn = int(torch.randint(0, 1 << NO, (1,), generator=g))
            for knowns, sens, max_iter in ((0, True, 0), (kn, True, 0), (kn, False, 3)):
                kw = dict(dimension=dim, order=order, weighting=w, knowns=knowns,
                          do_sens=sens, max_iter=max_iter)
                before = fit_rows.LAUNCHES
                got = fit_rows.fit_rows(xk, fk, nk, xi, fi0, **kw)
                torch.cuda.synchronize()
                assert fit_rows.LAUNCHES == before + 1
                ref = fit_rows.fit_rows_plain(xk, fk, nk, xi, fi0, **kw)
                assert torch.isfinite(got[0]).all()
                assert _rel(got[0], ref[0]) <= PARITY, (order, w, knowns, sens, max_iter)
                if sens:
                    assert _rel_nan(got[2], ref[2]) <= PARITY
                KN = fit_rows.known_dofs(knowns, dim, order)
                assert torch.equal(got[0][:, KN], fi0[:, KN])
                if max_iter:
                    assert 1 <= int(got[1].min()) and int(got[1].max()) <= max_iter
                    equal += int((got[1] == ref[1]).sum())
                    within += int(((got[1] - ref[1]).abs() <= 1).sum())
                    apart += int((torch.bincount(got[1], minlength=4)
                                  - torch.bincount(ref[1], minlength=4)).abs().sum()) // 2
                    total += got[1].numel()
                    zero = dict(kw, knowns=0)
                    fi_z, it_z, _ = fit_rows.fit_rows(xk, fk * 0.0, nk, xi, **zero)
                    assert (it_z == 1).all() and (fi_z == 0).all()
    assert equal / total >= 0.5 and within / total >= 0.8 and apart / total <= 0.1


def test_rows_cuda_call_never_runs_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(fit_rows, "fit_rows_plain", boom)
    monkeypatch.setattr(fit_rows, "_solve_rows", boom)
    xk, fk, nk, xi = _cloud(dev, 1000, 30, 4, seed=9)
    before = fit_rows.LAUNCHES
    fi, _, sens = fit_rows.fit_rows(xk, fk, nk, xi, dimension=2, order=4,
                                    weighting=wtt.WEIGHT_CENTER, do_sens=True)
    torch.cuda.synchronize()
    assert fit_rows.LAUNCHES == before + 1
    assert torch.isfinite(fi).all() and torch.isfinite(sens).all()


def test_rows_kernel_rejects_what_it_does_not_cover(dev):
    """A CUDA tensor with a configuration no kernel covers raises; nothing
    falls back to the plain version or the engine."""
    xk, fk, nk, xi = _cloud(dev, 256, 30, 4, seed=1)
    before = fit_rows.LAUNCHES
    with pytest.raises(ValueError):
        fit_rows.fit_rows(xk, fk, nk, xi, dimension=2, order=5, weighting=1)
    with pytest.raises(ValueError):
        fit_rows.fit_rows(xk, fk, nk, xi, dimension=2, order=4, weighting=3)
    with pytest.raises(ValueError):
        fit_rows.fit_rows(xk.float(), fk, nk, xi, dimension=2, order=4, weighting=1)
    with pytest.raises(ValueError):
        wtt.fit_many(xk, fk, xi, nk=nk, order=torch.tensor([4, 3] * 128, device=dev),
                     backend="kernel")
    assert fit_rows.LAUNCHES == before


def test_sens_route_launches_the_rows_kernel(dev):
    xk, fk, nk, xi = _cloud(dev, 8192, 30, 4, seed=3)
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER, do_sens=True)
    plan = wtt.plan_fit_many(xk, xi, **kw)
    assert (plan.route.path, plan.route.assembly) == ("kernel", "rows")
    before = fit_kernel.LAUNCHES, fit_rows.LAUNCHES
    res = wtt.fit_many(xk, fk, xi, nk=nk, plan=plan, **kw)
    torch.cuda.synchronize()
    assert (fit_kernel.LAUNCHES, fit_rows.LAUNCHES) == (before[0], before[1] + 1)
    eng = wtt.fit_many(xk, fk, xi, nk=nk, backend="engine", **kw)
    assert res.fi.device.type == "cuda" and res.sens.shape == (8192, 30, 15)
    assert _rel(res.fi, eng.fi) <= PARITY
    assert _rel(res.sens.reshape(8192, -1), eng.sens.reshape(8192, -1)) <= PARITY


def test_auto_routes_knowns_dim3_and_iterative_to_the_rows_kernel(dev):
    xk, fk, nk, xi = _cloud(dev, 4096, 56, 4, seed=4, dim=3)
    before = fit_rows.LAUNCHES
    res = wtt.fit_many(xk, fk, xi, nk=nk, order=4, weighting=wtt.WEIGHT_CENTER)
    it = wtt.fit_many(xk, fk, xi, nk=nk, order=3, knowns=1, iterative=True,
                      max_iter=3, fi_init=torch.ones((4096, 20), dtype=torch.float64,
                                                     device=dev))
    torch.cuda.synchronize()
    assert fit_rows.LAUNCHES == before + 2
    eng = wtt.fit_many(xk, fk, xi, nk=nk, order=4, weighting=wtt.WEIGHT_CENTER,
                       backend="engine")
    assert _rel(res.fi, eng.fi) <= PARITY
    assert (it.fi[:, 0] == 1).all() and int(it.iterations.min()) >= 1


def test_diffable_on_the_card(dev):
    xk, fk, nk, xi = _cloud(dev, 512, 30, 3, seed=5)
    fk = fk.nan_to_num().requires_grad_(True)
    fi = fit_rows.fit_rows_diffable(xk, fk, nk, xi, dimension=2, order=3,
                                    weighting=wtt.WEIGHT_CENTER)
    g = torch.randn_like(fi)
    (fi * g).sum().backward()
    _, _, sens = fit_rows.fit_rows_plain(xk, fk.detach(), nk, xi, dimension=2,
                                         order=3, weighting=wtt.WEIGHT_CENTER,
                                         do_sens=True)
    ref = torch.einsum("bkj,bj->bk", sens, g)
    assert _rel(fk.grad, ref) <= PARITY
