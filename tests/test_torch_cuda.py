"""The CUDA kernel on the card: against its plain version, and on the route.

These tests need an NVIDIA card, nvcc and no JAX; here they skip.  On the
card run them without the JAX test fixtures:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance 1e-10 relative to max(|ref|, 1) per case: the kernel and the plain
version compute the same moments in another summation order (and with FMA
contraction), which differs by ~cond * eps; nk >= 1.5 NO keeps cond modest.
"""

import numpy as np
import pytest
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch.ops import fit_kernel

pytestmark = pytest.mark.cuda

PARITY = 1e-10


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cloud(dev, B, K, order, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    xk = torch.rand((B, K, 2), generator=g, device=dev, dtype=torch.float64) * 2 - 1
    xi = (torch.rand((B, 2), generator=g, device=dev, dtype=torch.float64) - 0.5) * 0.2
    xk = xk + xi[:, None, :]
    fk = torch.sin(3 * xk[..., 0]) * torch.cos(2 * xk[..., 1])
    lo = (3 * wtt.number_of_dofs(2, order)) // 2
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
