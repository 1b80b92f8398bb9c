"""Differentiable stencil design: optimise neighbour geometry by autograd.

Counterpart of the JAX package's ``examples/gradient_stencil_design.py``.
The reference computes one derivative by hand, the data sensitivity
``sens[k, j] = d fi[j] / d fk[k]`` (wlsqm/fitter/impl.pyx:768-846), and
uses it to reason about noise amplification.  The f64 engine is a torch
program, so that amplification can be differentiated in the neighbour
positions and descended on.

Estimating f_x at a point from samples with i.i.d. noise of std sigma gives
the X DOF a noise of std ``sigma * || sens[:, i2_X] ||_2``.  Starting from a
mediocre stencil (a random cloud squashed into an anisotropic blob), plain
gradient descent on the neighbour coordinates lowers that amplification at
a fixed neighbour count, with the whole fit and its sensitivities
(:func:`wlsqm_tpu_torch.fitter.engine.fit_batch` with ``do_sens=True``)
under ``torch.autograd``; a penalty keeps the points inside the design
radius.  A Monte-Carlo run with noisy data through ``fit_many(backend="xla",
precision="f64")`` (the engine) confirms the predicted amplification.

Run: python -m wlsqm_tpu_torch.examples.gradient_stencil_design [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import defs, engine

K, DIM, ORDER = 20, 2, 2
NO = defs.number_of_dofs(DIM, ORDER)
R = 0.3          # design radius: neighbours should stay within this ball
STEPS = 200
LR = 2e-3
#: the bars: the descent gains at least 1 / 0.55, and Monte Carlo agrees within 15%
GAIN, MC_TOL = 0.55, 0.15


def amplification(xk: torch.Tensor) -> torch.Tensor:
    """Noise amplification ||sens[:, i2_X]||_2 of the X-derivative DOF,
    for one stencil xk (K, DIM)."""
    dev = xk.device
    B = 1
    _, sens, _, _ = engine.fit_batch(
        xk[None], xk.new_zeros((B, K)), torch.full((B,), K, dtype=torch.int32, device=dev),
        xk.new_zeros((B, DIM)), xk.new_zeros((B, NO)),
        torch.full((B,), ORDER, dtype=torch.int32, device=dev),
        torch.zeros((B,), dtype=torch.int64, device=dev),
        torch.full((B,), defs.WEIGHT_UNIFORM, dtype=torch.int32, device=dev),
        dimension=DIM, NO=NO, do_sens=True, scaling="jacobi")
    return torch.sqrt((sens[0, :, defs.i2_X] ** 2).sum())


def objective(xk: torch.Tensor) -> torch.Tensor:
    # soft wall keeping the stencil inside the design radius
    r = torch.sqrt((xk ** 2).sum(-1))
    wall = (torch.clamp_min(r - R, 0.0) ** 2).sum()
    return amplification(xk) + 1e3 * wall


def grad_objective(xk: torch.Tensor) -> torch.Tensor:
    xk = xk.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(objective(xk), xk)
    return g


def monte_carlo_noise(xk, device, trials: int = 4000, sigma: float = 1.0,
                      seed: int = 0) -> float:
    """Measured std of the fitted X DOF under i.i.d. data noise."""
    rng = np.random.default_rng(seed)
    fk = sigma * rng.standard_normal((trials, K))
    xk = torch.as_tensor(np.asarray(xk), device=device)
    res = wtt.fit_many(xk.expand(trials, K, DIM), fk, order=ORDER, backend="xla",
                       precision="f64", device=device)
    return float(torch.std(res.fi[:, defs.i2_X], correction=0))


def start_stencil() -> np.ndarray:
    """The mediocre starting stencil: an anisotropic squashed blob (seed 42)."""
    rng = np.random.default_rng(42)
    xk0 = rng.uniform(-R, R, (K, DIM))
    xk0[:, 0] *= 0.25
    return xk0


def run(device=None) -> dict:
    """Descend on ``device`` (the card unless ``device="cpu"``).

    Returns the initial, optimised and ring-baseline amplifications and the
    Monte-Carlo noise of the initial and optimised stencils.  Raises unless
    the descent lowers the amplification under :data:`GAIN` times its start
    and Monte Carlo agrees with the prediction within :data:`MC_TOL`.
    """
    device = config.resolve_device(device)
    xk0 = torch.as_tensor(start_stencil(), device=device)
    with torch.no_grad():
        amp0 = float(amplification(xk0))
    xk = xk0
    for _ in range(STEPS):
        xk = xk - LR * grad_objective(xk)
    with torch.no_grad():
        ampN = float(amplification(xk))
        # reference layout: well-spread isotropic rings
        th = 2 * np.pi * np.arange(K) / K
        ring = R * np.stack([np.cos(th), np.sin(th)], -1)
        ring[K // 2:] *= 0.55
        ampR = float(amplification(torch.as_tensor(ring, device=device)))
        mc0 = monte_carlo_noise(xk0.cpu().numpy(), device)
        mcN = monte_carlo_noise(xk.cpu().numpy(), device)
    out = {"device": str(device), "steps": STEPS, "amp_initial": amp0, "amp_optimized": ampN,
           "amp_ring": ampR, "mc_initial": mc0, "mc_optimized": mcN}
    if not ampN < GAIN * amp0:
        raise RuntimeError("descent should substantially improve the stencil: %s" % (out,))
    if not abs(mcN - ampN) < MC_TOL * ampN:
        raise RuntimeError("prediction should match Monte Carlo: %s" % (out,))
    return out


if __name__ == "__main__":
    res = run(device="cpu" if "--cpu" in sys.argv[1:] else None)
    print("initial   amplification: %.3f" % res["amp_initial"])
    print("optimized amplification: %.3f  (%.1fx lower)"
          % (res["amp_optimized"], res["amp_initial"] / res["amp_optimized"]))
    print("isotropic-ring baseline: %.3f" % res["amp_ring"])
    print("Monte-Carlo DOF noise std: initial %.3f -> optimized %.3f "
          "(predicted %.3f -> %.3f)" % (res["mc_initial"], res["mc_optimized"],
                                        res["amp_initial"], res["amp_optimized"]))
    print("OK")
