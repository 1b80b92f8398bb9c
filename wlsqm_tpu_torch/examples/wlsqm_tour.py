"""Tour of the port's API: fits, derivatives, interpolation, sensitivity.

Counterpart of the JAX package's ``examples/wlsqm_tour.py``, itself an
analogue of the reference's example tour (examples/wlsqm_example.py):
manufactured polynomial solutions in 1D and 2D with every derivative DOF
checked against closed forms, the knowns mechanism, iterative refinement,
model interpolation and sensitivities through the compat surface, a batch
through ``fit_many``, and autograd through the f64 engine.

The original's routing stage prints ``condprobe.ds_floor``, the predicted
error floor of the TPU's emulated double-single kernel.  The H100 computes
in FP64, so the emulated arithmetic was not ported (ROADMAP A15) and there
is no such floor here.  The port's stage prints what the port decides
instead: :func:`wlsqm_tpu_torch.fitter.condprobe.kernel_accuracy_ok` for
each radius, and the route that ``fit_many(backend="auto")`` takes there
(:func:`wlsqm_tpu_torch.plan_fit_many` makes the same decision).

Run: python -m wlsqm_tpu_torch.examples.wlsqm_tour [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import condprobe, defs, engine


def tour_1d(rng, device) -> dict:
    """f(x) = 2 + x - 3x^2 + 0.5x^3, order 3: f, f', f'', f''' at 0."""
    def f(x):
        return 2.0 + x - 3.0 * x**2 + 0.5 * x**3

    xk = rng.uniform(-1, 1, 25)
    fi = np.zeros(wtt.number_of_dofs(1, 3))
    wtt.fit_1D(xk=xk, fk=f(xk), xi=0.0, fi=fi, sens=None, do_sens=False,
               order=3, knowns=0, weighting_method=wtt.WEIGHT_UNIFORM, device=device)
    return {"fi": fi, "exact": np.array([2.0, 1.0, -6.0, 3.0])}


def tour_2d(rng, device) -> dict:
    """A quartic, order 4, ALGO_ITERATIVE: every mixed derivative at 0, and
    the model interpolated at fresh points."""
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return x**4 - 2 * x**3 * y + 3 * x * y**3 + x * y - y**2

    xk = rng.uniform(-1, 1, (60, 2))
    fi = np.zeros(wtt.number_of_dofs(2, 4))
    it = wtt.fit_2D_iterative(xk=xk, fk=f(xk), xi=np.zeros(2), fi=fi, sens=None,
                              do_sens=False, order=4, knowns=0,
                              weighting_method=wtt.WEIGHT_UNIFORM, max_iter=10,
                              device=device)
    exact = np.zeros(15)
    exact[wtt.i2_XY] = 1.0          # d2/dxdy of x*y
    exact[wtt.i2_Y2] = -2.0         # d2/dy2 of -y^2
    exact[wtt.i2_X4] = 24.0         # d4/dx4 of x^4
    exact[wtt.i2_X3Y] = -12.0       # d4/dx3dy of -2x^3y
    exact[wtt.i2_XY3] = 18.0        # d4/dxdy3 of 3xy^3
    q = rng.uniform(-0.5, 0.5, (5, 2))
    v = wtt.interpolate_fit(np.zeros(2), fi, 2, 4, q, diff=wtt.i2_F, device=device)
    return {"iterations": it, "fi": fi, "max_dof_error": float(np.abs(fi - exact).max()),
            "interpolation_errors": np.abs(v - f(q))}


def tour_knowns(rng, device) -> dict:
    """Pin df/dy (a Neumann-style known) and solve the rest."""
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return 1.0 + 2.0 * x + 3.0 * y + 0.5 * x * y

    xk = rng.uniform(-1, 1, (20, 2))
    fi = np.zeros(wtt.number_of_dofs(2, 2))
    fi[wtt.i2_Y] = 3.0
    wtt.fit_2D(xk=xk, fk=f(xk), xi=np.zeros(2), fi=fi, sens=None, do_sens=False,
               order=2, knowns=wtt.b2_Y, weighting_method=wtt.WEIGHT_UNIFORM, device=device)
    return {"fi": fi}


def tour_sensitivity(rng, device) -> dict:
    """d fi / d fk: each column sums to the model's response to a constant
    shift, 1 for F and 0 for the derivatives."""
    xk = rng.uniform(-1, 1, (15, 2))
    fk = rng.standard_normal(15)
    fi = np.zeros(6)
    sens = np.zeros((15, 6))
    wtt.fit_2D(xk=xk, fk=fk, xi=np.zeros(2), fi=fi, sens=sens, do_sens=True,
               order=2, knowns=0, weighting_method=wtt.WEIGHT_CENTER, device=device)
    return {"fi": fi, "colsum": sens.sum(axis=0)}


def tour_batch(rng, device) -> dict:
    """10k fits in one ``fit_many`` call."""
    centers = rng.uniform(-1, 1, (10_000, 2))
    xk = centers[:, None, :] + rng.uniform(-0.1, 0.1, (10_000, 20, 2))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])
    res = wtt.fit_many(xk, fk, centers, order=2, weighting=wtt.WEIGHT_CENTER, device=device)
    fi = res.fi.cpu().numpy()
    dx_exact = np.cos(centers[:, 0]) * np.cos(centers[:, 1])
    return {"max_dx_error": float(np.abs(fi[:, wtt.i2_X] - dx_exact).max())}


def tour_routing(rng, device) -> dict:
    """The port's certified routing at two radii: the probe's verdict and
    the route ``fit_many(backend="auto")`` takes."""
    out = {}
    for radius in (1.0, 0.05):
        centers = rng.uniform(-1, 1, (2048, 2))
        xk = centers[:, None, :] + rng.uniform(-radius, radius, (2048, 30, 2))
        xk_t, xi_t = (torch.as_tensor(a, device=device) for a in (xk, centers))
        ok = condprobe.kernel_accuracy_ok(xk_t, None, xi_t, 4, wtt.WEIGHT_CENTER, dimension=2)
        route = wtt.plan_fit_many(xk_t, xi_t, order=4, weighting=wtt.WEIGHT_CENTER,
                                   device=device).route
        out[radius] = {"kernel_accuracy_ok": bool(ok), "route": route.path,
                       "assembly": route.assembly if route.path != "xla" else None}
    return out


def tour_autodiff(rng, device) -> dict:
    """Reverse mode through the engine: over the data it reproduces the
    sens column; over the geometry it has no reference counterpart."""
    B, K, NO = 8, 18, 6
    xk = torch.as_tensor(rng.uniform(-1, 1, (B, K, 2)), device=device)
    fk = torch.sin(xk[..., 0]) * torch.cos(xk[..., 1])
    args = (torch.full((B,), K, dtype=torch.int32, device=device),
            xk.new_zeros((B, 2)), xk.new_zeros((B, NO)),
            torch.full((B,), 2, dtype=torch.int32, device=device),
            torch.zeros((B,), dtype=torch.int64, device=device),
            torch.full((B,), defs.WEIGHT_CENTER, dtype=torch.int32, device=device))

    def x_deriv_sum(x, f):
        fi, _, _, _ = engine.fit_batch(x, f, *args, dimension=2, NO=NO)
        return fi[:, wtt.i2_X].sum()

    f_req = fk.clone().requires_grad_(True)
    (g_fk,) = torch.autograd.grad(x_deriv_sum(xk, f_req), f_req)
    _, sens, _, _ = engine.fit_batch(xk, fk, *args, dimension=2, NO=NO, do_sens=True)
    x_req = xk.clone().requires_grad_(True)
    (g_xk,) = torch.autograd.grad(x_deriv_sum(x_req, fk), x_req)
    return {"grad_vs_sens": float((g_fk - sens[:, :, wtt.i2_X]).abs().max()),
            "g_fk": g_fk.cpu().numpy(), "g_xk": g_xk.cpu().numpy()}


STAGES = (("1D: f(x) = 2 + x - 3x^2 + 0.5x^3, order 3, all derivatives", tour_1d),
          ("2D: full order-4 fit of a quartic, every mixed derivative", tour_2d),
          ("Knowns / Neumann-style elimination: pin df/dy, solve the rest", tour_knowns),
          ("Sensitivity: d fi / d fk, all neighbors at once", tour_sensitivity),
          ("Batch API: 10k fits in one fit_many call", tour_batch),
          ("Conditioning-aware routing: what backend='auto' decides", tour_routing),
          ("Autodiff (beyond the reference): torch.autograd through the engine",
           tour_autodiff))


def run(device=None) -> dict:
    """Every stage on ``device`` (the card unless ``device="cpu"``), from
    one generator (seed 42) in the original's order.  Returns each stage's
    results by its function name, and the device."""
    device = config.resolve_device(device)
    rng = np.random.default_rng(42)
    out = {fn.__name__: fn(rng, device) for _, fn in STAGES}
    out["device"] = str(device)
    return out


def _print(res) -> None:
    def banner(msg):
        print("\n" + "=" * 72)
        print(msg)
        print("=" * 72)

    r = iter(title for title, _ in STAGES)
    banner(next(r))
    fi, ex = res["tour_1d"]["fi"], res["tour_1d"]["exact"]
    for name, idx in (("f", wtt.i1_F), ("f'", wtt.i1_X), ("f''", wtt.i1_X2),
                      ("f'''", wtt.i1_X3)):
        print(f"  {name:5s} = {fi[idx]:+.12f}   (exact {ex[idx]:+g}, "
              f"err {abs(fi[idx] - ex[idx]):.2e})")
    banner(next(r))
    t = res["tour_2d"]
    print(f"  refinement iterations: {t['iterations']}; max DOF error: "
          f"{t['max_dof_error']:.2e}")
    print("  interpolation errors:", t["interpolation_errors"].round(14))
    banner(next(r))
    fi = res["tour_knowns"]["fi"]
    print(f"  F  = {fi[wtt.i2_F]:+.12f} (exact +1)")
    print(f"  X  = {fi[wtt.i2_X]:+.12f} (exact +2)")
    print(f"  Y  = {fi[wtt.i2_Y]:+.12f} (pinned, must stay exactly 3)")
    banner(next(r))
    print("  sum_k sens[k, :] =", res["tour_sensitivity"]["colsum"].round(12),
          " (expect [1, 0, ...])")
    banner(next(r))
    print(f"  max df/dx error over 10k fits: {res['tour_batch']['max_dx_error']:.2e}")
    banner(next(r))
    for radius, label in ((1.0, "wide, well-conditioned"),
                          (0.05, "tiny-radius, order-4 hostile")):
        t = res["tour_routing"][radius]
        route = (t["route"] if t["assembly"] is None
                 else "%s (%s body)" % (t["route"], t["assembly"]))
        print(f"  radius {radius:4}: kernel accuracy certified: {t['kernel_accuracy_ok']} "
              f"-> {route}   ({label})")
    banner(next(r))
    t = res["tour_autodiff"]
    print(f"  d(sum f_x)/d fk vs sens column: max diff {t['grad_vs_sens']:.2e}")
    print(f"  d(sum f_x)/d xk exists too: shape {tuple(t['g_xk'].shape)}, "
          f"max |g| {float(np.abs(t['g_xk']).max()):.2f} "
          "(sensor-placement design; see gradient_stencil_design)")


if __name__ == "__main__":
    _print(run(device="cpu" if "--cpu" in sys.argv[1:] else None))
    print("\nAll tour stages done.")
