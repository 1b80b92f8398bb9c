"""Meshless compressible Euler flow: the reference's flagship application.

Counterpart of the JAX package's ``examples/euler_flow.py``.  The reference
was built to drive explicit meshless flow solvers (its theory documents
include a compressible-flow writeup, ``doc/eulerflow.pdf`` via
README.md:226-231).  This example solves the 2D compressible Euler
equations

    U_t + F(U)_x + G(U)_y = 0,       U = (rho, rho*u, rho*v, E)

on a scattered periodic point cloud, with every spatial derivative from a
WLSQM fit, and holds the density to the exact isentropic vortex (which
advects with the freestream, unchanged in shape).

* Periodic neighbourhoods: neighbour *positions* are ghost translates of
  the cloud (the fit sees true offsets), neighbour *values* are gathered
  from the owning points, the meshless analogue of ghost cells.  The
  original queries the whole 3x3 tiling; here only a boundary band of the
  eight ghost tiles goes into the tree (:func:`periodic_neighbours`), twice
  as wide as any point's k-th neighbour distance in the untiled cloud,
  which bounds its periodic one, so the neighbour sets are the full
  tiling's at a ninth of its tree.
* Prepare once, solve many: the geometry never changes, so the normal
  matrices are prepared and factored once (order 3, WEIGHT_CENTER), and
  each SSP-RK3 stage is ONE gather of the 8 flux fields (B, 8) through
  :func:`wlsqm_tpu_torch.ops.gather.gather_rows` (the gather kernel on the
  card, its plain version on the CPU) and ONE multi-field
  :func:`wlsqm_tpu_torch.solve` against the one factorization.

The original's ``lax.scan`` over jitted steps is a Python loop here
(PyTorch runs eagerly).  It falls back to ``fl[own]`` where the gather plan
is None; this port always builds the plan (``max_bad_frac=1.0``: the CUDA
kernel gathers every row whatever the windows hold), reports its coverage,
and always calls ``gather_rows``.  Under a profiler each stage's flux and
RK combination are the spans ``euler.flux`` and ``euler.rk``
(:mod:`wlsqm_tpu_torch.utils.profiling`).

Run: python -m wlsqm_tpu_torch.examples.euler_flow [--cpu]
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.ops import gather as gth
from wlsqm_tpu_torch.utils import neighbors, profiling

GAMMA = 1.4
L = 10.0          # periodic domain [0, L]^2
BETA = 5.0        # vortex strength
U_INF = (1.0, 1.0)
ORDER = 3
NSIDE, K = 48, 24  # the example's own cloud: nside^2 points, k neighbours
T_END = 1.0
#: the bar on the max density error against the exact vortex
TOL = 2e-2
SEED = 42


def vortex_primitive(pts, t):
    """Exact isentropic-vortex primitives (rho, u, v, p) at time t."""
    xc = (5.0 + U_INF[0] * t) % L
    yc = (5.0 + U_INF[1] * t) % L
    # periodic-minimal offsets to the vortex center
    dx = (pts[..., 0] - xc + L / 2) % L - L / 2
    dy = (pts[..., 1] - yc + L / 2) % L - L / 2
    r2 = dx * dx + dy * dy
    ex = np.exp(0.5 * (1.0 - r2))
    u = U_INF[0] - BETA / (2 * np.pi) * ex * dy
    v = U_INF[1] + BETA / (2 * np.pi) * ex * dx
    T = 1.0 - (GAMMA - 1) * BETA**2 / (8 * GAMMA * np.pi**2) * np.exp(1.0 - r2)
    rho = T ** (1.0 / (GAMMA - 1))
    p = rho * T
    return rho, u, v, p


def conservative(rho, u, v, p):
    E = p / (GAMMA - 1) + 0.5 * rho * (u * u + v * v)
    return np.stack([rho, rho * u, rho * v, E], axis=-1)


def cloud(nside: int, seed: int = SEED) -> np.ndarray:
    """The jittered-grid cloud (nside^2, 2) in [0, L)^2, Morton-ordered
    (the original's recipe, l.80-85)."""
    rng = np.random.default_rng(seed)
    g = (np.arange(nside) + 0.5) * (L / nside)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    pts += rng.uniform(-0.25, 0.25, pts.shape) * (L / nside)
    pts %= L
    return pts[gth.morton_order(pts)]


_SHIFTS = np.array([(i, j) for i in (-L, 0.0, L) for j in (-L, 0.0, L)])


def periodic_neighbours(pts: np.ndarray, k: int, *, band: bool = True):
    """The k nearest periodic neighbours of every point, self excluded.

    Returns (xk (B, k, 2) ghost positions, own (B, k) int64 owning point,
    the band width or None).  ``band=False`` queries the full 3x3 ghost
    tiling, as the original does.  ``band=True`` keeps of the eight ghost
    tiles only the points within twice the largest k-th neighbour distance
    of the untiled cloud from the domain: a point's periodic k-th distance
    is at most its untiled one, so every neighbour that counts is kept.
    """
    n = len(pts)
    width = None
    tiled = pts[None, :, :] + _SHIFTS[:, None, :]          # (9, n, 2)
    owner = np.broadcast_to(np.arange(n), (9, n))
    if band:
        _, d2 = neighbors.knn(pts, pts, k + 1, backend="host")
        width = 2.0 * float(np.sqrt(d2[:, -1].max()))
        keep = ((tiled >= -width) & (tiled < L + width)).all(-1)
        tiled, owner = tiled[keep], owner[keep]
    else:
        tiled, owner = tiled.reshape(-1, 2), owner.reshape(-1)
    idx, _ = neighbors.knn(tiled, pts, k + 1, backend="host")
    idx = idx[:, 1:]                                        # drop self (distance 0)
    return tiled[idx], owner[idx].astype(np.int64), width


def flux_fields(U: torch.Tensor) -> torch.Tensor:
    """The 8 flux components (B, 8): F(U) then G(U)."""
    rho, mx, my, E = U.unbind(1)
    u, v = mx / rho, my / rho
    p = (GAMMA - 1) * (E - 0.5 * rho * (u * u + v * v))
    return torch.stack([mx, mx * u + p, my * u, (E + p) * u,
                        my, mx * v, my * v + p, (E + p) * v], 1)


def cfl_dt(nside: int) -> float:
    """The explicit SSP-RK3 step within the advective CFL (the original's)."""
    h = L / nside
    return 0.3 * h / (np.hypot(*U_INF) + np.sqrt(GAMMA))


@dataclasses.dataclass
class Flow:
    """A prepared periodic cloud: what every stage reads."""

    pts: np.ndarray
    own: torch.Tensor          # (B, K) int32: the owning point of each neighbour
    plan: gth.GatherPlan
    prep: wtt.Prepared
    band: float | None
    setup_s: dict

    def gather(self, fl: torch.Tensor) -> torch.Tensor:
        """fl[own] (B, K, 8), one gather_rows."""
        return gth.gather_rows(fl, self.own, self.plan)

    def divergence(self, fk: torch.Tensor) -> torch.Tensor:
        """-(F_x + G_y) (B, 4) from the gathered fluxes, one multi-field solve."""
        fi, _ = wtt.solve(self.prep, fk.permute(2, 0, 1))    # (8, B, NO)
        return -(fi[:4, :, wtt.i2_X] + fi[4:, :, wtt.i2_Y]).T

    def rhs(self, U: torch.Tensor) -> torch.Tensor:
        with profiling.span("euler.flux", U.device):
            fl = flux_fields(U)
        return self.divergence(self.gather(fl))

    def step(self, U: torch.Tensor, dt: float, keep=None) -> torch.Tensor:
        """One SSP-RK3 step: three gathers and three solves.

        ``keep(stage, W, r)``, where given, is called at each stage with the
        stage's input state W and its ``rhs(W)``, before the stage's
        combination (the state is read, not changed)."""
        W = U
        for stage in range(3):
            r = self.rhs(W)
            if keep is not None:
                keep(stage, W, r)
            with profiling.span("euler.rk", W.device):
                if stage == 0:
                    W = U + dt * r
                elif stage == 1:
                    W = 0.75 * U + 0.25 * (W + dt * r)
                else:
                    W = U / 3.0 + 2.0 / 3.0 * (W + dt * r)
        return W

    def initial(self) -> torch.Tensor:
        return torch.as_tensor(conservative(*vortex_primitive(self.pts, 0.0)),
                               device=self.own.device)


def setup(nside: int = NSIDE, k: int = K, *, device=None, seed: int = SEED) -> Flow:
    """Cloud (its jitter drawn from ``seed``), periodic neighbourhoods,
    gather plan and the prepared factor, each step timed in ``setup_s``
    (host seconds; ``prepare`` synchronised)."""
    device = config.resolve_device(device)
    times = {}
    t0 = time.perf_counter()
    pts = cloud(nside, seed)
    times["cloud_morton_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xk, own, width = periodic_neighbours(pts, k)
    times["neighbours_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = gth.plan_window_gather(own, len(pts), max_bad_frac=1.0)
    times["plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    own_t = torch.as_tensor(own, dtype=torch.int32, device=device)
    prep = wtt.prepare(torch.as_tensor(xk, device=device), torch.as_tensor(pts, device=device),
                       order=ORDER, weighting=wtt.WEIGHT_CENTER, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times["prepare_s"] = time.perf_counter() - t0
    return Flow(pts=pts, own=own_t, plan=plan, prep=prep, band=width, setup_s=times)


def density_error(flow: Flow, U: torch.Tensor, t: float) -> np.ndarray:
    """|rho - rho_exact(t)| at every point."""
    return np.abs(U[:, 0].cpu().numpy() - vortex_primitive(flow.pts, t)[0])


def run(device=None, nside: int = NSIDE, k: int = K, t_end: float = T_END) -> dict:
    """Advect the vortex on ``device`` (the card unless ``device="cpu"``).

    Runs to ``t_end`` with the CFL step rounded to land on it, as the
    original does.  Returns the density
    errors against the exact vortex, the step count and size, the gather
    plan's coverage, the gather kernel launches made (0 on the CPU) and the
    set-up seconds.  Raises if the solution is not finite or its max
    density error reaches :data:`TOL`.
    """
    flow = setup(nside, k, device=device)
    nsteps = int(np.ceil(t_end / cfl_dt(nside)))
    dt = t_end / nsteps
    t_final = dt * nsteps
    launches = gth.LAUNCHES
    U = flow.initial()
    for _ in range(nsteps):
        U = flow.step(U, dt)
    err = density_error(flow, U, t_final)
    out = {"device": str(flow.own.device), "n": len(flow.pts), "k": k, "order": ORDER,
           "fields": 8, "steps": nsteps, "dt": dt, "t_final": t_final,
           "max_error": float(err.max()), "rms_error": float(np.sqrt((err**2).mean())),
           "finite": bool(torch.isfinite(U).all()), "coverage": flow.plan.coverage,
           "bad_blocks": len(flow.plan.bad_blocks), "band": flow.band,
           "gather_launches": gth.LAUNCHES - launches, "setup_s": flow.setup_s, "tol": TOL}
    if not out["finite"]:
        raise RuntimeError("solution blew up: %s" % (out,))
    if out["max_error"] >= TOL:
        raise RuntimeError("vortex drifted from the exact solution: %s" % (out,))
    return out


if __name__ == "__main__":
    res = run(device="cpu" if "--cpu" in sys.argv[1:] else None)
    print("window gather: coverage %.1f%%, %d launches"
          % (100 * res["coverage"], res["gather_launches"]))
    print(f"cloud: {res['n']} points, k={res['k']}, order 3; {res['steps']} SSP-RK3 steps, "
          f"dt={res['dt']:.4f}, t_end={res['t_final']}")
    print(f"density error vs exact vortex: max {res['max_error']:.3e}, "
          f"rms {res['rms_error']:.3e}")
    print("OK")
