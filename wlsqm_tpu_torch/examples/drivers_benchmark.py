"""Benchmark the batched linear-algebra driver layer.

Counterpart of the JAX package's ``examples/drivers_benchmark.py``, an
analogue of the reference's LAPACK-drivers benchmark behind its README
timing figure (examples/lapackdrivers_example.py, lapack_timings.png).
Batches of small dense systems are solved

  * by a Python loop over ``numpy.linalg.solve`` (the reference's baseline);
  * by :func:`wlsqm_tpu_torch.utils.lapackdrivers.mgeneral`, one batched
    LAPACK solve on the host (the driver surface, NumPy in and out);
  * by :func:`wlsqm_tpu_torch.ops.solve.solve` with the unrolled-Cholesky
    name, which the port computes with the batched Cholesky on the device
    (the path the engine uses, on the card unless ``device="cpu"``),

and the average time per system is reported over a size sweep (host clock;
the device path synchronised).  Deterministic (seed 42).  The original also
draws ``examples/driver_timings.png``; this one writes no figure (the text
table holds the same numbers).

Run: python -m wlsqm_tpu_torch.examples.drivers_benchmark [--cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.ops import solve as solve_ops
from wlsqm_tpu_torch.utils import lapackdrivers as drv

SIZES = (3, 6, 10, 15, 21)
NBATCH = 1000
#: the reference's bar on the worst relative residual
TOL = 1e-8


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_numpy_loop(A, b) -> float:
    t0 = time.perf_counter()
    for i in range(A.shape[2]):
        np.linalg.solve(A[:, :, i], b[:, i])
    return time.perf_counter() - t0


def bench_mgeneral(A, b) -> float:
    drv.mgeneral(np.asfortranarray(A.copy()), np.asfortranarray(b.copy()))   # warm-up
    A2, b2 = np.asfortranarray(A.copy()), np.asfortranarray(b.copy())
    t0 = time.perf_counter()
    drv.mgeneral(A2, b2)
    return time.perf_counter() - t0


def bench_device_chol(A_spd, b, device) -> float:
    """The batched device solve, batch first; one warm-up call, then one
    timed call synchronised at both ends."""
    Ad = torch.as_tensor(np.moveaxis(A_spd, 2, 0).copy(), device=device)
    bd = torch.as_tensor(b.T.copy(), device=device)[..., None]

    def go():
        return solve_ops.solve(Ad, bd, solver=solve_ops.SOLVER_CHOLESKY_UNROLLED)

    go()
    _sync(device)
    t0 = time.perf_counter()
    go()
    _sync(device)
    return time.perf_counter() - t0


def _spd_batch(rng, n, nbatch):
    M = rng.standard_normal((n, n, nbatch))
    A = M + np.moveaxis(M, 0, 1) + 2 * n * np.eye(n)[:, :, None]   # SPD-ish
    return A, rng.standard_normal((n, nbatch))


def _worst_residual(A, x, b) -> float:
    return max(np.linalg.norm(A[:, :, i] @ x[:, i] - b[:, i]) / np.linalg.norm(b[:, i])
               for i in range(b.shape[1]))


def run(device=None) -> dict:
    """The size sweep on ``device`` (the card unless ``device="cpu"``) and
    the residual check at n = 15.  Returns the per-system seconds of each
    path by size and the worst relative residuals of ``mgeneral`` and of the
    device solve.  Raises if either reaches :data:`TOL`."""
    device = config.resolve_device(device)
    rng = np.random.default_rng(42)
    rows = []
    for n in SIZES:
        A, b = _spd_batch(rng, n, NBATCH)
        rows.append({"n": n, "np_loop_s": bench_numpy_loop(A, b) / NBATCH,
                     "mgeneral_s": bench_mgeneral(A, b) / NBATCH,
                     "device_chol_s": bench_device_chol(A, b, device) / NBATCH})

    n = 15
    A, b = _spd_batch(rng, n, 64)
    x = np.asfortranarray(b.copy())
    drv.mgeneral(np.asfortranarray(A.copy()), x)
    xd = solve_ops.solve(torch.as_tensor(np.moveaxis(A, 2, 0).copy(), device=device),
                         torch.as_tensor(b.T.copy(), device=device)[..., None],
                         solver=solve_ops.SOLVER_CHOLESKY_UNROLLED)[..., 0].T.cpu().numpy()
    out = {"device": str(device), "nbatch": NBATCH, "rows": rows, "residual_n": n,
           "worst_residual_mgeneral": _worst_residual(A, x, b),
           "worst_residual_device_chol": _worst_residual(A, xd, b), "tol": TOL}
    if not max(out["worst_residual_mgeneral"], out["worst_residual_device_chol"]) < TOL:
        raise RuntimeError("a batched solve missed the residual bar: %s" % (out,))
    return out


if __name__ == "__main__":
    res = run(device="cpu" if "--cpu" in sys.argv[1:] else None)
    print(f"{'n':>4} | {'np loop':>12} | {'mgeneral':>12} | {'device chol':>14}")
    print("-" * 52)
    for r in res["rows"]:
        print(f"{r['n']:>4} | {r['np_loop_s']*1e6:>9.1f} us | {r['mgeneral_s']*1e6:>9.1f} us | "
              f"{r['device_chol_s']*1e6:>11.2f} us")
    print("\n(device chol = the batched Cholesky solve on %s, the engine's path)"
          % res["device"])
    print(f"\nworst relative residual (mgeneral, n={res['residual_n']}): "
          f"{res['worst_residual_mgeneral']:.2e}")
    print(f"worst relative residual (device chol, n={res['residual_n']}): "
          f"{res['worst_residual_device_chol']:.2e}")
