"""Driver "stepper": the explicit heat IBVP stepper of
``wlsqm_tpu_torch/examples/ibvp_heat.py`` at the configuration's size.

Set-up: the cloud from the seed (:func:`bench_port.lib.clouds.heat_cloud`),
its Morton order, the k nearest points of each (the point itself
included) and the window plan on the host, then ``api.prepare`` once on
the card.  Every step of the window is

    fk = gather_rows(u, idx, plan)         # K4
    fi, _ = api.solve(prep, fk)            # the f64 engine on the factors
    u = where(interior, u + dt nu (fi[X2] + fi[Y2]), u)

and ends in a synchronise.  Traffic parameters: ``fields`` (one solve of
all fields a step), ``dt_nu_over_h2`` (one value a field; h = 1/√n, the
mean spacing), the cloud's ``side_factor`` and ``margin_gaps``,
``sample_points`` for the check.

End-to-end values: ``step_ms`` (the window over the steps), ``setup_s``.
The check follows the program from its own state, at every step: before
the window the harness draws ``sample_points`` interior points from the
seed and finds their k nearest points by brute force (the reference's
own neighbours; this time is not set-up and is taken out of ``setup_s``);
each step of the window keeps the state at those points and their
neighbours, and the step's DOFs at the points (two ``index_select`` into
buffers made in set-up, some 70,000 values).  After the window the reference refits every kept state
there and steps it: ``fi_gap`` compares each step's DOFs, ``u_gap`` the
next state, over every step of the window.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from bench_port.lib import bounds, clouds
from bench_port.lib.trace import WINDOW

STEP_BLOCK = 1 << 16     # reference cases (steps x points) a block


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> None:
    import wlsqm_tpu_torch as wtt
    from wlsqm_tpu_torch import api
    from wlsqm_tpu_torch.ops import gather
    from wlsqm_tpu_torch.utils import neighbors

    cfg, dev, spans = ctx.cell.config, ctx.device, ctx.spans
    order, K = cfg["order"], cfg["k"]
    n = ctx.size("points")
    center = cfg["weighting"] == "center"
    F = ctx.param("fields")
    h2 = 1.0 / n
    dt_nu = [float(r) * h2 for r in ctx.param("dt_nu_over_h2")]
    if len(dt_nu) != F:
        raise ValueError("dt_nu_over_h2 needs one value a field")
    gen = clouds.generator(ctx.seed, dev)
    pts_d, interior = clouds.heat_cloud(n, ctx.cell.traffic, gen, dev)
    pts = pts_d.cpu().numpy()
    with spans.host("setup.morton"):
        perm = gather.morton_order(pts)
    pts = pts[perm]
    interior = interior[torch.as_tensor(perm, device=dev)]
    with spans.host("setup.knn"):
        idx, _ = neighbors.knn(pts, pts, K, backend="host")
        idx = idx.astype(np.int32)
    with spans.host("setup.plan"):
        plan = gather.plan_window_gather(idx, n)
    if plan is None:
        raise RuntimeError("the Morton-ordered cloud gave no window plan")
    pts_t = torch.as_tensor(pts, device=dev)
    idx_t = torch.as_tensor(idx, device=dev)
    weighting = wtt.WEIGHT_CENTER if center else wtt.WEIGHT_UNIFORM
    with torch.no_grad():
        prep = api.prepare(pts_t[idx_t.long()], pts_t, order=order, weighting=weighting,
                           scaling=cfg.get("scaling", "ruiz"), device=dev)
    ctx.bounds["gather"] = bounds.gather_launch(n, n * K, 8 * F)["bound_ms"] / 1e3
    u_start = torch.sin(math.pi * pts_t[:, 0]) * torch.sin(math.pi * pts_t[:, 1])
    if F > 1:
        u_start = u_start[:, None].repeat(1, F).contiguous()
    lap = (wtt.i2_X2, wtt.i2_Y2)
    step_nu = torch.tensor(dt_nu, dtype=torch.float64, device=dev) if F > 1 else dt_nu[0]
    mask = interior if F == 1 else interior[:, None]
    gather_rows, solve = gather.gather_rows, api.solve

    def step(u):
        with spans.span("gather.gather_rows"):
            fk = gather_rows(u, idx_t, plan)
        with spans.span("api.solve"):
            fi, _ = solve(prep, fk if F == 1 else fk.permute(2, 0, 1))
        with spans.span("step.update"):
            d = fi[..., lap[0]] + fi[..., lap[1]]
            u = torch.where(mask, u + step_nu * (d if F == 1 else d.T), u)
        return u, fi

    # the check's points and their neighbours, by the reference (not set-up)
    t_check = time.perf_counter()
    ref, M = ctx.cell.reference, ctx.param("sample_points")
    inner = interior.nonzero().squeeze(1)
    at = inner[torch.randperm(inner.numel(), generator=gen, device=dev)[:M]]
    M = at.numel()
    nbr = ref.knn(pts_t, pts_t[at], K)
    keep_idx = torch.cat([nbr.reshape(-1), at])
    _sync(dev)
    check_s = time.perf_counter() - t_check

    with torch.no_grad():
        u = u_start
        for _ in range(3):                       # warm-up: the step's shapes
            c0 = time.perf_counter()
            u_next, fi = step(u)
            _sync(dev)
            dt = time.perf_counter() - c0
            u = u_next
        # the kept values go into buffers made here, so the window allocates
        # no more than the program does; sized from the last warm-up step
        cap = int(ctx.seconds / dt * 1.25) + 8
        kept_u = u.new_empty((cap + 1, keep_idx.numel()) + u.shape[1:])
        kept_fi = fi.new_empty((cap,) + fi.index_select(-2, at).shape)

        def keep(s, u, fi):
            nonlocal kept_u, kept_fi
            if s == kept_fi.shape[0]:              # a window longer than foreseen
                ctx.notes["kept_grew_at"] = s
                kept_u = torch.cat([kept_u, torch.empty_like(kept_u)])
                kept_fi = torch.cat([kept_fi, torch.empty_like(kept_fi)])
            torch.index_select(u, 0, keep_idx, out=kept_u[s])
            torch.index_select(fi, -2, at, out=kept_fi[s])

        keep(0, u, fi)
        _sync(dev)
        del u_next, fi
        launches0 = gather.LAUNCHES
        ctx.trace.start()
        u = u_start
        times = []
        t0 = time.perf_counter()
        ctx.values["setup_s"] = t0 - ctx.t_start - check_s
        deadline = t0 + ctx.seconds
        with torch.profiler.record_function(WINDOW):
            s = 0
            while True:
                c0 = time.perf_counter()
                u_next, fi = step(u)
                keep(s, u, fi)
                _sync(dev)
                c1 = time.perf_counter()
                times.append(c1 - c0)
                u = u_next
                s += 1
                if c1 >= deadline:
                    break
            _sync(dev)
        t1 = time.perf_counter()
        ctx.trace.stop()
        torch.index_select(u, 0, keep_idx, out=kept_u[s])      # the last step's result
    del fi, u, u_next
    window_s = t1 - t0
    ctx.counts.update(steps=s, window_s=window_s,
                      launches={"gather": gather.LAUNCHES - launches0})
    ctx.values["step_ms"] = window_s / s * 1e3
    if dev.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    ctx.notes["ms_min_q1_median_q3_max"] = [1e3 * v for v in (min(times), *q, max(times))]
    ctx.notes["check_setup_s"] = check_s
    ctx.attempted = s
    del prep
    _check(ctx, pts_t[nbr], pts_t[at], interior[at], kept_u[:s + 1], kept_fi[:s], dt_nu,
           order=order, center=center)


def _check(ctx, xk, xi, inner, kept_u, kept_fi, dt_nu, *, order, center) -> None:
    """The reference steps the program's state at every step: kept_u (S + 1,
    M k + M[, F]) the state before each step and after the last, kept_fi
    (S, [F,] M, NO) each step's DOFs.  Under ``judge="control"`` the
    reference in float32 is judged in the program's place."""
    ref, lim = ctx.cell.reference, ctx.cell.limits
    M, K = xk.shape[0], xk.shape[1]
    S = kept_fi.shape[0]
    chunk = max(1, STEP_BLOCK // M)
    worst_fi = worst_u = 0.0
    failed = 0
    with torch.no_grad():
        for lo in range(0, S, chunk):
            n = min(chunk, S - lo)
            st = kept_u[lo:lo + n]
            uk = st[:, :M * K].reshape(n * M, K, *st.shape[2:])
            ui = st[:, M * K:].reshape(n * M, *st.shape[2:])
            args = (xk.repeat(n, 1, 1), xi.repeat(n, 1), uk, ui, inner.repeat(n), dt_nu)
            fi_ref, u_ref = ref.step(*args, order=order, center=center)
            if ctx.judge == "control":
                fi_got, u_got = ref.step(*args, order=order, center=center,
                                         dtype=torch.float32)
            else:
                f = kept_fi[lo:lo + n]                     # (n, [F,] M, NO)
                fi_got = (f.reshape(n * M, -1) if f.ndim == 3
                          else f.transpose(0, 1).reshape(f.shape[1], n * M, -1))
                u_got = kept_u[lo + 1:lo + 1 + n, M * K:].reshape(n * M, *st.shape[2:])
            no = fi_ref.shape[-1]
            g_fi = ref.gap(fi_got.reshape(-1, n * M, no).transpose(0, 1).reshape(n * M, -1),
                           fi_ref.reshape(-1, n * M, no).transpose(0, 1).reshape(n * M, -1))
            g_u = ref.gap(u_got.reshape(n * M, -1), u_ref.reshape(n * M, -1))
            g_fi, g_u = g_fi.reshape(n, M).amax(1), g_u.reshape(n, M).amax(1)
            worst_fi = max(worst_fi, g_fi.max().item())
            worst_u = max(worst_u, g_u.max().item())
            failed += int((~(g_fi <= lim["fi_gap"]) | ~(g_u <= lim["u_gap"])).sum())
    ctx.failed = failed
    ctx.notes["checked_steps"] = S
    ctx.checks["fi_gap"] = (worst_fi, lim["fi_gap"])
    ctx.checks["u_gap"] = (worst_u, lim["u_gap"])
