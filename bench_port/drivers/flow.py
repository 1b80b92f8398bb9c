"""The "flow" traffic: the meshless compressible Euler flow of
``wlsqm_tpu_torch/examples/euler_flow.py`` at the configuration's size.

Set-up: ``euler_flow.setup(nside, k, device, seed)`` (the jittered cloud
from the seed, its Morton order, the periodic neighbourhoods, the window
plan, ``prepare`` on the card), the example's CFL step, the isentropic
vortex at t = 0.  Every step of the window is one ``Flow.step``, the
example's SSP-RK3 step:

    per stage: fl = flux_fields(W)            # pointwise
               fk = gather_rows(fl, own, plan) # K4, 64-byte rows
               fi = api.solve(prep, fk)        # the f64 engine, 8 fields
               W  = the stage's RK combination of U, W and -(F_x + G_y)

and ends in a synchronise.  In a traced run the benchmark's spans
``gather.gather_rows`` and ``api.solve`` wrap the module attributes through
which ``Flow`` calls them.  Traffic parameters: ``nside`` (the cloud is
nside² points, the configuration's ``points``), ``cfl`` (the example's),
``sample_points`` for the check.

End-to-end values: ``step_ms`` (the window over the steps), ``setup_s``.
The check follows the program from its own state, at every stage of every
step: before the window the harness draws ``sample_points`` points from the
seed and finds their k nearest periodic neighbours by brute force (the
reference's own neighbourhoods; this time is not set-up and is taken out of
``setup_s``); through ``Flow.step``'s hook each stage keeps its input state
at those points and at their neighbours' owners, and its right-hand side at
the points, in buffers made in set-up.  After the window the reference
recomputes every stage from the kept states: ``div_gap`` compares each
stage's r = -(F_x + G_y), ``u_gap`` the stage's next state (the next
stage's input, or the step's result).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from bench_port.lib import bounds, clouds
from bench_port.lib.trace import WINDOW

STAGE_BLOCK = 1 << 16     # reference cases (steps x points) a block
ROW_BYTES = 64            # a gathered row: 8 f64 flux fields


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> None:
    import wlsqm_tpu_torch as wtt
    from wlsqm_tpu_torch.examples import euler_flow as ef
    from wlsqm_tpu_torch.ops import gather

    cfg, dev, spans = ctx.cell.config, ctx.device, ctx.spans
    nside, n, K = int(ctx.param("nside")), ctx.size("points"), cfg["k"]
    if nside * nside != n:
        raise ValueError("nside %d does not give the configuration's %d points" % (nside, n))
    if (cfg["order"], cfg["fields"], cfg["weighting"]) != (ef.ORDER, 8, "center"):
        raise ValueError("the configuration is not the example's order, fields or weighting")
    dt = ef.cfl_dt(nside)
    if not math.isclose(dt, ctx.param("cfl") * (ef.L / nside)
                        / (math.hypot(*ef.U_INF) + math.sqrt(ef.GAMMA))):
        raise ValueError("the traffic's cfl is not the example's")
    with torch.no_grad():
        flow = ef.setup(nside, K, device=dev, seed=int(ctx.seed) % (1 << 63))
    ctx.bounds["gather"] = bounds.gather_launch(n, n * K, ROW_BYTES)["bound_ms"] / 1e3
    ctx.notes["flow_setup_s"] = flow.setup_s
    ctx.notes["plan_coverage"] = flow.plan.coverage

    # the check's points and their neighbourhoods, by the reference (not set-up)
    t_check = time.perf_counter()
    ref, M = ctx.cell.reference, ctx.param("sample_points")
    gen = clouds.generator(ctx.seed, dev)
    pts_t = torch.as_tensor(flow.pts, device=dev)
    at = torch.randperm(n, generator=gen, device=dev)[:M]
    M = at.numel()
    xk, own = ref.knn_periodic(pts_t, pts_t[at], K)
    keep_idx = torch.cat([own.reshape(-1), at])
    _sync(dev)
    check_s = time.perf_counter() - t_check

    with torch.no_grad():
        U = flow.initial()
        for _ in range(3):                       # warm-up: the step's shapes
            c0 = time.perf_counter()
            U = flow.step(U, dt)
            _sync(dev)
            step_s = time.perf_counter() - c0
        # the kept values go into buffers made here, so the window allocates
        # no more than the program does; sized from the last warm-up step
        cap = int(ctx.seconds / step_s * 1.25) + 8
        kept_w = U.new_empty((cap + 1, 3, keep_idx.numel(), 4))
        kept_r = U.new_empty((cap, 3, M, 4))
        s = 0

        def keep(stage, W, r):
            nonlocal kept_w, kept_r
            if s == kept_r.shape[0] and stage == 0:   # a window longer than foreseen
                ctx.notes["kept_grew_at"] = s
                kept_w = torch.cat([kept_w, torch.empty_like(kept_w)])
                kept_r = torch.cat([kept_r, torch.empty_like(kept_r)])
            torch.index_select(W, 0, keep_idx, out=kept_w[s, stage])
            torch.index_select(r, 0, at, out=kept_r[s, stage])

        del U
        _sync(dev)
        spans.wrap(gather, "gather_rows", "gather.gather_rows")
        spans.wrap(wtt, "solve", "api.solve")
        launches0 = gather.LAUNCHES
        ctx.trace.start()
        U = flow.initial()
        _sync(dev)
        times = []
        t0 = time.perf_counter()
        ctx.values["setup_s"] = t0 - ctx.t_start - check_s
        deadline = t0 + ctx.seconds
        with torch.profiler.record_function(WINDOW):
            while True:
                c0 = time.perf_counter()
                U = flow.step(U, dt, keep=keep)
                _sync(dev)
                c1 = time.perf_counter()
                times.append(c1 - c0)
                s += 1
                if c1 >= deadline:
                    break
            _sync(dev)
        t1 = time.perf_counter()
        ctx.trace.stop()
        spans.unwrap()
        torch.index_select(U, 0, keep_idx, out=kept_w[s, 0])      # the last step's result
    del U, flow
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
    _check(ctx, xk, pts_t[at], kept_w[:s + 1], kept_r[:s], dt)


def _check(ctx, xk, xi, kept_w, kept_r, dt) -> None:
    """The reference recomputes every stage of every step from the
    program's kept states: kept_w (S + 1, 3, M k + M, 4) each stage's input
    at the neighbours' owners and the points (row S: the last step's result
    in stage 0), kept_r (S, 3, M, 4) each stage's r at the points.  Under
    ``judge="control"`` the reference in float32 is judged in the program's
    place."""
    ref, lim = ctx.cell.reference, ctx.cell.limits
    M, K = xk.shape[0], xk.shape[1]
    S = kept_r.shape[0]
    chunk = max(1, STAGE_BLOCK // M)
    worst_r = worst_u = 0.0
    bad = torch.zeros(S, dtype=torch.bool, device=kept_r.device)
    with torch.no_grad():
        for lo in range(0, S, chunk):
            n = min(chunk, S - lo)
            xk_n, xi_n = xk.repeat(n, 1, 1), xi.repeat(n, 1)
            U_i = kept_w[lo:lo + n, 0, M * K:].reshape(n * M, 4)
            for st in range(3):
                W = kept_w[lo:lo + n, st]
                args = (xk_n, xi_n, W[:, :M * K].reshape(n * M, K, 4),
                        W[:, M * K:].reshape(n * M, 4), U_i, dt, st)
                r_ref, u_ref = ref.stage(*args)
                if ctx.judge == "control":
                    r_got, u_got = ref.stage(*args, dtype=torch.float32)
                else:
                    r_got = kept_r[lo:lo + n, st].reshape(n * M, 4)
                    u_got = (kept_w[lo:lo + n, st + 1, M * K:] if st < 2
                             else kept_w[lo + 1:lo + 1 + n, 0, M * K:]).reshape(n * M, 4)
                g_r = ref.gap(r_got, r_ref).reshape(n, M).amax(1)
                g_u = ref.gap(u_got, u_ref).reshape(n, M).amax(1)
                worst_r = max(worst_r, g_r.max().item())
                worst_u = max(worst_u, g_u.max().item())
                bad[lo:lo + n] |= ~(g_r <= lim["div_gap"]) | ~(g_u <= lim["u_gap"])
    ctx.failed = int(bad.sum())
    ctx.notes["checked_stages"] = 3 * S
    ctx.checks["div_gap"] = (worst_r, lim["div_gap"])
    ctx.checks["u_gap"] = (worst_u, lim["u_gap"])
