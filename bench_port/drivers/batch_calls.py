"""Driver "batch calls": one caller that fits a batch, waits for the result,
and fits the next, through ``wlsqm_tpu_torch.api.fit_many``.

Traffic parameters (``traffic/<name>.json``): ``cases`` a call; ``batches``
distinct input sets made at set-up from the seed and called in turn;
``route``: ``"plan"`` (``plan_fit_many`` once on ``plan_cases`` cases of
the same geometry drawn from ``plan_seed``, then ``fit_many(plan=)``; the
plan's route follows its planning cloud's worst case, so it is made from a
fixed seed, every run replays one route, and a plan whose route is not
the traffic's ``plan_route`` (path, assembly) stops the run) or a ``backend`` of
``fit_many`` (``"auto"``, ``"kernel"``, ``"engine"``); ``do_sens``; the
geometry of :func:`bench_port.lib.clouds.fit_batch`; ``sample_rows``: rows of
each call's result kept for the check.

End-to-end values: the cases of all calls over the window (each call ends
in a synchronise), under the cell's one end-to-end rate (every entry but
``setup_s``), and ``setup_s``.  After the window, each call's sampled rows
(drawn from the seed) are held against the configuration's reference: the
worst case's L∞ gap relative to max(|ref|, 1), as the cell's limits name
it: ``fi_gap`` (the gap itself), ``fi_over_bar`` (the gap over the case's
own bar, max(floor, cond_factor·u·κ) from the configuration's
``accuracy_bar``, κ the reference's condition of the case) and, with
sensitivities, ``sens_gap``.
"""

from __future__ import annotations

import statistics
import time

import torch

from bench_port.lib import bounds, clouds
from bench_port.lib.trace import WINDOW

ROW_SETS = 1024      # distinct row samples; call c keeps rows_table[c % ROW_SETS]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> None:
    import wlsqm_tpu_torch as wtt
    from wlsqm_tpu_torch import api
    from wlsqm_tpu_torch.fitter import condprobe, engine
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    cfg, dev, spans = ctx.cell.config, ctx.device, ctx.spans
    dim, order, K = cfg["dimension"], cfg["order"], cfg["k"]
    center = cfg["weighting"] == "center"
    B, nb, S = ctx.param("cases"), ctx.param("batches"), ctx.param("sample_rows")
    do_sens = bool(ctx.param("do_sens"))
    gen = clouds.generator(ctx.seed, dev)
    batches = [clouds.fit_batch(B, K, dim, ctx.cell.traffic, gen, dev) for _ in range(nb)]
    rows_table = torch.randint(0, B, (ROW_SETS, S), generator=gen, device=dev)
    kw = dict(order=order, weighting=wtt.WEIGHT_CENTER if center else wtt.WEIGHT_UNIFORM,
              do_sens=do_sens, device=dev)
    route = ctx.param("route")
    if route == "plan":
        # the plan is the deployment's, made once from a planning cloud of
        # the same traffic drawn from a fixed seed: every run replays it
        pxk, _, pxi = clouds.fit_batch(ctx.param("plan_cases"), K, dim, ctx.cell.traffic,
                                       clouds.generator(ctx.param("plan_seed"), dev), dev)
        plan = api.plan_fit_many(pxk, pxi, **kw)
        del pxk, pxi
        kw["plan"] = plan
        r = plan.route
        ctx.notes["route"] = {"path": r.path, "assembly": r.assembly,
                              "refine_steps": r.refine_steps}
        if [r.path, r.assembly] != ctx.param("plan_route"):
            raise RuntimeError("the plan from plan_seed %s routes to %s, not the cell's %s"
                               % (ctx.param("plan_seed"), ctx.notes["route"],
                                  ctx.param("plan_route")))
        refine = r.refine_steps if r.refine_steps is not None else fit_kernel.DEFAULT_REFINE_STEPS
        if r.path == "kernel" and r.assembly == "moments" and not do_sens:
            ctx.bounds["fit_moment"] = bounds.moment_launch(B, K, dim, order, center,
                                                            refine)["bound_ms"] / 1e3
        if r.path == "kernel" and r.assembly == "rows":
            ctx.bounds["fit_rows"] = bounds.rows_launch(B, K, dim, order, center, refine,
                                                        do_sens)["bound_ms"] / 1e3
    else:
        kw["backend"] = route
    fit_many = api.fit_many

    def call(b):
        xk, fk, xi = batches[b]
        with spans.span("api.fit_many"):
            return fit_many(xk, fk, xi, **kw)

    samples = []

    def keep(res, c):
        rows = rows_table[c % ROW_SETS]
        samples.append((c % nb, c % ROW_SETS, res.fi.index_select(0, rows),
                        res.sens.index_select(0, rows) if do_sens else None))

    with torch.no_grad():
        for b in range(nb):                       # warm-up: every batch's shapes once
            keep(call(b), b)
        _sync(dev)
        samples.clear()
        spans.wrap(condprobe, "probe", "condprobe.probe")
        spans.wrap(engine, "fit_batch", "engine.fit_batch", count=lambda xk, *a, **k: xk.shape[0])
        launches0 = (fit_kernel.LAUNCHES, fit_rows.LAUNCHES)
        ctx.trace.start()
        times = []
        t0 = time.perf_counter()
        ctx.values["setup_s"] = t0 - ctx.t_start
        deadline = t0 + ctx.seconds
        with torch.profiler.record_function(WINDOW):
            c = 0
            while True:
                c0 = time.perf_counter()
                res = call(c % nb)
                _sync(dev)
                c1 = time.perf_counter()
                times.append(c1 - c0)
                keep(res, c)
                c += 1
                if c1 >= deadline:
                    break
            _sync(dev)
        t1 = time.perf_counter()
        ctx.trace.stop()
        spans.unwrap()
        del res
    window_s = t1 - t0
    ctx.counts.update(calls=c, cases=c * B, window_s=window_s,
                      launches={"fit_moment": fit_kernel.LAUNCHES - launches0[0],
                                "fit_rows": fit_rows.LAUNCHES - launches0[1]})
    rate, = [m["name"] for m in ctx.cell.end_to_end if m["name"] != "setup_s"]
    ctx.values[rate] = c * B / window_s
    if dev.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    ctx.notes["ms_min_q1_median_q3_max"] = [1e3 * v for v in (min(times), *q, max(times))]
    ctx.attempted = c
    _check(ctx, batches, rows_table, samples, order=order, center=center, do_sens=do_sens)


def _check(ctx, batches, rows_table, samples, *, order, center, do_sens) -> None:
    """Hold every call's sampled rows against the reference, a batch at a
    time; under ``judge="control"`` the reference in float32 stands in
    the program's place on the same inputs."""
    ref, lim = ctx.cell.reference, ctx.cell.limits
    by_bar = "fi_over_bar" in lim
    if by_bar:
        bar = ctx.cell.config["accuracy_bar"]
        unit = torch.finfo(torch.float64).eps / 2
    worst = {k: 0.0 for k in lim}
    worst_gap, failed = 0.0, 0
    with torch.no_grad():
        for b, (xk, fk, xi) in enumerate(batches):
            mine = [s for s in samples if s[0] == b]
            if not mine:
                continue
            rows = rows_table[torch.tensor([s[1] for s in mine], device=rows_table.device)]
            flat = rows.reshape(-1)
            args = (xk.index_select(0, flat), fk.index_select(0, flat), xi.index_select(0, flat))
            fi_ref, sens_ref, *kappa = ref.fit_blocks(*args, order=order, center=center,
                                                      sens=do_sens, cond=by_bar)
            if ctx.judge == "control":
                fi_got, sens_got = ref.fit_blocks(*args, order=order, center=center,
                                                  sens=do_sens, dtype=torch.float32)
            else:
                fi_got = torch.cat([s[2] for s in mine])
                sens_got = torch.cat([s[3] for s in mine]) if do_sens else None
            n, S = len(mine), rows.shape[1]
            g = ref.gap(fi_got, fi_ref)
            worst_gap = max(worst_gap, g.max().item())
            got = {}
            if "fi_gap" in lim:
                got["fi_gap"] = g
            if by_bar:
                got["fi_over_bar"] = g / (bar["cond_factor"] * unit * kappa[0]).clamp_min(
                    bar["floor"])
            if do_sens:
                got["sens_gap"] = ref.gap(sens_got, sens_ref)
            bad = torch.zeros(n, dtype=torch.bool, device=g.device)
            for k, v in got.items():
                v = v.reshape(n, S).amax(1)
                bad |= ~(v <= lim[k])
                worst[k] = max(worst[k], v.max().item())
            failed += int(bad.sum())
    ctx.failed = failed
    ctx.notes["worst_gap"] = worst_gap
    for k in lim:
        ctx.checks[k] = (worst[k], lim[k])
