"""Smoke run of the PyTorch port on one NVIDIA card: build, check, time.

Builds both CUDA kernels from ``wlsqm_tpu_torch/csrc`` (one nvcc run per
source, started together), checks each against its plain torch version,
then drives three paths
through the port's public routes:

* the headline fit — 2D, order 4, K = 30, WEIGHT_CENTER, basic algorithm,
  the workload of bench.py — through ``plan_fit_many`` + ``fit_many(plan=)``
  on 2^23 cases (the moment kernel);
* the sens path — the same fit with ``do_sens=True`` (the ``sens`` row of
  benchmarks/run_regression_gate.py) on 2^21 cases (the rows kernel);
* the dim3 path — 3D, order 4, K = 48, WEIGHT_CENTER (the ``dim3`` row) on
  2^21 cases through ``fit_many(backend="kernel")`` (the rows kernel).

Each phase prints one line; the line before the last is the card's name and
power limit, the last ``{"ok": true, "device": {...}}``.  Any failed build,
launch or check raises, so the script exits non-zero and prints no result
line; so does a machine without a CUDA device.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py
"""

from __future__ import annotations

import concurrent.futures
import json
import re
import statistics
import subprocess
import sys
import time

import torch

B_MAIN = 1 << 23        # the "10M-point-scale" headline cloud of bench.py
B_ROWS = 1 << 21        # the sens and dim3 paths
B_CHECK = 65536         # kernel against its plain version, order 4 (2D, 3D)
B_GRID = 8191           # kernel against its plain version, the rest of the grid
B_PLAIN = 1 << 18       # the plain versions' intermediates cap their batch
B_ENGINE = 65536        # slice checked against the port's f64 engine
B_ENGINE_DIM3 = 16384
B_SWEEP = 16384         # 3D order-4 radius sweep, per radius
B_SCIPY = 1024          # slice checked against bench.parity_check (scipy f64)
K = 30
K_DIM3 = 48
K_GRID = {1: 16, 2: 30, 3: 56}
ORDER = 4
PARITY = 1e-10          # L∞ error relative to max(|ref|, 1), bench.parity_check's bar
REPS = 5                # timed repetitions after one warm-up; the median is reported
HBM_BYTES_S = 3.35e12   # H100 SXM data sheet: HBM3 bandwidth
FP64_FLOP_S = 67e12     # H100 SXM data sheet: FP64 peak (on the tensor cores)
COUNT_TV = 0.1          # ALGO_ITERATIVE counts: bar on the histograms' distance
RADII = (0.03, 0.1, 0.3, 1.0)


def _rel(a, b) -> float:
    """Worst per-case L∞ error relative to max(|ref|, 1)."""
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    return ((a - b).abs().amax(1) / b.abs().amax(1).clamp_min(1.0)).max().item()


def _rel_nan(a, b) -> float:
    """_rel, with NaN required at the same places in both."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise RuntimeError("NaN pattern differs")
    return _rel(torch.nan_to_num(a), torch.nan_to_num(b))


def _cloud(B, gen, dev, *, dim=2, K=K, order=ORDER, ragged=False, offset=False,
           radius=1.0, lo=None):
    """The bench workload (bench.py:102-108; the gate rows' in any
    dimension): xk uniform in radius·[-1, 1]^dim, fk = sin 3x cos 2y (y the
    last axis) + 0.01 noise.  ``ragged``: odd cases keep nk in [lo, K]
    (default lo = 1.5 NO) with NaN in the padded slots.  ``offset``: xi off
    zero."""
    xk = (torch.rand((B, K, dim), generator=gen, device=dev, dtype=torch.float64)
          * 2 - 1) * radius
    xi = torch.zeros((B, dim), device=dev, dtype=torch.float64)
    if offset:
        xi = (torch.rand((B, dim), generator=gen, device=dev, dtype=torch.float64)
              - 0.5) * 0.2
        xk += xi[:, None, :]
    fk = torch.sin(3.0 * xk[..., 0]) * torch.cos(2.0 * xk[..., -1])
    fk += 0.01 * torch.randn((B, K), generator=gen, device=dev, dtype=torch.float64)
    nk = torch.full((B,), K, dtype=torch.int32, device=dev)
    if ragged:
        from wlsqm_tpu_torch.fitter import defs

        if lo is None:
            lo = (3 * defs.number_of_dofs(dim, order)) // 2
        nk[1::2] = torch.randint(lo, K + 1, (B // 2,), generator=gen, device=dev,
                                 dtype=torch.int32)
        pad = torch.arange(K, device=dev)[None, :] >= nk[:, None]
        xk[pad] = torch.nan
        fk[pad] = torch.nan
    return xk, fk, nk, xi


def _time_ms(fn):
    """Median and spread of REPS CUDA-event timings after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def _ptxas_summary(log: str, pattern: str, fmt: str) -> dict:
    """Registers, stack and spill bytes of each kernel instance, from
    ``nvcc -Xptxas -v``; ``pattern`` matches the mangled template name."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(pattern, line)
        if m and "Compiling entry function" in line:
            name = fmt % m.groups()
            out[name] = {}
        elif name:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                     map(int, m.groups())))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


# -- operation and byte counts for the bounds --------------------------------

def _nnz(dim, order):
    from wlsqm_tpu_torch.fitter import defs, tables

    exp = tables.EXPONENTS[dim][:defs.number_of_dofs(dim, order)]
    return int(sum(max(int((row > 0).sum()) - 1, 0) for row in exp))


def _row_flops(dim, order, center):
    """One basis row as the rows kernel computes it: offsets, power ladder,
    monomial products, CENTER weight."""
    ladder = dim * min(max(order - 1, 0), 3)
    return 2 * dim + ladder + _nnz(dim, order) + ((2 * dim + 5) if center else 0)


def _chol_flops(NO):
    flops = 0
    for j in range(NO):
        flops += 2 * j + 2 + sum(2 * j + 1 for _ in range(j + 1, NO))
    return flops


def _rows_flops(dim, order, center, n, refine, do_sens, trips, n_known):
    """FP64 operations the rows body needs for cases with n valid neighbours
    (tensors of per-case n and executed ALGO_ITERATIVE trips), counted from
    the kernel's loops (a multiply-add is 2), with each neighbour's basis
    row and weight built once: the kernel rebuilds them in every K-loop,
    which is its design's cost, not the function's."""
    from wlsqm_tpu_torch.fitter import defs

    NO = defs.number_of_dofs(dim, order)
    NT = NO * (NO + 1) // 2
    solve = 2 * NO * NO
    sweep = 3 * NO + n * (4 * NO + 1) + solve + NO
    total = n * (_row_flops(dim, order, center) + (1 if center else 0))  # rows, max d²
    total = total + n * (2 * n_known + 3 * NO + 2 * NT)                  # assembly
    total = total + 2 * NO + 2 * NT + _chol_flops(NO) + NO + solve       # factor, solve
    total = total + refine * sweep + NO
    total = total + trips * (n * (5 * NO + 2) + 4 * NO + solve)
    if do_sens:
        total = total + n * (2 * NO + solve + refine * sweep)
    return float(total.sum())


def _moment_flops(order, center, n, refine):
    """FP64 operations of the 2D moment kernel, counted from its loops."""
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel

    NO = defs.number_of_dofs(2, order)
    NM = len(fit_kernel.moment_lattice(2, 2 * order)[0])
    NT = NO * (NO + 1) // 2
    solve = 2 * NO * NO
    per_k = 4 + (9 if center else 0) + 2 * NM + 2 * NO
    total = (n * 7 if center else 0) + n * per_k
    total = total + 2 * NO + 2 * NT + _chol_flops(NO) + NO + solve
    total = total + refine * (NO + 2 * NO * NO + 2 * NO + solve + NO) + NO
    return float(total.sum())


def _bound(tensors, flops):
    """The least time for the work: bytes (each tensor moved once) over the
    HBM rate, or FP64 operations over the FP64 rate, whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP64_FLOP_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _weighted_basis(xk, fk, nk, xi, dim, order, weighting):
    """√w·C (plain monomials of the prescaled offsets) and √w: the inputs of
    the library yardstick, built outside its timing."""
    from wlsqm_tpu_torch.fitter import engine
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    delta, kmask, _, inv_s = fit_kernel._prescale(xk, nk, xi)
    d = delta * inv_s[:, None, None]
    w = engine.neighbor_weights((d * d).sum(-1), kmask,
                                torch.tensor(weighting, device=xk.device))
    sw = w.sqrt()
    return fit_rows.basis_rows(d, dim, order) * sw[..., None], sw, torch.where(kmask, fk, 0.0)


# -- phases ---------------------------------------------------------------------

def phase_build():
    """Build both libraries, one nvcc run each, started together; print each
    ptxas report."""
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    jobs = {"fit_moment": fit_kernel.load, "fit_rows": fit_rows.load}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(fn) for name, fn in jobs.items()}
        libs = {name: f.result() for name, f in futures.items()}
    wall = time.perf_counter() - t0
    for name, lib in libs.items():
        if name == "fit_moment":
            ptxas = _ptxas_summary(lib.log, r"fit_moment_2dILi(\d+)ELi(\d+)E",
                                   "order%s_w%s")
        else:
            ptxas = _ptxas_summary(lib.log, r"fit_rowsILi(\d+)ELi(\d+)ELi(\d+)E",
                                   "d%s_order%s_w%s")
        print(json.dumps({"library": name, "nvcc_s": round(lib.build_seconds, 3),
                          "path": lib.path, "ptxas": ptxas}), flush=True)
    print(json.dumps({"build_wall_s": round(wall, 3), "parallel_nvcc": len(jobs)}),
          flush=True)


def phase_moment_vs_plain(dev, wtt):
    from wlsqm_tpu_torch.ops import fit_kernel

    gen = torch.Generator(device=dev).manual_seed(2026)
    worst_rel, worst_abs = 0.0, 0.0
    checks = [(ORDER, w, B_CHECK) for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER)]
    checks += [(o, w, B_GRID) for o in range(ORDER) for w in (wtt.WEIGHT_UNIFORM,
                                                            wtt.WEIGHT_CENTER)]
    per = {}
    for order, w, B in checks:
        xk, fk, nk, xi = _cloud(B, gen, dev, order=order, ragged=True, offset=True)
        got = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=order, weighting=w)
        ref = fit_kernel.fit_moments_plain(xk, fk, nk, xi, dimension=2, order=order,
                                           weighting=w)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("kernel gave non-finite DOFs at order %d weighting %d"
                               % (order, w))
        rel = _rel(got, ref)
        per["order%d_w%d_B%d" % (order, w, B)] = rel
        worst_rel = max(worst_rel, rel)
        worst_abs = max(worst_abs, (got - ref).abs().max().item())
        if rel > PARITY:
            raise RuntimeError("kernel vs plain at order %d weighting %d: %.3e > %.0e"
                               % (order, w, rel, PARITY))
    print(json.dumps({"fit_moment_vs_plain_rel": per, "worst_rel": worst_rel,
                      "worst_abs": worst_abs, "tol": PARITY}), flush=True)
    return worst_abs, worst_rel


def _count_check(equal, within, tv, total):
    """The ALGO_ITERATIVE count bar, pooled over a grid: >= 50% equal,
    >= 80% within one, and the per-configuration count histograms at most
    COUNT_TV apart (summed |difference| / 2, over all cases)."""
    return equal / total >= 0.5 and within / total >= 0.8 and tv / total <= COUNT_TV


def phase_rows_vs_plain(dev, wtt):
    """The rows kernel against its plain version over dims 1-3, orders 0-4,
    both weightings: with sens, with a random knowns mask (and sens), and
    with max_iter 3 (and the mask).

    Counts: exact-stagnation ties follow the last bit of the residual norms,
    which FMA contraction and the summation order move, so they are held
    pooled (_count_check; the 2D grid measured 57% equal and 88% within one
    on an H100).  Constant counts 1, 2 and max_iter are run through the same
    check as controls, and each must fail it.  Data fk = 0 has residual 0 at
    every trip, so there both versions must stop at the first repeat: count
    exactly 1, fi exactly 0.

    1D clouds keep nk >= 2 NO: at 1D order 4 with 7-9 random neighbours
    the fit is conditioned past what two f64 solvers agree on to 1e-10 (the
    f64 engine is off by up to 1.7e-8 from a 50-digit solve on such cases,
    the rows kernel and its plain version by 1-3e-10)."""
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_rows

    gen = torch.Generator(device=dev).manual_seed(2027)
    cpu_gen = torch.Generator().manual_seed(2027)
    worst_rel = worst_abs = 0.0
    MI = 3
    controls = (1, 2, MI)
    tally = {name: [0, 0, 0] for name in ("kernel", *("constant_%d" % c for c in controls))}
    total = 0
    per = {}
    for dim in (1, 2, 3):
        for order in range(ORDER + 1):
            NO = defs.number_of_dofs(dim, order)
            B = B_CHECK if order == ORDER and dim > 1 else B_GRID
            for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
                xk, fk, nk, xi = _cloud(B, gen, dev, dim=dim, K=K_GRID[dim], order=order,
                                        ragged=True, offset=True,
                                        lo=2 * NO if dim == 1 else None)
                fi0 = torch.randn((B, NO), generator=gen, device=dev, dtype=torch.float64)
                kn = int(torch.randint(0, 1 << NO, (1,), generator=cpu_gen))
                errs = []
                for knowns, sens, max_iter in ((0, True, 0), (kn, True, 0), (kn, False, MI)):
                    kw = dict(dimension=dim, order=order, weighting=w, knowns=knowns,
                              do_sens=sens, max_iter=max_iter)
                    got = fit_rows.fit_rows(xk, fk, nk, xi, fi0, **kw)
                    ref = fit_rows.fit_rows_plain(xk, fk, nk, xi, fi0, **kw)
                    torch.cuda.synchronize()
                    if not bool(torch.isfinite(got[0]).all()):
                        raise RuntimeError("rows kernel gave non-finite DOFs: %s" % (kw,))
                    KN = fit_rows.known_dofs(knowns, dim, order)
                    if not torch.equal(got[0][:, KN], fi0[:, KN]):
                        raise RuntimeError("known DOFs not restored exactly: %s" % (kw,))
                    pairs = [(got[0], ref[0])] + ([(got[2], ref[2])] if sens else [])
                    for a, b in pairs:
                        rel = _rel_nan(a, b)
                        errs.append(rel)
                        worst_rel = max(worst_rel, rel)
                        worst_abs = max(worst_abs, (torch.nan_to_num(a) - torch.nan_to_num(b))
                                        .abs().max().item())
                        if rel > PARITY:
                            raise RuntimeError("rows kernel vs plain %s: %.3e > %.0e"
                                               % (kw, rel, PARITY))
                    if max_iter:
                        it, rit = got[1].long(), ref[1].long()
                        if not (1 <= int(it.min()) and int(it.max()) <= max_iter):
                            raise RuntimeError("iteration counts out of range: %s" % (kw,))
                        hist = torch.bincount(rit, minlength=max_iter + 1)
                        for name, c in (("kernel", it), *(("constant_%d" % v,
                                                           torch.full_like(rit, v))
                                                          for v in controls)):
                            h = torch.bincount(c, minlength=max_iter + 1)
                            t = tally[name]
                            t[0] += int((c == rit).sum())
                            t[1] += int(((c - rit).abs() <= 1).sum())
                            t[2] += int((h - hist).abs().sum()) // 2
                        total += B
                        per["d%d_o%d_w%d_iters" % (dim, order, w)] = {
                            "kernel": torch.bincount(it, minlength=max_iter + 1)[1:].tolist(),
                            "plain": hist[1:].tolist()}
                        kw = dict(kw, knowns=0)
                        zero = fk * 0.0        # NaN stays in the padded slots
                        for fi_z, it_z, _ in (fit_rows.fit_rows(xk, zero, nk, xi, **kw),
                                              fit_rows.fit_rows_plain(xk, zero, nk, xi, **kw)):
                            if not (bool((it_z == 1).all()) and bool((fi_z == 0).all())):
                                raise RuntimeError("fk = 0 did not stop at the first "
                                                   "repeat: %s" % (kw,))
                per["d%d_o%d_w%d_B%d" % (dim, order, w, B)] = max(errs)
    counts = {name: {"equal": t[0] / total, "within_one": t[1] / total,
                     "histogram_distance": t[2] / total, "passes": _count_check(*t, total)}
              for name, t in tally.items()}
    print(json.dumps({"fit_rows_vs_plain_rel": per, "worst_rel": worst_rel,
                      "worst_abs": worst_abs, "tol": PARITY,
                      "iteration_counts_pooled": counts,
                      "iteration_bound": {"equal": 0.5, "within_one": 0.8,
                                          "histogram_distance": COUNT_TV}}), flush=True)
    if not counts["kernel"]["passes"]:
        raise RuntimeError("rows kernel iteration counts vs plain: %s" % (counts["kernel"],))
    if any(v["passes"] for k, v in counts.items() if k != "kernel"):
        raise RuntimeError("the count check passes a constant count: %s" % (counts,))
    return worst_abs, worst_rel


def phase_radius_sweep(dev, wtt):
    """3D order 4, K = 48, CENTER: the rows kernel against the port's engine
    and against its plain version at each radius.  Against the engine it is
    measured, not gated (the error grows with the condition number); against
    its plain version, which computes the same sums, it is held to PARITY at
    every radius (r = 1 is the dim3 path's cloud)."""
    from wlsqm_tpu_torch.ops import fit_rows

    gen = torch.Generator(device=dev).manual_seed(2028)
    out = {}
    for r in RADII:
        xk, fk, nk, xi = _cloud(B_SWEEP, gen, dev, dim=3, K=K_DIM3, radius=r)
        fi, _, _ = fit_rows.fit_rows(xk, fk, nk, xi, dimension=3, order=ORDER,
                                     weighting=wtt.WEIGHT_CENTER)
        plain, _, _ = fit_rows.fit_rows_plain(xk, fk, nk, xi, dimension=3, order=ORDER,
                                              weighting=wtt.WEIGHT_CENTER)
        eng = wtt.fit_many(xk, fk, xi, order=ORDER, weighting=wtt.WEIGHT_CENTER,
                           backend="engine", debug=True)
        out["r%g" % r] = {"vs_engine": _rel(fi, eng.fi), "vs_plain": _rel(fi, plain),
                          "engine_cond_scaled_median": eng.cond_scaled.median().item(),
                          "engine_cond_scaled_max": eng.cond_scaled.max().item()}
    print(json.dumps({"radius_sweep_3d_order4_K48": out, "B": B_SWEEP}), flush=True)
    bad = {r: v["vs_plain"] for r, v in out.items() if not v["vs_plain"] <= PARITY}
    if bad:
        raise RuntimeError("rows kernel vs plain on the radius sweep: %s > %.0e"
                           % (bad, PARITY))


def phase_headline(dev, wtt, parity_check):
    """The headline path at 2^23 through the moment kernel, and its times."""
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(42)
    xk, fk, nk, xi = _cloud(B_MAIN, gen, dev)
    plan = wtt.plan_fit_many(xk[:32768], xi[:32768], order=ORDER,
                             weighting=wtt.WEIGHT_CENTER)
    if (plan.route.path, plan.route.assembly) != ("kernel", "moments"):
        raise RuntimeError("the headline plan did not route to the moment kernel: %s"
                           % (plan,))
    inputs_gb = (xk.numel() + fk.numel() + xi.numel()) * 8 / 1e9
    fit_kernel.LAUNCHES = fit_rows.LAUNCHES = 0
    t0 = time.perf_counter()
    res = wtt.fit_many(xk, fk, xi, order=ORDER, weighting=wtt.WEIGHT_CENTER, plan=plan)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fit_kernel.LAUNCHES
    if launches < 1:
        raise RuntimeError("fit_many(plan=) did not launch the moment kernel")
    fi = res.fi
    if tuple(fi.shape) != (B_MAIN, 15) or not bool(torch.isfinite(fi).all()):
        raise RuntimeError("main path: bad DOFs, shape %s" % (tuple(fi.shape),))
    scipy_err = parity_check(xk[:B_SCIPY].cpu().numpy(), fk[:B_SCIPY].cpu().numpy(),
                             fi[:B_SCIPY].cpu().numpy())
    eng = wtt.fit_many(xk[:B_ENGINE], fk[:B_ENGINE], xi[:B_ENGINE], order=ORDER,
                       weighting=wtt.WEIGHT_CENTER, backend="engine").fi
    engine_err = _rel(fi[:B_ENGINE], eng)
    print(json.dumps({"path": "headline", "B": B_MAIN, "route": plan.route.path,
                      "assembly": plan.route.assembly,
                      "launches": {"fit_moment_2d": launches,
                                   "fit_rows": fit_rows.LAUNCHES},
                      "first_call_s": round(first_s, 4),
                      "inputs_outputs_gb": round(inputs_gb + fi.numel() * 8 / 1e9, 3),
                      "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
                      "parity_vs_scipy": scipy_err, "vs_engine": engine_err,
                      "tol": PARITY}), flush=True)
    if not (scipy_err <= PARITY and engine_err <= PARITY):
        raise RuntimeError("main path parity: scipy %.3e, engine %.3e > %.0e"
                           % (scipy_err, engine_err, PARITY))
    del res, eng, fi

    route_ms, route_t = _time_ms(lambda: wtt.fit_many(
        xk, fk, xi, order=ORDER, weighting=wtt.WEIGHT_CENTER, plan=plan))
    kernel_ms, kernel_t = _time_ms(lambda: fit_kernel.fit_kernel(
        xk, fk, nk, xi, dimension=2, order=ORDER, weighting=wtt.WEIGHT_CENTER))
    _, _, _, inv_s = fit_kernel._prescale(xk, nk, xi)
    out = torch.empty((B_MAIN, 15), dtype=torch.float64, device=dev)
    launch_args = (xk, fk, nk, xi, inv_s, out)
    launch_ms, launch_t = _time_ms(lambda: fit_kernel._launch(
        *launch_args, order=ORDER, weighting=wtt.WEIGHT_CENTER,
        refine_steps=fit_kernel.DEFAULT_REFINE_STEPS))
    full_bound = _bound(launch_args, _moment_flops(
        ORDER, True, nk.long(), fit_kernel.DEFAULT_REFINE_STEPS))
    del out, inv_s, launch_args
    s = slice(0, B_PLAIN)
    small = (xk[s], fk[s], nk[s], xi[s])
    small_ms, small_t = _time_ms(lambda: fit_kernel.fit_kernel(
        *small, dimension=2, order=ORDER, weighting=wtt.WEIGHT_CENTER))
    _, _, _, inv_s = fit_kernel._prescale(small[0], small[2], small[3])
    out = torch.empty((B_PLAIN, 15), dtype=torch.float64, device=dev)
    small_launch_ms, small_launch_t = _time_ms(lambda: fit_kernel._launch(
        *small, inv_s, out, order=ORDER, weighting=wtt.WEIGHT_CENTER,
        refine_steps=fit_kernel.DEFAULT_REFINE_STEPS))
    small_bound = _bound((*small, inv_s, out), _moment_flops(
        ORDER, True, small[2].long(), fit_kernel.DEFAULT_REFINE_STEPS))
    plain_ms, plain_t = _time_ms(lambda: fit_kernel.fit_moments_plain(
        *small, dimension=2, order=ORDER, weighting=wtt.WEIGHT_CENTER))
    A, sw, fkm = _weighted_basis(*small, 2, ORDER, wtt.WEIGHT_CENTER)
    rhs = (sw * fkm)[..., None]
    library_ms, library_t = _time_ms(lambda: torch.linalg.lstsq(A, rhs))
    del A, rhs, sw, fkm, out, inv_s
    print(json.dumps({
        "path": "headline",
        "fits_per_s": {"fit_many_plan_2^23": B_MAIN / route_ms * 1e3,
                       "fit_kernel_2^23": B_MAIN / kernel_ms * 1e3,
                       "kernel_launch_only_2^23": B_MAIN / launch_ms * 1e3,
                       "fit_kernel_2^18": B_PLAIN / small_ms * 1e3,
                       "fit_moments_plain_2^18": B_PLAIN / plain_ms * 1e3},
        "ms": {"fit_many_plan_2^23": route_t, "fit_kernel_2^23": kernel_t,
               "kernel_launch_only_2^23": launch_t, "fit_kernel_2^18": small_t,
               "kernel_launch_only_2^18": small_launch_t,
               "fit_moments_plain_2^18": plain_t,
               "library_lstsq_2^18": library_t},
        "bound_2^23": full_bound, "bound_2^18": small_bound,
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}), flush=True)
    return {"launches": launches, "ms": small_launch_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **small_bound}


def phase_sens(dev, wtt, parity_check):
    """The sens path at 2^21 through plan_fit_many(do_sens=True) +
    fit_many(plan=, do_sens=True): the rows kernel, and its times."""
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(43)
    xk, fk, nk, xi = _cloud(B_ROWS, gen, dev)
    kw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER, do_sens=True)
    plan = wtt.plan_fit_many(xk[:32768], xi[:32768], **kw)
    if (plan.route.path, plan.route.assembly) != ("kernel", "rows"):
        raise RuntimeError("the sens plan did not route to the rows kernel: %s" % (plan,))
    fit_kernel.LAUNCHES = fit_rows.LAUNCHES = 0
    t0 = time.perf_counter()
    res = wtt.fit_many(xk, fk, xi, plan=plan, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fit_rows.LAUNCHES
    if launches < 1:
        raise RuntimeError("fit_many(plan=, do_sens=True) did not launch the rows kernel")
    fi, sens = res.fi, res.sens
    if (tuple(fi.shape) != (B_ROWS, 15) or tuple(sens.shape) != (B_ROWS, K, 15)
            or not bool(torch.isfinite(fi).all()) or not bool(torch.isfinite(sens).all())):
        raise RuntimeError("sens path: bad outputs, shapes %s %s"
                           % (tuple(fi.shape), tuple(sens.shape)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = slice(0, B_ENGINE)
    eng = wtt.fit_many(xk[s], fk[s], xi[s], backend="engine", **kw)
    fi_err, sens_err = _rel(fi[s], eng.fi), _rel(sens[s], eng.sens)
    scipy_err = parity_check(xk[:B_SCIPY].cpu().numpy(), fk[:B_SCIPY].cpu().numpy(),
                             fi[:B_SCIPY].cpu().numpy())
    print(json.dumps({"path": "sens", "B": B_ROWS, "route": plan.route.path,
                      "assembly": plan.route.assembly,
                      "launches": {"fit_moment_2d": fit_kernel.LAUNCHES,
                                   "fit_rows": launches},
                      "first_call_s": round(first_s, 4),
                      "fi_vs_engine": fi_err, "sens_vs_engine": sens_err,
                      "fi_vs_scipy": scipy_err, "tol": PARITY,
                      "peak_mem_gb": round(peak_gb, 3)}), flush=True)
    if max(fi_err, sens_err, scipy_err) > PARITY:
        raise RuntimeError("sens path parity: fi %.3e, sens %.3e, scipy %.3e > %.0e"
                           % (fi_err, sens_err, scipy_err, PARITY))
    del res, eng, fi, sens
    return _rows_times(dev, wtt, "sens", (xk, fk, nk, xi), plan=plan, dim=2,
                       do_sens=True, launches=launches)


def phase_dim3(dev, wtt):
    """The dim3 path at 2^21 through fit_many(backend="kernel"): K = 48 is
    under the auto route's K >= 1.5 NO = 52, which keeps such groups on the
    engine as the JAX package does, so the path asks for the kernel as the
    gate row calls fit_pallas directly."""
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(44)
    xk, fk, nk, xi = _cloud(B_ROWS, gen, dev, dim=3, K=K_DIM3)
    kw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER)
    auto = wtt.plan_fit_many(xk[:32768], xi[:32768], **kw).route
    fit_kernel.LAUNCHES = fit_rows.LAUNCHES = 0
    t0 = time.perf_counter()
    res = wtt.fit_many(xk, fk, xi, backend="kernel", **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fit_rows.LAUNCHES
    if launches < 1 or fit_kernel.LAUNCHES:
        raise RuntimeError("the dim3 path did not run on the rows kernel alone")
    fi = res.fi
    if tuple(fi.shape) != (B_ROWS, 35) or not bool(torch.isfinite(fi).all()):
        raise RuntimeError("dim3 path: bad DOFs, shape %s" % (tuple(fi.shape),))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = slice(0, B_ENGINE_DIM3)
    err = _rel(fi[s], wtt.fit_many(xk[s], fk[s], xi[s], backend="engine", **kw).fi)
    print(json.dumps({"path": "dim3", "B": B_ROWS, "route": "kernel (backend='kernel')",
                      "auto_plan_route": auto.path, "launches": {
                          "fit_moment_2d": fit_kernel.LAUNCHES, "fit_rows": launches},
                      "first_call_s": round(first_s, 4), "fi_vs_engine": err,
                      "tol": PARITY, "peak_mem_gb": round(peak_gb, 3)}), flush=True)
    if err > PARITY:
        raise RuntimeError("dim3 path parity: %.3e > %.0e" % (err, PARITY))
    del res, fi
    return _rows_times(dev, wtt, "dim3", (xk, fk, nk, xi), plan=None, dim=3,
                       do_sens=False, launches=launches)


def _rows_times(dev, wtt, name, data, *, plan, dim, do_sens, launches):
    """Route, fit_rows and launch at 2^21; fit_rows, launch, plain and the
    library yardstick at 2^18; the bounds at both sizes."""
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    xk, fk, nk, xi = data
    NO = defs.number_of_dofs(dim, ORDER)
    W, RS = wtt.WEIGHT_CENTER, fit_rows.DEFAULT_REFINE_STEPS
    kw = dict(order=ORDER, weighting=W)
    if plan is not None:
        route = lambda: wtt.fit_many(xk, fk, xi, plan=plan, do_sens=do_sens, **kw)  # noqa: E731
    else:
        route = lambda: wtt.fit_many(xk, fk, xi, backend="kernel", **kw)  # noqa: E731
    times, bounds = {}, {}
    times["route_2^21"] = _time_ms(route)
    times["fit_rows_2^21"] = _time_ms(lambda: fit_rows.fit_rows(
        xk, fk, nk, xi, dimension=dim, do_sens=do_sens, **kw))

    def launcher(d):
        B, Kd = d[0].shape[:2]
        _, _, _, inv_s = fit_kernel._prescale(d[0], d[2], d[3])
        out = torch.empty((B, NO), dtype=torch.float64, device=dev)
        sens = torch.empty((B, Kd, NO), dtype=torch.float64, device=dev) if do_sens else None
        args = (*d, inv_s, None, out, None, sens)
        flops = _rows_flops(dim, ORDER, True, d[2].long(), RS, do_sens, 0, 0)
        return (lambda: fit_rows._launch(*args, order=ORDER, weighting=W, knowns=0,
                                         refine_steps=RS, max_iter=0)), _bound(args, flops)

    fn, bounds["2^21"] = launcher(data)
    times["launch_2^21"] = _time_ms(fn)
    del fn
    if do_sens:   # the same launch without sens: what the sensitivities cost
        _, _, _, inv_s = fit_kernel._prescale(xk, nk, xi)
        out = torch.empty((xk.shape[0], NO), dtype=torch.float64, device=dev)
        times["launch_no_sens_2^21"] = _time_ms(lambda: fit_rows._launch(
            xk, fk, nk, xi, inv_s, None, out, None, None, order=ORDER, weighting=W,
            knowns=0, refine_steps=RS, max_iter=0))
        del out, inv_s
    s = slice(0, B_PLAIN)
    small = tuple(t[s] for t in data)
    times["fit_rows_2^18"] = _time_ms(lambda: fit_rows.fit_rows(
        *small, dimension=dim, do_sens=do_sens, **kw))
    fn, bounds["2^18"] = launcher(small)
    times["launch_2^18"] = _time_ms(fn)
    del fn
    times["plain_2^18"] = _time_ms(lambda: fit_rows.fit_rows_plain(
        *small, dimension=dim, do_sens=do_sens, **kw))
    A, sw, fkm = _weighted_basis(*small, dim, ORDER, W)
    rhs = (sw * fkm)[..., None]
    if do_sens:   # fi and sensᵀ = (CᵀWC)⁻¹CᵀW in one call: [√w·fk, diag(√w)]
        rhs = torch.cat([rhs, torch.diag_embed(sw)], dim=2)
    times["library_lstsq_2^18"] = _time_ms(lambda: torch.linalg.lstsq(A, rhs))
    del A, rhs, sw, fkm
    med = {k: v[0] for k, v in times.items()}
    print(json.dumps({
        "path": name, "ms": {k: v[1] for k, v in times.items()},
        "fits_per_s": {k: (B_ROWS if k.endswith("2^21") else B_PLAIN) / v * 1e3
                       for k, v in med.items()},
        "bound_2^21": bounds["2^21"], "bound_2^18": bounds["2^18"],
        "achieved_gb_s_launch_2^21": bounds["2^21"]["bytes"] / med["launch_2^21"] / 1e6,
        "library": "torch.linalg.lstsq on the prebuilt sqrt(w)-weighted basis "
                   "(basis build excluded)",
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}), flush=True)
    return {"launches": launches, "ms": med["launch_2^18"], "plain_ms": med["plain_2^18"],
            "library_ms": med["library_lstsq_2^18"], **bounds["2^18"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1
    import wlsqm_tpu_torch as wtt
    from bench import parity_check

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print("device: %s, count %d, torch %s, CUDA %s"
          % (kind, torch.cuda.device_count(), torch.__version__, torch.version.cuda))
    print(smi.splitlines()[0], flush=True)
    t_start = time.perf_counter()

    phase_build()
    m_abs, m_rel = phase_moment_vs_plain(dev, wtt)
    r_abs, r_rel = phase_rows_vs_plain(dev, wtt)
    phase_radius_sweep(dev, wtt)
    torch.cuda.empty_cache()
    moment = phase_headline(dev, wtt, parity_check)
    torch.cuda.empty_cache()
    sens = phase_sens(dev, wtt, parity_check)
    torch.cuda.empty_cache()
    dim3 = phase_dim3(dev, wtt)

    def entry(name, source, replaces, abs_err, rel_err, t, config):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": t["launches"], "max_abs_err": abs_err, "max_rel_err": rel_err,
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "batch": B_PLAIN, "config": config}

    print(json.dumps({"kernels": [
        entry("fit_moment_2d", "wlsqm_tpu_torch/csrc/fit_moment.cu",
              "wlsqm_tpu/ops/pallas_fit.py:438", m_abs, m_rel, moment,
              "headline: 2D order 4 K=30 CENTER"),
        entry("fit_rows", "wlsqm_tpu_torch/csrc/fit_rows.cu",
              "wlsqm_tpu/ops/pallas_fit.py:901", r_abs, r_rel, sens,
              "sens: 2D order 4 K=30 CENTER do_sens"),
    ], "fit_rows_dim3": dim3, "total_s": round(time.perf_counter() - t_start, 1)}),
        flush=True)
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
