"""Smoke run of the PyTorch port on one NVIDIA card: build, check, time.

Builds the CUDA kernels from ``wlsqm_tpu_torch/csrc`` (nine libraries from
three sources — the moment kernel's one per dimension and the rows
kernel's, each without and with its conditioning key, and the gather —
one nvcc run each, started together with the g++ build of the native k-d
tree), checks each against its plain torch
version (both bodies of each fit kernel, the moment kernel over dims 1-3,
orders 0-4, knowns and ALGO_ITERATIVE; every instance of the gather),
then drives the port's paths through its public routes:

* the headline fit — 2D, order 4, K = 30, WEIGHT_CENTER, basic algorithm,
  the workload of bench.py — through ``plan_fit_many`` + ``fit_many(plan=)``
  on 2^23 cases (the moment kernel);
* the iterative path — the same fit with ALGO_ITERATIVE, max_iter = 3 (the
  ``iterative`` row of benchmarks/run_regression_gate.py) on 2^23 cases
  through ``plan_fit_many(iterative=True)`` + ``fit_many(plan=)`` (the
  moment kernel);
* the sens path — the same fit with ``do_sens=True`` (the ``sens`` row)
  on 2^21 cases (the rows kernel's warp body);
* the dim3 path — 3D, order 4, K = 48, WEIGHT_CENTER (the ``dim3`` row) on
  2^21 cases through ``fit_many(backend="kernel")`` (the moment kernel's
  warp body; the rows kernel timed beside it on the same cloud);
* the dim3_thread path — 3D, order 2, K = 48, WEIGHT_CENTER on 2^21 cases
  the same way (the moment kernel's 3D thread body; the rows kernel's
  thread body, which the certified route runs there, timed beside it);
* the dim1 path — the reference's configuration 3, 1D half (order 4,
  K = 15, WEIGHT_UNIFORM; benchmarks/run_configs.py l.117-128) on 2^23
  cases through ``plan_fit_many`` + ``fit_many(plan=)`` (the moment
  kernel's 1D thread body with its key, the engine for the tail), then at
  max_iter = 3 through the route ``fit_1D_iterative_many`` takes without
  count fidelity;
* the IBVP heat step — the ``gather`` row (l.238-289) on a 2^22-point
  Morton-ordered cloud, K = 28: ``prepare`` once, then per step
  ``gather_rows`` (the gather kernel) + ``solve`` + update, one field and
  three; then the heat example ``wlsqm_tpu_torch.examples.ibvp_heat``;
* the compat surface — ``ExpertSolver`` on the gate row's expert cloud
  (benchmarks/run_regression_gate.py l.202-225) at 2^20 cases: prepare, 8
  NumPy solves on the prepared factor (no kernel launch), its device time
  against the two kernel routes on the same geometry, the data-gated route
  held to the long-double oracle on every case it keeps on the kernel,
  ``solve_device``, ``solve_stream``, the estimated conditions, and the gate
  row's rate at 8,192 cases; then ``fit_2D_many`` (the moment kernel under
  the data gate), ``fit_3D_many`` with sens and a known DOF (the rows
  kernel), ``fit_1D_iterative_many`` with and without count fidelity, and
  ``fit_2D``;
* the certified auto route — 2D, order 4, K = 30, WEIGHT_CENTER on 2^22
  cases whose radius is log-uniform in [0.1, 1] with 5% near-collinear
  neighbourhoods (over [0.03, 1], the calibration sweep's range, fewer than
  half the cases certify and the plan is the engine: planned and printed):
  ``plan_fit_many`` (probe, ladder, the key on every planning case),
  ``fit_many(plan=)`` (the per-case split: the moment
  kernel with its key for all, the f64 engine for the tail window),
  ``fit_many(backend="auto")`` (the eager split), and the same with a known
  DOF (the rows kernel with its key); held against a long-double-refined
  oracle, after ``calibrate_device`` has measured the card's units anew and
  held the shipped record to them; then the moment kernel's new certified
  configurations (1D order 4 and 2D order 4 ALGO_ITERATIVE, 2D order 4 with
  the value known) against the same oracle;
* the examples — the Euler flow step of ``wlsqm_tpu_torch.examples.
  euler_flow`` at n = 2^22, K = 24, order 3, 8 flux fields (three
  ``gather_rows`` launches and three multi-field solves a step; its
  set-up, ms per step and split, density error and peak memory beside the
  heat step's figures) and the example's own run; the adjoint recovery of
  ``adjoint_data_recovery`` (a rows launch with sens a step) on its own grid
  and at B = 2^20 against the engine's gradient; and the other examples
  (``gradient_stencil_design``, ``response_surface``, ``wlsqm_tour``,
  ``expertsolver_example``, ``distributed_pipeline``,
  ``jit_plan_sharding``, ``drivers_benchmark``) at their own sizes on the
  card.

Each phase prints one line; the line before the last is the card's name and
power limit, the last ``{"ok": true, "device": {...}}``.  Any failed build,
launch or check raises, so the script exits non-zero and prints no result
line; so does a machine without a CUDA device.  ``measure_rows_cut``,
``measure_gather_variants`` and ``measure_moment_variants``, run by hand,
time the designs that the kernels were chosen from; ``measure_moment_units``
ties the moment body's calibration units to its arithmetic, and
``measure_auto_route`` times the certified route against another checkout;
``measure_engine_batch_invariance`` finds where the f64 engine's bits depend
on the batch they are computed in; ``measure_moment_phases`` splits a moment
kernel case's cycles by phase (a build with its phase clock),
``measure_moment_paths`` times the dim3 and iterative launches against
another checkout and compares their bits, and ``measure_warp_residency``
times the moment kernel's warp body at other counts of resident cases;
``measure_rows_phases`` splits a rows-kernel case's cycles by phase (both
bodies), and ``measure_rows_paths`` and ``measure_gather_paths`` time the rows and gather
launches against another checkout (the rows outputs' bits compared);
``measure_count_ties`` sorts the rows kernel's ALGO_ITERATIVE count
disagreements with its plain version into exact-stagnation ties and the
rest (a build that writes each trip's residual norm).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN = 1 << 23        # the "10M-point-scale" headline cloud of bench.py
B_ROWS = 1 << 21        # the sens and dim3 paths
B_CHECK = 65536         # kernel against its plain version, order 4 (2D, 3D)
B_GRID = 8191           # kernel against its plain version, the rest of the grid
B_MOMENT_GRID = 1 << 14  # the moment kernel's grid of dims, orders, knowns, max_iter
B_PLAIN = 1 << 18       # the plain versions' intermediates cap their batch
B_ENGINE = 65536        # slice checked against the port's f64 engine
B_ENGINE_DIM3 = 16384
B_SWEEP = 16384         # 3D order-4 radius sweep, per radius
B_SCIPY = 1024          # slice checked against parity_check (scipy f64)
B_CERT = 1 << 22        # the certified auto route
B_CERT_ROWS = 1 << 20   # ... its rows-kernel part (a known DOF)
B_CERT_NEW = 1 << 20    # the certified route on the moment kernel's new configurations
B_PLAN = 32768          # cases a plan is made from
B_ORACLE = 8192         # sample held against the long-double-refined oracle
B_EXPERT = 1 << 20      # ExpertSolver: the Prepared is ~6 GB (c 3.8, factor 1.9)
B_GATE_EXPERT = 8192    # ... the gate row's own size (its solves/s)
B_CONDS = 65536         # ... conds(estimate=True) against the SVD conditions
B_COMPAT_2D = 1 << 20   # fit_2D_many
B_GRAD = 1 << 18        # gradients through the route, headline and sens
B_STREAM = 1 << 24      # fit_stream's host cloud: ~12 GB of NumPy
CHUNK_STREAM = 1 << 21  # ... its chunk
B_SHARD = 1 << 22       # sharded_fit_pallas, headline
B_SHARD_ENGINE = 1 << 20  # sharded_fit_many (the engine: at 2^22 its temporaries pass 80 GB)
B_SERIAL = 1 << 16      # a Prepared through npz and back
B_COMPAT = 65536        # fit_3D_many with sens, fit_1D_iterative_many
B_COND2 = 4096          # keys held against cond_2 by SVD
KEY_EPS = 2.0 ** -50    # kernel vs plain past the certified key edge: KEY_EPS * key,
KEY_CAP = 1e-9          # ... at most KEY_CAP, and the kernel no farther from the
ORACLE_FACTOR = 4.0     # oracle than ORACLE_FACTOR times the plain version (or PARITY)
COND_FACTOR = 8.0       # dim1: a case's error against the oracle, in u times its componentwise
                        # condition (_cond_1d): sound f64 solves read up to 2.06 on an H100,
                        # the first-order bound of a 15-term sum is 15
KEY_TOL = 1e-6          # kernel key vs plain key, relative (its own sensitivity
                        # is ~cond * 2^-53)
COLLINEAR = 0.05        # share of near-collinear cases on the certified route
SQUEEZE = 1e-3          # their neighbours' extent across a random direction
RADII_CERT = (0.1, 1.0)   # its radii, log-uniform: about two cases in three certify
RADII_WIDE = (0.03, 1.0)  # the calibration sweep's range: a minority certifies
K = 30
K_DIM3 = 48
K_GRID = {1: 16, 2: 30, 3: 56}
K_SLAB_EDGE = (151, 152)  # moment kernel: the slabs, 64 (2K + 1 + (K | 1)) doubles, fill
                         # the H100's 227 KB a block at K = 151 (staged); 152 is not
K_SLAB_EDGE_3D = (151, 152)  # ... in 3D (the thread body, orders 0-2, which stages xk's slab
                             # alone): 64 (3K | 1) doubles
K_WIDE = 130            # the warp body's configurations again: five chunks of 32, the
                        # last ragged
ROWS_STAGE_EDGE = {1: 85, 2: 63, 3: 51}  # the largest K whose offsets the rows thread body
                        # stages with sens (csrc/fit_rows.cu thread_layout: K (dim + 2) <= 255)
K_DIM1 = 15             # the dim1 path: the reference's configuration 3, 1D half (order 4)
ORDER_DIM3_THREAD = 2   # the dim3_thread path: 3D order 2 at K_DIM3 (the moment thread body)
COUNT_TIE_ULPS = 4      # a count tie: one side's norm repeats, the other's moves <= this many ulps
ORDER = 4
PARITY = 1e-10          # L∞ error relative to max(|ref|, 1), parity_check's bar
REPS = 5                # timed repetitions after one warm-up; the median is reported
HBM_BYTES_S = 3.35e12   # H100 SXM data sheet: HBM3 bandwidth
FP64_FLOP_S = 67e12     # H100 SXM data sheet: FP64 peak (on the tensor cores)
MOMENT_SPILL_BYTES = 400  # ptxas spill stores or loads a 2D basic fit_moment instance may show:
                          # the order-4 instances' level (PERF.md); more fails the run
MAX_ITER = 3            # the iterative path's max_iter (the gate row's)
COUNT_TV = 0.1          # ALGO_ITERATIVE counts: bar on the histograms' distance
COUNT_SLACK = 0.01      # ... kernel vs plain, each against the JAX engine's counts
RADII = (0.03, 0.1, 0.3, 1.0)
N_IBVP = 1 << 22        # the IBVP cloud (the gather gate row's 20,480 points, grown)
K_IBVP = 28             # neighbours per case, self included (the gate row's)
STEPS = 32              # steps per timed IBVP run (the gate row's)
DT_NU = 1e-5            # the gate row's dt * nu
N_EULER_SIDE = 2048     # the Euler example's cloud grown to nside^2 = 2^22 points
EULER_STEPS = 4         # SSP-RK3 steps per timed Euler run
ADJ_SIDE = 1024         # the adjoint example's grid grown to 1024 x 1024 = 2^20
EX2 = np.array([0, 1, 0, 2, 1, 0])   # 2D order-2 DOF exponents (F X Y X2 XY Y2)
EY2 = np.array([0, 0, 1, 0, 1, 2])


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


def parity_check(xk, fk, fi_dev):
    """L∞ error relative to max(|ref|, 1) of the DOFs of the 2D order-4
    CENTER fit (xi = 0) against scipy's f64 symmetric solve of the normal
    equations, case by case: the JAX package's benchmark check
    (bench.py:274-296), kept here so that this script reads nothing of it."""
    from math import factorial

    import scipy.linalg

    ex = np.array([0, 1, 0, 2, 1, 0, 3, 2, 1, 0, 4, 3, 2, 1, 0])
    ey = np.array([0, 0, 1, 0, 1, 2, 0, 1, 2, 3, 0, 1, 2, 3, 4])
    invf = np.array([1.0 / (factorial(a) * factorial(b)) for a, b in zip(ex, ey)])
    worst = 0.0
    for j in range(xk.shape[0]):
        c = (xk[j][:, 0:1] ** ex) * (xk[j][:, 1:2] ** ey) * invf
        d2 = (xk[j] ** 2).sum(1)
        t = 1.0 - np.sqrt(d2 / d2.max())
        w = 1e-4 + (1.0 - 1e-4) * t * t
        A = c.T @ (w[:, None] * c)
        b = c.T @ (w * fk[j])
        ref = scipy.linalg.solve(A, b, assume_a="sym")
        scale = max(np.abs(ref).max(), 1.0)
        worst = max(worst, np.abs(ref - fi_dev[j]).max() / scale)
    return worst


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


def _ptxas_summary(log: str) -> dict:
    """Registers, stack and spill bytes of each kernel instance, from
    ``nvcc -Xptxas -v``, keyed by the template's name and arguments."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"\d+((?:fit|gather)_[a-z_0-9]+?)(?:I((?:L[a-z]+\d+E)+)E|E)", line)
        if m and "Compiling entry function" in line:
            name = "%s<%s>" % (m.group(1), ",".join(re.findall(r"L[a-z]+(\d+)E",
                                                               m.group(2) or "")))
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


def _moment_flops(order, center, n, refine, dim=2, iters=None, max_iter=0, n_known=0):
    """FP64 operations the moment kernel needs, counted from its loops, for
    cases with n valid neighbours (a tensor): per neighbour the offsets, the
    CENTER weight, the power ladders, and for each moment and RHS entry one
    add (1D) or one product of two ladders and an add (2D, 3D); in 3D the
    x^a y^b products that the z ladder multiplies are made once per
    neighbour (those with a, b >= 1: the others are ladder entries), as
    the warp body makes them (the thread body makes one per moment, its
    design's cost, not the function's); the known values' pass; the factor,
    the solve and the sweeps; with ``iters`` (the per-case ALGO_ITERATIVE
    counts) each trip's residual pass (min(iters + 1, max_iter) of them)
    and each refit's sweep."""
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel

    NO = defs.number_of_dofs(dim, order)
    NM = len(fit_kernel.moment_lattice(dim, 2 * order)[0])
    NT = NO * (NO + 1) // 2
    solve = 2 * NO * NO
    sums = (NM + NO) * (1 if dim == 1 else 2)
    if dim == 3:
        sums += order * (2 * order - 1)      # a, b >= 1, a + b <= 2 order
    per_k = 2 * dim + ((2 * dim - 1 + 6) if center else 0) + (2 * dim * order + order + 1) + sums
    total = (n * (4 * dim - 1) if center else 0) + n * per_k
    total = total + 2 * n_known * NO
    sweep = NO + 2 * NO * NO + 2 * NO + solve + NO
    total = total + 2 * NO + 2 * NT + _chol_flops(NO) + NO + solve
    total = total + refine * sweep + NO
    if iters is not None:
        passes = torch.clamp(iters.long() + 1, max=max_iter)
        total = total + passes * n * (2 * dim + dim * order + _nnz(dim, order) + 2 * NO + 2)
        total = total + iters.long() * sweep
    return float(total.sum())


def _cond_flops(NO, body):
    """FP64 operations of the conditioning key per case, from the kernels'
    loops: the NO^2 row-sum terms (the moment body scales each entry on the
    fly), NO reciprocals, and per unit column e_i a forward and a backward
    substitution from row i, with the squares."""
    total = (4 if body == "moments" else 2) * NO * NO + NO
    for i in range(NO):
        for r in range(i, NO):
            total += 2 * (r - i) + 1            # forward row r
            total += 2 * (NO - 1 - r) + 1 + 3   # backward row r, x^2 into the sum
    return total + 2


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
    """Build the five libraries and the host k-d tree, one compiler run each,
    started together (``warmup.build_all``); print each ptxas report."""
    from wlsqm_tpu_torch.warmup import build_all

    t0 = time.perf_counter()
    libs = build_all()
    wall = time.perf_counter() - t0
    if libs["kdtree"] is None:
        raise RuntimeError("the native k-d tree is not available here (no g++)")
    for name, lib in libs.items():
        print(json.dumps({"library": name, "build_s": round(lib.build_seconds, 3),
                          "path": lib.path, "ptxas": _ptxas_summary(lib.log)}), flush=True)
    print(json.dumps({"build_wall_s": round(wall, 3), "parallel_builds": len(libs)}),
          flush=True)
    # indirect branches in the moment kernel: a table switch the compiler
    # left to run time (the key's row sums once cost 4-5x the fit that way);
    # every instance of every dimension, with and without the key
    brx = {name: _indirect_branches(lib.path) for name, lib in libs.items()
           if name.startswith("fit_moment")}
    print(json.dumps({"fit_moment_indirect_branches": brx}), flush=True)
    if sum(len(per) for per in brx.values()) != 2 * (30 + 30 + 22):
        raise RuntimeError("phase_build found %s moment instances, not 164" % (
            {k: len(v) for k, v in brx.items()},))
    if any(n for per in brx.values() for n in per.values()):
        raise RuntimeError("fit_moment has indirect branches (BRX): %s" % (brx,))
    # the 2D ALGO_ITERATIVE instances (without knowns) spill no more than the
    # basic ones may (phase_headline holds those), without and with the key
    iterative = {name: {k: v for k, v in _ptxas_summary(libs[name].log).items()
                        if re.fullmatch(r"fit_moment_thread<2,\d,\d,2>", k)}
                 for name in ("fit_moment_d2", "fit_moment_d2_cond")}
    worst = max(max(v.get("spill_stores", 0), v.get("spill_loads", 0))
                for per in iterative.values() for v in per.values())
    print(json.dumps({"fit_moment_iterative_2d_ptxas": iterative,
                      "fit_moment_iterative_2d_worst_spill_bytes": worst,
                      "limit": MOMENT_SPILL_BYTES}), flush=True)
    if len(iterative["fit_moment_d2"]) != 10 or worst > MOMENT_SPILL_BYTES:
        raise RuntimeError("the 2D ALGO_ITERATIVE fit_moment instances spill %d bytes (> %d), "
                           "or are not 10: %s" % (worst, MOMENT_SPILL_BYTES, iterative))
    # the 1D and 3D thread body's basic and ALGO_ITERATIVE instances
    # beside the instance with knowns and ALGO_ITERATIVE that ran every mode
    # before them: a basic instance spills no more than it on its (order,
    # weighting)
    split, worse = {}, []
    for name in ("fit_moment_d1", "fit_moment_d1_cond", "fit_moment_d3", "fit_moment_d3_cond"):
        per = _ptxas_summary(libs[name].log)
        for inst, v in per.items():
            m = re.fullmatch(r"fit_moment_thread<(\d),(\d),(\d),([012])>", inst)
            if not m:
                continue
            split.setdefault(name, {})[inst] = v
            spill = v.get("spill_stores", 0) + v.get("spill_loads", 0)
            merged = per["fit_moment_thread<%s,%s,%s,1>" % m.groups()[:3]]
            if m.group(4) == "0" and spill > (merged.get("spill_stores", 0)
                                              + merged.get("spill_loads", 0)):
                worse.append((name, inst, v, merged))
    print(json.dumps({"fit_moment_thread_1d_3d_ptxas": split}), flush=True)
    if worse or sum(len(v) for v in split.values()) != 2 * (30 + 18):
        raise RuntimeError("a 1D or 3D basic thread instance spills more than the one with "
                           "knowns, or the instances are not 96: %s" % (worse,))


def _indirect_branches(path):
    """BRX instructions per moment-kernel instance (thread and warp body) of
    a library, from ``cuobjdump -sass`` beside nvcc."""
    from wlsqm_tpu_torch import native

    tool = os.path.join(os.path.dirname(native.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*(fit_moment_(?:thread|warp))I((?:L[a-z]+\d+E)+)E", line)
        if m:
            name = "%s<%s>" % (m.group(1), ",".join(re.findall(r"L[a-z]+(\d+)E", m.group(2))))
            out[name] = 0
        elif "Function :" in line:
            name = None
        elif name and re.search(r"\bBRX\b", line):
            out[name] += 1
    return out


def phase_moment_vs_plain(dev, wtt):
    """The moment kernel against its plain version: 2D order 4 at B_CHECK,
    the slab edges (K_SLAB_EDGE: the largest K whose slabs one block
    stages, and the first whose walks read global memory), and the grid of
    dims 1-3 x orders 0-4 x knowns {0, the value, the highest DOF} x basic
    and max_iter = 3 x UNIFORM and CENTER at B_MOMENT_GRID, ragged nk with
    NaN padding (1D at nk >= 2 NO), 3D order 4 also at K = 48 (the dim3
    path's) and K_WIDE, 3D order 2 at its thread body's slab edges, and
    the dim1 and dim3_thread paths' configurations (1D order 4 UNIFORM at
    K_DIM1, 3D order 2 at K_DIM3, basic and max_iter = 3): fi within
    PARITY, the known DOFs fi_init's bits, fi (and the counts) the same
    bits with the key.  PARITY holds on every case in 2D and 3D; in 1D
    on the cases whose key is under the moment body's certified edge (the
    calibration record's).  Past it the two, which sum the moments in other
    orders, differ by roundoff the conditioning amplifies (1D order 4
    clouds of 10-16 points reach keys of 1e6-1e7): held to KEY_EPS times
    the key, at most KEY_CAP, and against an independent witness, the
    long-double-refined oracle (calibration.oracle_case_errors, the
    reduced system's with knowns): on each such case the kernel's error is
    within PARITY of the oracle or at most ORACLE_FACTOR times the plain
    version's own."""
    from wlsqm_tpu_torch.fitter import calibration, condprobe, defs
    from wlsqm_tpu_torch.ops import fit_kernel

    gen = torch.Generator(device=dev).manual_seed(2026)
    worst_rel, worst_abs = 0.0, 0.0
    weightings = (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER)
    checks = [(2, ORDER, w, 0, 0, B_CHECK, K) for w in weightings]
    checks += [(2, ORDER, w, 0, 0, B_GRID, k) for k in K_SLAB_EDGE for w in weightings]
    for dim in (1, 2, 3):
        for order in range(ORDER + 1):
            NO = defs.number_of_dofs(dim, order)
            for kn in sorted({0, 1, 1 << (NO - 1)}):
                for mi in (0, 3):
                    checks += [(dim, order, w, kn, mi, B_MOMENT_GRID, K_GRID[dim])
                               for w in weightings]
    checks += [(3, ORDER, w, kn, mi, B_MOMENT_GRID, k) for k in (K_DIM3, K_WIDE)
               for w in weightings for kn in (0, 1 << 34) for mi in (0, 3)]
    checks += [(3, 2, w, 0, 0, B_GRID, k) for k in K_SLAB_EDGE_3D for w in weightings]
    checks += [(1, ORDER, wtt.WEIGHT_UNIFORM, 0, mi, B_MOMENT_GRID, K_DIM1) for mi in (0, 3)]
    checks += [(3, ORDER_DIM3_THREAD, w, 0, mi, B_MOMENT_GRID, K_DIM3)
               for w in weightings for mi in (0, 3)]
    edge = condprobe.est_certified_edges()["moments"]
    per = {}
    for dim, order, w, kn, mi, B, k in checks:
        NO = defs.number_of_dofs(dim, order)
        lo = 2 * NO if dim == 1 else min((3 * NO) // 2, k - 8)   # K = 48 < 1.5 NO at 3D order 4
        xk, fk, nk, xi = _cloud(B, gen, dev, dim=dim, K=k, order=order, ragged=True,
                                offset=True, lo=lo)
        fi0 = torch.randn((B, NO), generator=gen, device=dev, dtype=torch.float64)
        kw = dict(dimension=dim, order=order, weighting=w, knowns=kn, max_iter=mi)
        got = fit_kernel.fit_kernel(xk, fk, nk, xi, fi0, **kw)
        key = fit_kernel.fit_kernel(xk, fk, nk, xi, fi0, emit_cond=True, **kw)
        ref = fit_kernel.fit_moments_plain(xk, fk, nk, xi, fi0, **kw)
        torch.cuda.synchronize()
        fi, fr = (got[0], ref[0]) if mi else (got, ref)
        name = "d%d_o%d_w%d_kn%d_it%d_B%d_K%d" % (dim, order, w, kn, mi, B, k)
        KN = fit_kernel.known_dofs(kn, dim, order)
        if not bool(torch.isfinite(fi).all()):
            raise RuntimeError("moment kernel gave non-finite DOFs: %s" % name)
        if not (_same_bits(fi, key[0]) and _same_bits(fi[:, KN], fi0[:, KN])
                and (not mi or torch.equal(got[1], key[1]))):
            raise RuntimeError("moment kernel %s: fi differs with the key, or a known DOF "
                               "is not fi_init's bits" % name)
        err = (fi - fr).abs().amax(1) / fr.abs().amax(1).clamp_min(1.0)
        under = (key[-1] <= edge) if dim == 1 else torch.ones_like(key[-1], dtype=torch.bool)
        rel = err[under].max().item() if bool(under.any()) else 0.0
        per[name] = rel
        witness = True
        if not bool(under.all()):
            past = (~under).nonzero().squeeze(1)
            e = calibration.oracle_case_errors([fi[past], fr[past]], xk[past], fk[past],
                                               nk[past], xi[past], fi0[past], KN, w, dim, order)
            witness = bool((e[0] <= np.maximum(ORACLE_FACTOR * e[1], PARITY)).all())
            per[name + "_past_edge"] = {"cases": len(past), "worst": err[past].max().item(),
                                        "worst_over_key": (err / key[-1])[past].max().item(),
                                        "worst_vs_oracle": float(e[0].max()),
                                        "plain_worst_vs_oracle": float(e[1].max()),
                                        "worst_over_plain_vs_oracle": float(
                                            (e[0] / np.maximum(e[1], 1e-300)).max())}
        if mi:
            per[name + "_iters_equal"] = float((got[1] == ref[1]).double().mean())
        worst_rel = max(worst_rel, rel)
        worst_abs = max(worst_abs, (fi - fr)[under].abs().max().item() if bool(under.any())
                        else 0.0)
        tol = torch.where(under, PARITY, (KEY_EPS * key[-1]).clamp_max(KEY_CAP))
        if rel > PARITY or not bool((err <= tol).all()) or not witness:
            raise RuntimeError("moment kernel vs plain at %s: %.3e > %.0e (under the key "
                               "edge), or past it more than min(%.1e x key, %.0e) or farther "
                               "from the oracle than %g x the plain version: %s"
                               % (name, rel, PARITY, KEY_EPS, KEY_CAP, ORACLE_FACTOR,
                                  per.get(name + "_past_edge")))
        del xk, fk, nk, xi, fi0, got, key, ref
    print(json.dumps({"fit_moment_vs_plain_rel": per, "configs": len(checks),
                      "worst_rel": worst_rel, "worst_abs": worst_abs, "tol": PARITY}),
          flush=True)
    return worst_abs, worst_rel


def phase_moment_scale(dev):
    """The moment kernel's own scale (wlsqm_moment_scale runs the fit's device
    functions alone) against _prescale, bit for bit, which fit_rows and
    condprobe keep using: on the headline cloud at 2^23, on 1D and 3D clouds
    at 2^20 (each dimension's library), and on cases whose
    h² is an exact power of four or one ulp of the coordinate either side
    of it (where ceil(0.5 log2) and an exact frexp rule part), with nk = 0
    and NaN padding."""
    from wlsqm_tpu_torch.ops import fit_kernel

    xk, _, nk, xi = _cloud(B_MAIN, torch.Generator(device=dev).manual_seed(42), dev,
                           ragged=True)
    m = 3 * 64
    h = torch.ldexp(torch.ones(m, dtype=torch.float64, device=dev),
                    torch.arange(m, device=dev) % 64 - 32)
    step = torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64, device=dev).repeat_interleave(64)
    adv_x = torch.rand((m, K, 2), generator=torch.Generator(device=dev).manual_seed(7),
                       device=dev, dtype=torch.float64) * 2e-3 - 1e-3
    adv_x = adv_x * h[:, None, None]
    adv_x[:, 0, 0] = torch.nextafter(h, h + step)
    adv_x[:, 0, 1] = 0.0
    adv_n = torch.randint(1, K + 1, (m,), device=dev, dtype=torch.int32)
    adv_n[:16] = 0
    adv_x[torch.arange(K, device=dev)[None, :] >= adv_n[:, None]] = torch.nan
    out = {}
    x1, _, n1, i1 = _cloud(1 << 20, torch.Generator(device=dev).manual_seed(43), dev, dim=1,
                           K=K_GRID[1], ragged=True, offset=True)
    x3, _, n3, i3 = _cloud(1 << 20, torch.Generator(device=dev).manual_seed(44), dev, dim=3,
                           K=K_DIM3, order=2, ragged=True, offset=True)
    for name, args in (("headline_2^23", (xk, nk, xi)),
                       ("powers_of_four", (adv_x, adv_n, torch.zeros((m, 2), dtype=torch.float64,
                                                                     device=dev))),
                       ("dim1_2^20", (x1, n1, i1)), ("dim3_2^20", (x3, n3, i3))):
        e, inv_s = fit_kernel.moment_scale(*args)
        _, _, e_ref, inv_ref = fit_kernel._prescale(*args)
        torch.cuda.synchronize()
        same = torch.equal(_bits(e), _bits(e_ref)) and torch.equal(_bits(inv_s), _bits(inv_ref))
        out[name] = {"cases": len(e), "bit_equal": same,
                     "differ": int((_bits(e) != _bits(e_ref)).sum())}
        if not same:
            raise RuntimeError("the kernel's scale differs from _prescale: %s" % out)
        del e, inv_s, e_ref, inv_ref
    print(json.dumps({"moment_scale_vs_prescale": out}), flush=True)


def _warp_configs():
    """The (dim, order) instances that the rows kernel runs on its warp body."""
    from wlsqm_tpu_torch.ops import fit_rows

    return [(d, o) for d in (1, 2, 3) for o in range(ORDER + 1) if fit_rows.warp_body(d, o)]


def _count_check(equal, within, tv, total):
    """The ALGO_ITERATIVE count bar, pooled over a grid: >= 50% equal,
    >= 80% within one, and the per-configuration count histograms at most
    COUNT_TV apart (summed |difference| / 2, over all cases)."""
    return equal / total >= 0.5 and within / total >= 0.8 and tv / total <= COUNT_TV


def phase_rows_vs_plain(dev, wtt):
    """The rows kernel against its plain version over dims 1-3, orders 0-4,
    both weightings: with sens, with a random knowns mask (and sens), and
    with max_iter 3 (and the mask); both bodies (the thread body below
    fit_rows.WARP_MIN_NO, the warp body from it) at the grid's K and again at
    K_WIDE, and the 3D thread-body orders at K_DIM3 (with sens the thread
    body stages its offsets and weights in shared memory at the grid's K in
    1D and 2D and at 3D's K_DIM3, nothing at 3D's K = 56 and at K_WIDE:
    ROWS_STAGE_EDGE), ragged nk with NaN in the padded slots.

    Counts: exact-stagnation ties follow the last bit of the residual norms,
    which FMA contraction and the summation order move, so they are held
    pooled (_count_check; the 2D grid measured 57% equal and 88% within one
    on an H100 in PR 2; the warp body sums A on the tensor cores, in
    another order than the plain version's matmuls, which moves more ties).
    Constant counts 1, 2 and max_iter are run through the same check as
    controls, and each must fail it.  Data fk = 0 has residual 0 at every
    trip, so there both versions must stop at the first repeat: count
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
    grid = [(dim, order, K_GRID[dim], B_CHECK if order == ORDER and dim > 1 else B_GRID)
            for dim in (1, 2, 3) for order in range(ORDER + 1)]
    grid += [(dim, order, K_WIDE, B_GRID) for dim in (1, 2, 3) for order in range(ORDER + 1)]
    grid += [(3, order, K_DIM3, B_GRID) for order in range(ORDER + 1)
             if not fit_rows.warp_body(3, order)]
    for dim, order, Kg, B in grid:
        NO = defs.number_of_dofs(dim, order)
        for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
            xk, fk, nk, xi = _cloud(B, gen, dev, dim=dim, K=Kg, order=order,
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
                    per["d%d_o%d_w%d_K%d_iters" % (dim, order, w, Kg)] = {
                        "kernel": torch.bincount(it, minlength=max_iter + 1)[1:].tolist(),
                        "plain": hist[1:].tolist()}
                    kw = dict(kw, knowns=0)
                    zero = fk * 0.0        # NaN stays in the padded slots
                    for fi_z, it_z, _ in (fit_rows.fit_rows(xk, zero, nk, xi, **kw),
                                          fit_rows.fit_rows_plain(xk, zero, nk, xi, **kw)):
                        if not (bool((it_z == 1).all()) and bool((fi_z == 0).all())):
                            raise RuntimeError("fk = 0 did not stop at the first "
                                               "repeat: %s" % (kw,))
            per["d%d_o%d_w%d_K%d_B%d" % (dim, order, w, Kg, B)] = max(errs)
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


def _count_shares(dev, body="rows"):
    """A kernel's (the rows kernel's or the moment kernel's) and its plain
    version's ALGO_ITERATIVE counts on the seeded clouds of
    tests/iterative_counts.py, against the JAX f64 engine's counts stored
    beside them: (equal, within one, histogram distance) per set (the rows
    grid, the warp configurations, both), and the worst DOF difference
    kernel vs plain."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import iterative_counts

    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    stored = iterative_counts.load()
    got = {"kernel": {}, "plain": {}}
    if body == "rows":
        kernel, plain = fit_rows.fit_rows, fit_rows.fit_rows_plain
    else:
        kernel, plain = fit_kernel.fit_kernel, fit_kernel.fit_moments_plain
    worst = 0.0
    for key, dim, order, w, B, Kc, seed in iterative_counts.configs():
        xk, fk, nk, xi, fi0, kn = (torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray)
                                   else a for a in iterative_counts.cloud(dim, order, B, Kc, seed))
        kw = dict(dimension=dim, order=order, weighting=w, knowns=kn,
                  max_iter=iterative_counts.MAX_ITER)
        fi_k, it_k = kernel(xk, fk, nk, xi, fi0, **kw)[:2]
        fi_p, it_p = plain(xk, fk, nk, xi, fi0, **kw)[:2]
        worst = max(worst, _rel(fi_k, fi_p))
        got["kernel"][key] = it_k.cpu().numpy()
        got["plain"][key] = it_p.cpu().numpy()
    out = {}
    for name, sel in (("grid", "grid_"), ("warp", "warp_"), ("all", "")):
        keys = [k for k in stored if k.startswith(sel)]
        for body in ("kernel", "plain"):
            eq, w1, tv = iterative_counts.shares([got[body][k] for k in keys],
                                                 [stored[k] for k in keys])
            out["%s_%s_vs_jax" % (body, name)] = {"equal": eq, "within_one": w1,
                                                   "hist_distance": tv}
    per = {k: {body: iterative_counts.shares([got[body][k]], [stored[k]])[2]
               for body in ("kernel", "plain")} for k in stored}
    return out, per, worst


def phase_iterative_counts(dev):
    """ROADMAP C2: each fit kernel's counts and its plain version's against
    the JAX engine's on the same seeded clouds; each kernel is held to be no
    farther from them than its plain version (pooled histogram distance
    within COUNT_SLACK, equal share no lower by more than it), and its DOFs
    to PARITY of the plain version's."""
    for body in ("rows", "moments"):
        out, per, worst = _count_shares(dev, body)
        print(json.dumps({"body": body, "iterative_counts_vs_jax": out,
                          "hist_distance_per_config": per, "fi_kernel_vs_plain": worst,
                          "tol": PARITY}), flush=True)
        k, p = out["kernel_all_vs_jax"], out["plain_all_vs_jax"]
        if not (worst <= PARITY and k["hist_distance"] <= p["hist_distance"] + COUNT_SLACK
                and k["equal"] >= p["equal"] - COUNT_SLACK):
            raise RuntimeError("ALGO_ITERATIVE counts (%s): kernel %s, plain %s against the "
                               "JAX engine; fi %.3e" % (body, k, p, worst))


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


def phase_headline(dev, wtt):
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
                      "launches": {"fit_moment": launches,
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
    out = torch.empty((B_MAIN, 15), dtype=torch.float64, device=dev)
    launch_args = (xk, fk, nk, xi, out)
    lkw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER,
               refine_steps=fit_kernel.DEFAULT_REFINE_STEPS)
    launch_ms, launch_t = _time_ms(lambda: fit_kernel._launch(*launch_args, **lkw))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=ORDER,
                          weighting=wtt.WEIGHT_CENTER)
    torch.cuda.synchronize()
    fit_kernel_extra_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    full_bound = _bound(launch_args, _moment_flops(
        ORDER, True, nk.long(), fit_kernel.DEFAULT_REFINE_STEPS))
    del out, launch_args
    s = slice(0, B_PLAIN)
    small = (xk[s], fk[s], nk[s], xi[s])
    small_ms, small_t = _time_ms(lambda: fit_kernel.fit_kernel(
        *small, dimension=2, order=ORDER, weighting=wtt.WEIGHT_CENTER))
    out = torch.empty((B_PLAIN, 15), dtype=torch.float64, device=dev)
    small_launch_ms, small_launch_t = _time_ms(lambda: fit_kernel._launch(*small, out, **lkw))
    small_bound = _bound((*small, out), _moment_flops(
        ORDER, True, small[2].long(), fit_kernel.DEFAULT_REFINE_STEPS))
    plain_ms, plain_t = _time_ms(lambda: fit_kernel.fit_moments_plain(
        *small, dimension=2, order=ORDER, weighting=wtt.WEIGHT_CENTER))
    A, sw, fkm = _weighted_basis(*small, 2, ORDER, wtt.WEIGHT_CENTER)
    rhs = (sw * fkm)[..., None]
    library_ms, library_t = _time_ms(lambda: torch.linalg.lstsq(A, rhs))
    del A, rhs, sw, fkm, out
    # the headline instances: the 2D thread body without knowns and
    # ALGO_ITERATIVE, both weightings, without and with the key
    ptxas = {lib: {name: v for name, v in _ptxas_summary(fit_kernel.load(2, cond).log).items()
                   if re.fullmatch(r"fit_moment_thread<2,\d,\d,0>", name)}
             for lib, cond in (("fit_moment_d2", False), ("fit_moment_d2_cond", True))}
    spills = sum(v.get("spill_stores", 0) + v.get("spill_loads", 0)
                 for per in ptxas.values() for v in per.values())
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
        "route_minus_launch_ms_2^23": route_ms - launch_ms,
        "fit_kernel_minus_launch_ms_2^23": kernel_ms - launch_ms,
        "fit_kernel_extra_memory_gb_2^23": round(fit_kernel_extra_gb, 4),
        "fit_moment_basic_2d_ptxas": ptxas, "fit_moment_basic_2d_spill_bytes": spills,
        "bound_2^23": full_bound, "bound_2^18": small_bound,
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}), flush=True)
    if route_ms - launch_ms > 1.0:
        raise RuntimeError("headline route takes %.3f ms beyond its launch (> 1 ms)"
                           % (route_ms - launch_ms))
    worst = max(max(v.get("spill_stores", 0), v.get("spill_loads", 0))
                for per in ptxas.values() for v in per.values())
    if worst > MOMENT_SPILL_BYTES:
        raise RuntimeError("the 2D basic fit_moment instances spill %d bytes (> %d): %s"
                           % (worst, MOMENT_SPILL_BYTES, ptxas))
    return {"launches": launches, "ms": small_launch_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "route_ms_2^23": route_ms, **small_bound}


def phase_sens(dev, wtt):
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
                      "launches": {"fit_moment": fit_kernel.LAUNCHES,
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


def _moment_times(dev, wtt, name, data, *, dim, route, launches, max_iter=0, its=None,
                  plain_b=B_PLAIN, order=ORDER, weighting=2):
    """The moment kernel on one path: the route, fit_kernel and the launch at
    the path's B; fit_kernel, the launch, the plain version and the library
    yardstick (torch.linalg.lstsq on the prebuilt sqrt(w)-weighted basis) at
    ``plain_b``; the bounds at both sizes (``its``: the per-case counts the
    path gave, for the trips the work needs)."""
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel

    xk, fk, nk, xi = data
    B = xk.shape[0]
    NO = defs.number_of_dofs(dim, order)
    W, RS = weighting, fit_kernel.DEFAULT_REFINE_STEPS
    kw = dict(dimension=dim, order=order, weighting=W, max_iter=max_iter)
    times, bounds = {}, {}
    tag = "2^%d" % int(math.log2(B))
    times["route_" + tag] = _time_ms(route)
    times["fit_kernel_" + tag] = _time_ms(lambda: fit_kernel.fit_kernel(xk, fk, nk, xi, **kw))

    def launcher(d, it):
        b = d[0].shape[0]
        out = torch.empty((b, NO), dtype=torch.float64, device=dev)
        iters = torch.empty((b,), dtype=torch.int32, device=dev) if max_iter else None
        flops = _moment_flops(order, W == wtt.WEIGHT_CENTER, d[2].long(), RS, dim=dim,
                              iters=it, max_iter=max_iter)
        return ((lambda: fit_kernel._launch(*d, out, iters=iters, order=order, weighting=W,
                                            refine_steps=RS, max_iter=max_iter)),
                _bound((*d, out, iters), flops))

    fn, bounds[tag] = launcher(data, its)
    times["launch_" + tag] = _time_ms(fn)
    del fn
    s = slice(0, plain_b)
    small = tuple(t[s] for t in data)
    times["fit_kernel_2^18"] = _time_ms(lambda: fit_kernel.fit_kernel(*small, **kw))
    fn, bounds["2^18"] = launcher(small, None if its is None else its[s])
    times["launch_2^18"] = _time_ms(fn)
    del fn
    times["plain_2^18"] = _time_ms(lambda: fit_kernel.fit_moments_plain(*small, **kw))
    A, sw, fkm = _weighted_basis(*small, dim, order, W)
    rhs = (sw * fkm)[..., None]
    times["library_lstsq_2^18"] = _time_ms(lambda: torch.linalg.lstsq(A, rhs))
    del A, rhs, sw, fkm
    med = {k: v[0] for k, v in times.items()}
    print(json.dumps({
        "path": name, "kernel": "fit_moment", "dim": dim, "order": order, "weighting": W,
        "max_iter": max_iter, "ms": {k: v[1] for k, v in times.items()},
        "fits_per_s": {k: (B if k.endswith(tag) else plain_b) / v * 1e3
                       for k, v in med.items()},
        "bound_" + tag: bounds[tag], "bound_2^18": bounds["2^18"],
        "launch_vs_bound_" + tag: bounds[tag]["bound_ms"] / med["launch_" + tag],
        "library": "torch.linalg.lstsq on the prebuilt sqrt(w)-weighted basis "
                   "(basis build excluded)",
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}), flush=True)
    return {"launches": launches, "ms": med["launch_2^18"], "plain_ms": med["plain_2^18"],
            "library_ms": med["library_lstsq_2^18"], "launch_ms_full": med["launch_" + tag],
            "route_ms_full": med["route_" + tag], "bound_ms_full": bounds[tag]["bound_ms"],
            "bound_by_full": bounds[tag]["bound_by"], **bounds["2^18"]}


def phase_iterative(dev, wtt):
    """The gate row's ``iterative`` configuration (the headline fit with
    max_iter = 3; benchmarks/run_regression_gate.py l.104-124, 307) at 2^23
    through plan_fit_many(iterative=True) + fit_many(plan=): the moment
    kernel alone, as the JAX package routes it (its corrective refits are
    refinement steps on the moment store); parity against scipy, the counts
    against the plain version's, fits/s (median of 5 and spread) beside the
    bound."""
    from wlsqm_tpu_torch.ops import fit_kernel

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xk, fk, nk, xi = _cloud(B_MAIN, torch.Generator(device=dev).manual_seed(45), dev)
    kw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER)
    plan = wtt.plan_fit_many(xk[:B_PLAN], xi[:B_PLAN], iterative=True, **kw)
    if (plan.route.path, plan.route.assembly) != ("kernel", "moments"):
        raise RuntimeError("the iterative plan did not route to the moment kernel: %s"
                           % (plan,))
    _zero_launches()
    t0 = time.perf_counter()
    res = wtt.fit_many(xk, fk, xi, plan=plan, iterative=True, max_iter=MAX_ITER, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _kernel_launches()
    if launches != _launches(moment=1):
        raise RuntimeError("the iterative path launched %s, not the moment kernel once"
                           % (launches,))
    fi, its = res.fi, res.iterations
    if (tuple(fi.shape) != (B_MAIN, 15) or not bool(torch.isfinite(fi).all())
            or int(its.min()) < 1 or int(its.max()) > MAX_ITER):
        raise RuntimeError("iterative path: bad outputs, shape %s, counts %d-%d"
                           % (tuple(fi.shape), int(its.min()), int(its.max())))
    scipy_err = parity_check(xk[:B_SCIPY].cpu().numpy(), fk[:B_SCIPY].cpu().numpy(),
                             fi[:B_SCIPY].cpu().numpy())
    s = slice(0, B_PLAIN)
    fi_p, it_p = fit_kernel.fit_moments_plain(xk[s], fk[s], nk[s], xi[s], dimension=2,
                                              max_iter=MAX_ITER, **kw)
    plain_err = _rel(fi[s], fi_p)
    hist = torch.bincount(its.long(), minlength=MAX_ITER + 1).tolist()
    counts = {"equal_to_plain": float((its[s] == it_p).double().mean()),
              "within_one_of_plain": float(((its[s] - it_p).abs() <= 1).double().mean()),
              "histogram": hist,
              "plain_histogram": torch.bincount(it_p.long(), minlength=MAX_ITER + 1).tolist()}
    print(json.dumps({"path": "iterative", "B": B_MAIN, "route": plan.route.path,
                      "assembly": plan.route.assembly, "max_iter": MAX_ITER,
                      "launches": launches, "first_call_s": round(first_s, 4),
                      "parity_vs_scipy": scipy_err, "vs_plain_2^18": plain_err,
                      "counts": counts, "tol": PARITY,
                      "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}),
          flush=True)
    if scipy_err > PARITY or plain_err > PARITY:
        raise RuntimeError("iterative path parity: scipy %.3e, plain %.3e > %.0e"
                           % (scipy_err, plain_err, PARITY))
    del res, fi, fi_p, it_p
    t = _moment_times(dev, wtt, "iterative", (xk, fk, nk, xi), dim=2, launches=1,
                      max_iter=MAX_ITER, its=its,
                      route=lambda: wtt.fit_many(xk, fk, xi, plan=plan, iterative=True,
                                                 max_iter=MAX_ITER, **kw))
    print(json.dumps({"path": "iterative_launch", "B": B_MAIN,
                      "instance": "fit_moment_thread<2,4,2,2> (ALGO_ITERATIVE, no knowns)",
                      "launch_ms": t["launch_ms_full"], "bound_ms": t["bound_ms_full"],
                      "bound_by": t["bound_by_full"],
                      "launch_vs_bound": t["bound_ms_full"] / t["launch_ms_full"]}), flush=True)
    return t


def phase_dim3(dev, wtt):
    """The dim3 path at 2^21 through fit_many(backend="kernel"): K = 48 is
    under the auto route's K >= 1.5 NO = 52, which keeps such groups on the
    engine as the JAX package does, so the path asks for the kernel as the
    gate row calls fit_pallas directly; the forced kernel takes the moment
    body in 3D (``fit_pallas(assembly="auto")``: the moment kernel's warp
    body here), held to the port's engine.  The rows kernel is timed beside
    it on the same cloud, through a plan that names it."""
    from wlsqm_tpu_torch.fitter import ladder
    from wlsqm_tpu_torch.ops import fit_kernel

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(44)
    xk, fk, nk, xi = _cloud(B_ROWS, gen, dev, dim=3, K=K_DIM3)
    kw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER)
    auto = wtt.plan_fit_many(xk[:B_PLAN], xi[:B_PLAN], **kw).route
    _zero_launches()
    t0 = time.perf_counter()
    res = wtt.fit_many(xk, fk, xi, backend="kernel", **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _kernel_launches()
    if launches != _launches(moment=1):
        raise RuntimeError("the dim3 path did not run on the moment kernel alone: %s"
                           % (launches,))
    fi = res.fi
    if tuple(fi.shape) != (B_ROWS, 35) or not bool(torch.isfinite(fi).all()):
        raise RuntimeError("dim3 path: bad DOFs, shape %s" % (tuple(fi.shape),))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = slice(0, B_ENGINE_DIM3)
    err = _rel(fi[s], wtt.fit_many(xk[s], fk[s], xi[s], backend="engine", **kw).fi)
    rows_plan = wtt.FitPlan(route=ladder.Route(path="kernel", assembly="rows"))
    rows_fi = wtt.fit_many(xk[s], fk[s], xi[s], plan=rows_plan, **kw).fi
    print(json.dumps({"path": "dim3", "B": B_ROWS, "route": "kernel (backend='kernel')",
                      "auto_plan_route": auto.path, "launches": launches,
                      "first_call_s": round(first_s, 4), "fi_vs_engine": err,
                      "fi_vs_rows_kernel": _rel(fi[s], rows_fi), "tol": PARITY,
                      "peak_mem_gb": round(peak_gb, 3)}), flush=True)
    if err > PARITY:
        raise RuntimeError("dim3 path parity: %.3e > %.0e" % (err, PARITY))
    del res, fi, rows_fi
    data = (xk, fk, nk, xi)
    k1 = _moment_times(dev, wtt, "dim3", data, dim=3, launches=1,
                       route=lambda: wtt.fit_many(xk, fk, xi, backend="kernel", **kw))
    k2 = _rows_times(dev, wtt, "dim3_rows", data, plan=rows_plan, dim=3, do_sens=False,
                     launches=0)
    print(json.dumps({"path": "dim3_launch", "B": B_ROWS,
                      "fit_moment_warp_launch_ms": k1["launch_ms_full"],
                      "bound_ms": k1["bound_ms_full"], "bound_by": k1["bound_by_full"],
                      "launch_vs_bound": k1["bound_ms_full"] / k1["launch_ms_full"],
                      "fit_rows_launch_ms_same_cloud": k2["launch_ms_full"]}), flush=True)
    if k1["launch_ms_full"] >= k2["launch_ms_full"]:
        raise RuntimeError("dim3: the moment kernel's warp body (%.2f ms) is not ahead of the "
                           "rows kernel on the same cloud (%.2f ms)"
                           % (k1["launch_ms_full"], k2["launch_ms_full"]))
    return k1, k2


def _dim1_cloud(B, gen, dev, K=K_DIM1):
    """The reference's configuration 3, 1D half (benchmarks/run_configs.py
    l.117-128), grown to B cases: centres uniform in [-1, 1], K neighbours at
    the centre plus U(-0.5, 0.5), fk = exp(xk)."""
    xi = torch.rand((B, 1), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
    xk = xi[:, None, :] + (torch.rand((B, K, 1), generator=gen, device=dev,
                                      dtype=torch.float64) - 0.5)
    fk = torch.exp(xk[..., 0])
    nk = torch.full((B,), K, dtype=torch.int32, device=dev)
    return xk, fk, nk, xi


def _scipy_1d(xk, fk, xi, order):
    """parity_check's reference in 1D, UNIFORM: per case scipy's f64
    symmetric solve of the normal equations of the factorial-scaled monomials
    of the offsets (NumPy in, (B, order + 1) out)."""
    from math import factorial

    import scipy.linalg

    p = np.arange(order + 1)
    invf = np.array([1.0 / factorial(int(q)) for q in p])
    out = np.empty((xk.shape[0], order + 1))
    for j in range(xk.shape[0]):
        c = ((xk[j, :, 0] - xi[j, 0])[:, None] ** p) * invf
        out[j] = scipy.linalg.solve(c.T @ c, c.T @ fk[j], assume_a="sym")
    return out


def _cond_1d(xk, fk, xi, fi, order):
    """Per case, the componentwise (Skeel) condition of a 1D UNIFORM
    normal-equations fit in the DOF convention of fi (factorial-scaled
    monomials of the offsets): ‖ |A⁻¹| (|C|ᵀ|C| |x| + |C|ᵀ |f|) ‖∞ over
    max(‖x‖∞, 1), A = CᵀC, x = fi (NumPy in, (B,) out).  To first order a
    solve whose sums and factor each carry a few roundings reaches the error
    u times this; a key, which reads A alone, misses the cancellation in
    Cᵀf that a near-constant field brings (ROADMAP C4)."""
    from math import factorial

    p = np.arange(order + 1)
    c = ((xk[..., 0] - xi[:, 0:1])[..., None] ** p) * np.array([1.0 / factorial(int(q))
                                                              for q in p])
    ai = np.abs(np.linalg.inv(np.einsum("bki,bkj->bij", c, c)))
    ac = np.abs(c)
    v = (np.einsum("bki,bkj,bj->bi", ac, ac, np.abs(fi))
         + np.einsum("bki,bk->bi", ac, np.abs(fk)))
    return np.einsum("bij,bj->bi", ai, v).max(1) / np.maximum(np.abs(fi).max(1), 1.0)


def _thread_ptxas(libs, pattern):
    """The ptxas report of the moment (or rows) instances whose name matches
    ``pattern``, by library: {library: {instance: {registers, spills}}}."""
    return {name: {k: v for k, v in _ptxas_summary(lib.log).items() if re.fullmatch(pattern, k)}
            for name, lib in libs.items()}


def phase_dim1(dev, wtt):
    """The dim1 path: the reference's configuration 3, 1D half (order 4,
    K = 15, WEIGHT_UNIFORM; benchmarks/run_configs.py l.117-128) grown to
    2^23 cases, through plan_fit_many + fit_many(plan=) (the certified
    route: the moment kernel's 1D thread body with its key, the engine for
    the tail past the key edge), then the same cloud at max_iter = 3 through
    the route fit_1D_iterative_many takes without count fidelity
    (fit_many(backend="auto", gate="data"): the moment kernel with its key
    on every case, the engine again for the cases the data gate keeps off
    it).  On the first B_ENGINE cases, case by case:
      - each call's kernel launch (fit_kernel with the key, at the call's
        max_iter) against the plain version on the same inputs, read as
        phase_moment_vs_plain reads them (PARITY under the moment key edge,
        min(KEY_EPS x key, KEY_CAP) past it), and held, like the cases past
        that bar there, by the long-double-refined oracle: the kernel's
        error within max(PARITY, COND_FACTOR x u x the case's componentwise
        condition, _cond_1d);
      - the counts against the plain version's (_count_check);
      - the plan route: the kernel's bits under its split edge, within
        PARITY of the engine past it;
      - both routes against the oracle, within max(PARITY, COND_FACTOR x u
        x the case's condition).
    On this near-constant field (exp x on a unit interval) the key misses
    the right-hand side's cancellation (ROADMAP C4): every f64 solve of the
    normal equations, scipy's and the port's engine's included, lies up to
    2e-10 from the oracle on cases under the key edge, so the issue's
    1e-10 against the engine and scipy (printed, with the split by key) is
    out of reach of any of them.
    The launches (basic, with the key, with ALGO_ITERATIVE) timed beside
    their bounds, the plain version and lstsq."""
    from wlsqm_tpu_torch.fitter import calibration, condprobe
    from wlsqm_tpu_torch.ops import fit_kernel

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xk, fk, nk, xi = _dim1_cloud(B_MAIN, torch.Generator(device=dev).manual_seed(46), dev)
    W = wtt.WEIGHT_UNIFORM
    kw = dict(order=ORDER, weighting=W)
    plan = wtt.plan_fit_many(xk[:B_PLAN], xi[:B_PLAN], **kw)
    if plan.route.assembly != "moments" or not plan.route.path.startswith("kernel"):
        raise RuntimeError("the dim1 plan did not route to the moment kernel: %s" % (plan,))
    itkw = dict(kw, iterative=True, max_iter=MAX_ITER, backend="auto", gate="data")
    s, o = slice(0, B_ENGINE), slice(0, B_SCIPY)
    edge = condprobe.est_certified_edges()["moments"]
    rec, fits, held = {}, {}, {}
    for name, mi, call in (("plan", 0, lambda: wtt.fit_many(xk, fk, xi, plan=plan, **kw)),
                           ("iterative", MAX_ITER,
                            lambda: wtt.fit_many(xk, fk, xi, nk=nk, **itkw))):
        _zero_launches()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = _kernel_launches()
        if launches["fit_moment"] < 1 or launches["fit_rows"] or launches["gather_rows"]:
            raise RuntimeError("the dim1 %s route launched %s, not the moment kernel"
                               % (name, launches))
        fi = res.fi
        if tuple(fi.shape) != (B_MAIN, 5) or not bool(torch.isfinite(fi).all()):
            raise RuntimeError("dim1 %s: bad DOFs, shape %s" % (name, tuple(fi.shape)))
        ekw = dict(kw, iterative=True, max_iter=mi) if mi else kw
        eng = wtt.fit_many(xk[s], fk[s], xi[s], nk=nk[s], backend="engine", **ekw).fi
        kernel = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=1, emit_cond=True,
                                       max_iter=mi, **kw)
        plain = fit_kernel.fit_moments_plain(xk[s], fk[s], nk[s], xi[s], dimension=1,
                                             max_iter=mi, **kw)
        plain = plain if mi else (plain,)
        key = kernel[-1][s]
        sci = torch.from_numpy(_scipy_1d(*(t[o].cpu().numpy() for t in (xk, fk, xi)), ORDER))
        r = {"launches": launches, "first_call_s": round(first_s, 4),
             "vs_engine": _rel(fi[s], eng), "vs_scipy": _rel(fi[o], sci.to(dev)),
             "engine_vs_scipy": _rel(eng[o], sci.to(dev)),
             "kernel_bits_share": float((_bits(fi[s]) == _bits(kernel[0][s])).all(1)
                                        .double().mean())}
        if mi:
            kc, pc = kernel[1][s].long(), plain[1].long()
            tv = int((torch.bincount(kc, minlength=mi + 1)
                      - torch.bincount(pc, minlength=mi + 1)).abs().sum()) // 2
            r["counts"] = torch.bincount(res.iterations.long(), minlength=mi + 1).tolist()
            r["kernel_counts_vs_plain"] = {"equal": float((kc == pc).double().mean()),
                                           "within_one": float(((kc - pc).abs() <= 1)
                                                               .double().mean()),
                                           "histogram_distance": tv / B_ENGINE}
            if not _count_check(int((kc == pc).sum()), int(((kc - pc).abs() <= 1).sum()), tv,
                                B_ENGINE):
                raise RuntimeError("dim1 %s: the kernel's counts against the plain "
                                   "version's: %s" % (name, r["kernel_counts_vs_plain"]))
        else:
            past = key > plan.route.split_edge
            r["route_past_split_edge"] = int(past.sum())
            if not (_same_bits(fi[s][~past], kernel[0][s][~past])
                    and _rel(fi[s][past], eng[past]) <= PARITY):
                raise RuntimeError("dim1 plan route: not the kernel's bits under its split "
                                   "edge, or past PARITY of the engine past it")
        err = (kernel[0][s] - plain[0]).abs().amax(1) / plain[0].abs().amax(1).clamp_min(1.0)
        under = key <= edge
        bar = torch.where(under, PARITY, (KEY_EPS * key).clamp_max(KEY_CAP))
        r["kernel_vs_plain"] = {"under_key_edge": err[under].max().item(),
                                "past_key_edge_over_key": (err / key)[~under].max().item(),
                                "cases_past_the_bar": int((err > bar).sum()),
                                "of_them_under_the_key_edge": int(((err > bar) & under).sum())}
        rec[name] = r
        fits[name] = launches
        held[name] = (fi[s], kernel[0][s], plain[0], eng, under)
        del res, fi, eng, kernel, plain
    # the long-double-refined oracle, once for both calls' fits (same inputs,
    # no knowns), and each case's componentwise condition
    order_of = [(n, i) for n in held for i in range(4)]
    e = calibration.oracle_case_errors([held[n][i] for n, i in order_of], xk[s], fk[s], nk[s],
                                       xi[s], None, [], W, 1, ORDER)
    e = {(n, i): e[j] for j, (n, i) in enumerate(order_of)}
    cond = _cond_1d(*(t[s].cpu().numpy() for t in (xk, fk, xi)),
                    held["plan"][2].cpu().numpy(), ORDER)
    lim = np.maximum(PARITY, COND_FACTOR * 2.0 ** -53 * cond)
    ok = True
    for name, (_, _, _, _, under) in held.items():
        under = under.cpu().numpy()
        ro, ko, po, eo = (e[(name, i)] for i in range(4))
        rec[name].update({
            "vs_oracle": float(ro.max()), "kernel_vs_oracle": float(ko.max()),
            "plain_vs_oracle": float(po.max()), "engine_vs_oracle": float(eo.max()),
            "over_parity_of_the_oracle": {k: [int(((v > PARITY) & under).sum()),
                                              int(((v > PARITY) & ~under).sum())]
                                          for k, v in (("route", ro), ("kernel", ko),
                                                       ("plain", po), ("engine", eo))},
            "route_over_parity_of_the_oracle_first_%d" % B_SCIPY: [
                int(((ro > PARITY) & under)[o].sum()), int(((ro > PARITY) & ~under)[o].sum())],
            "over_u_cond": {k: float((v / (2.0 ** -53 * cond)).max())
                            for k, v in (("route", ro), ("kernel", ko), ("plain", po),
                                         ("engine", eo))}})
        ok &= bool((ro <= lim).all()) and bool((ko <= lim).all())
    print(json.dumps({"path": "dim1", "B": B_MAIN, "K": K_DIM1, "order": ORDER,
                      "weighting": "UNIFORM", "route": plan.route.path,
                      "split_edge": plan.route.split_edge, "tail_frac": plan.route.tail_frac,
                      "key_edge": edge, "held_cases": B_ENGINE, "calls": rec, "tol": PARITY,
                      "cond_factor": COND_FACTOR,
                      "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}),
          flush=True)
    if not ok:
        raise RuntimeError("dim1: a case farther from the oracle than max(%.0e, %g x u x its "
                           "componentwise condition): %s" % (PARITY, COND_FACTOR, rec))
    data = (xk, fk, nk, xi)
    basic = _moment_times(dev, wtt, "dim1", data, dim=1, order=ORDER, weighting=W,
                          launches=fits["plan"],
                          route=lambda: wtt.fit_many(xk, fk, xi, plan=plan, **kw))
    its = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=1, max_iter=MAX_ITER, **kw)[1]
    iterative = _moment_times(dev, wtt, "dim1_iterative", data, dim=1, order=ORDER,
                              weighting=W, launches=fits["iterative"], max_iter=MAX_ITER,
                              its=its, route=lambda: wtt.fit_many(xk, fk, xi, nk=nk, **itkw))
    out = torch.empty((B_MAIN, 5), dtype=torch.float64, device=dev)
    est = torch.empty((B_MAIN,), dtype=torch.float64, device=dev)
    key_ms = _time_ms(lambda: fit_kernel._launch(xk, fk, nk, xi, out, est, order=ORDER,
                                                 weighting=W,
                                                 refine_steps=fit_kernel.DEFAULT_REFINE_STEPS))
    ptxas = _thread_ptxas({"fit_moment_d1": fit_kernel.load(1),
                           "fit_moment_d1_cond": fit_kernel.load(1, True)},
                          r"fit_moment_thread<1,4,1,\d>")
    print(json.dumps({"path": "dim1_launch", "B": B_MAIN,
                      "launch_ms": basic["launch_ms_full"],
                      "launch_with_key_ms": key_ms[0], "launch_with_key_ms_times": key_ms[1],
                      "iterative_launch_ms": iterative["launch_ms_full"],
                      "bound_ms": basic["bound_ms_full"], "bound_by": basic["bound_by_full"],
                      "iterative_bound_ms": iterative["bound_ms_full"],
                      "launch_vs_bound": basic["bound_ms_full"] / basic["launch_ms_full"],
                      "iterative_launch_vs_bound":
                          iterative["bound_ms_full"] / iterative["launch_ms_full"],
                      "ptxas": ptxas}), flush=True)
    return basic, iterative, key_ms[0], _sum_launches(fits.values())


def _sum_launches(counts):
    out = _launches()
    for c in counts:
        for k, v in c.items():
            out[k] += v
    return out


def phase_dim3_thread(dev, wtt):
    """The dim3_thread path: 3D, order 2, K = K_DIM3, CENTER, 2^21 cases,
    through fit_many(backend="kernel") as phase_dim3 runs its order-4 fit
    (the forced kernel takes the moment body: here its 3D thread body), held
    to the port's engine on B_ENGINE_DIM3 cases; the rows kernel's thread
    body, which the certified route runs for this configuration, timed beside
    it on the same cloud through a plan that names the rows body."""
    from wlsqm_tpu_torch.fitter import defs, ladder
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    order = ORDER_DIM3_THREAD
    NO = defs.number_of_dofs(3, order)
    xk, fk, nk, xi = _cloud(B_ROWS, torch.Generator(device=dev).manual_seed(47), dev, dim=3,
                            K=K_DIM3, order=order)
    kw = dict(order=order, weighting=wtt.WEIGHT_CENTER)
    auto = wtt.plan_fit_many(xk[:B_PLAN], xi[:B_PLAN], **kw).route
    _zero_launches()
    t0 = time.perf_counter()
    res = wtt.fit_many(xk, fk, xi, backend="kernel", **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _kernel_launches()
    if launches != _launches(moment=1):
        raise RuntimeError("the dim3_thread path did not run on the moment kernel alone: %s"
                           % (launches,))
    fi = res.fi
    if tuple(fi.shape) != (B_ROWS, NO) or not bool(torch.isfinite(fi).all()):
        raise RuntimeError("dim3_thread path: bad DOFs, shape %s" % (tuple(fi.shape),))
    s = slice(0, B_ENGINE_DIM3)
    err = _rel(fi[s], wtt.fit_many(xk[s], fk[s], xi[s], backend="engine", **kw).fi)
    rows_plan = wtt.FitPlan(route=ladder.Route(path="kernel", assembly="rows"))
    rows_fi = wtt.fit_many(xk[s], fk[s], xi[s], plan=rows_plan, **kw).fi
    print(json.dumps({"path": "dim3_thread", "B": B_ROWS, "K": K_DIM3, "order": order,
                      "route": "kernel (backend='kernel')", "auto_plan_route": auto.path,
                      "launches": launches, "first_call_s": round(first_s, 4),
                      "fi_vs_engine": err, "fi_vs_rows_kernel": _rel(fi[s], rows_fi),
                      "tol": PARITY,
                      "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}),
          flush=True)
    if err > PARITY:
        raise RuntimeError("dim3_thread path parity: %.3e > %.0e" % (err, PARITY))
    del res, fi, rows_fi
    data = (xk, fk, nk, xi)
    k1 = _moment_times(dev, wtt, "dim3_thread", data, dim=3, order=order,
                       launches=launches["fit_moment"],
                       route=lambda: wtt.fit_many(xk, fk, xi, backend="kernel", **kw))
    k2 = _rows_times(dev, wtt, "dim3_thread_rows", data, plan=rows_plan, dim=3, order=order,
                     do_sens=False, launches=0)
    ptxas = _thread_ptxas({"fit_moment_d3": fit_kernel.load(3),
                           "fit_moment_d3_cond": fit_kernel.load(3, True)},
                          r"fit_moment_thread<3,2,2,\d>")
    ptxas.update(_thread_ptxas({"fit_rows": fit_rows.load()}, r"fit_rows_thread<3,2,2.*>"))
    print(json.dumps({"path": "dim3_thread_launch", "B": B_ROWS,
                      "fit_moment_thread_launch_ms": k1["launch_ms_full"],
                      "bound_ms": k1["bound_ms_full"], "bound_by": k1["bound_by_full"],
                      "launch_vs_bound": k1["bound_ms_full"] / k1["launch_ms_full"],
                      "fit_rows_launch_ms_same_cloud": k2["launch_ms_full"],
                      "ptxas": ptxas}), flush=True)
    return k1, k2

def _rows_times(dev, wtt, name, data, *, plan, dim, do_sens, launches, order=ORDER):
    """Route (``plan``, which names the rows body), fit_rows and launch at
    2^21; fit_rows, launch, plain and the library yardstick at 2^18; the
    bounds at both sizes."""
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    xk, fk, nk, xi = data
    NO = defs.number_of_dofs(dim, order)
    W, RS = wtt.WEIGHT_CENTER, fit_rows.DEFAULT_REFINE_STEPS
    kw = dict(order=order, weighting=W)
    times, bounds = {}, {}
    times["route_2^21"] = _time_ms(
        lambda: wtt.fit_many(xk, fk, xi, plan=plan, do_sens=do_sens, **kw))
    times["fit_rows_2^21"] = _time_ms(lambda: fit_rows.fit_rows(
        xk, fk, nk, xi, dimension=dim, do_sens=do_sens, **kw))

    def launcher(d):
        B, Kd = d[0].shape[:2]
        _, _, _, inv_s = fit_kernel._prescale(d[0], d[2], d[3])
        out = torch.empty((B, NO), dtype=torch.float64, device=dev)
        sens = torch.empty((B, Kd, NO), dtype=torch.float64, device=dev) if do_sens else None
        args = (*d, inv_s, None, out, None, sens)
        flops = _rows_flops(dim, order, True, d[2].long(), RS, do_sens, 0, 0)
        return (lambda: fit_rows._launch(*args, order=order, weighting=W, knowns=0,
                                         refine_steps=RS, max_iter=0)), _bound(args, flops)

    fn, bounds["2^21"] = launcher(data)
    times["launch_2^21"] = _time_ms(fn)
    del fn
    if do_sens:   # the same launch without sens: what the sensitivities cost
        _, _, _, inv_s = fit_kernel._prescale(xk, nk, xi)
        out = torch.empty((xk.shape[0], NO), dtype=torch.float64, device=dev)
        times["launch_no_sens_2^21"] = _time_ms(lambda: fit_rows._launch(
            xk, fk, nk, xi, inv_s, None, out, None, None, order=order, weighting=W,
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
    A, sw, fkm = _weighted_basis(*small, dim, order, W)
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
            "library_ms": med["library_lstsq_2^18"], "launch_ms_full": med["launch_2^21"],
            **bounds["2^18"]}

# -- the IBVP path ---------------------------------------------------------------

def _bits(t):
    """An integer view of a 4- or 8-byte tensor, for bit-for-bit equality."""
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def _same_bits(a, b) -> bool:
    """Equal bit for bit: NaN equals NaN of the same bits."""
    return torch.equal(_bits(a), _bits(b))


def _local_idx(rng, n, B, K, spread=40):
    base = np.sort(rng.integers(0, n, B))
    return np.clip(base[:, None] + rng.integers(-spread, spread, (B, K)), 0, n - 1)


def _three_clusters(rng, n, B, K):
    """tests/test_gather.py:165-185: every 8th block of 16 cases reads from
    three far-apart clusters, so the plan has overflow blocks."""
    base = rng.integers(0, 200, (B, 1))
    idx = base + rng.integers(0, 30, (B, K))
    three = (np.arange(B) // 16) % 8 == 0
    pick = rng.integers(0, 3, (B, K))
    idx = np.where(three[:, None] & (pick == 1), n // 2 + rng.integers(0, 30, (B, K)), idx)
    return np.where(three[:, None] & (pick == 2), n - 30 + rng.integers(0, 30, (B, K)), idx)


def ibvp_setup():
    """The IBVP cloud on the host: 2^22 points uniform in [-1, 1]^2 from a
    seed, Morton-ordered, K = 28 nearest (self included) from scipy's tree,
    and the window plan.  Each step timed on its own."""
    from wlsqm_tpu_torch.ops import gather
    from wlsqm_tpu_torch.utils import neighbors

    times = {}
    t0 = time.perf_counter()
    pts = np.random.default_rng(11).uniform(-1, 1, (N_IBVP, 2))
    times["cloud_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pts = pts[gather.morton_order(pts)]
    times["morton_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx, _ = neighbors.knn(pts, pts, K_IBVP, backend="host")
    idx = idx.astype(np.int32)
    times["knn_host_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = gather.plan_window_gather(idx, N_IBVP)
    times["plan_s"] = time.perf_counter() - t0
    if plan is None:
        raise RuntimeError("the 2^22 Morton cloud gave no window plan")
    return pts, idx, plan, times


def phase_gather_vs_plain(dev, ibvp_idx, ibvp_plan):
    """The gather kernel against u[idx], bit for bit (torch.equal on integer
    views): f64 with F = 1 and 3, f32, int32, int64, the f32 pair; float
    payloads carry NaN, ±0 and ±inf; a ragged tail (B = 16·m + 7); a plan
    with overflow blocks; every row width of 1-20 words (f32 F = 1-20, f64
    F = 1-10: the vector instances, a template of the width or the run-time
    width) on an odd row count, with u aligned and one element off, and the
    same rows into an output one word off its 16-byte alignment (the word
    instance); and the 2^22 IBVP indices."""
    from wlsqm_tpu_torch.ops import gather

    rng = np.random.default_rng(2029)
    n, B, K = 1 << 20, 16 * 4096 + 7, K_IBVP
    sets = {"local_ragged": _local_idx(rng, n, B, K),
            "three_clusters": _three_clusters(rng, n, 16 * 512 + 7, 12)}
    gen = torch.Generator(device=dev).manual_seed(2029)
    checked, worst_abs = [], 0.0

    def payload(shape, dtype):
        if dtype.is_floating_point:
            u = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
            flat = u.view(-1)
            for i, v in enumerate((math.nan, -0.0, math.inf, -math.inf)):
                flat[i::11] = v
            return u
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=dtype, device=dev)

    def check(name, u, idx, plan):
        nonlocal worst_abs
        got = gather.gather_rows(u, idx, plan)
        ref = gather.gather_rows_plain(u, idx)
        torch.cuda.synchronize()
        if got.dtype != ref.dtype or got.shape != ref.shape or not torch.equal(
                _bits(got), _bits(ref)):
            raise RuntimeError("gather kernel differs from u[idx]: %s" % name)
        if u.dtype.is_floating_point:
            fin = torch.isfinite(ref)
            if not torch.equal(fin, torch.isfinite(got)):
                raise RuntimeError("gather kernel: non-finite pattern differs: %s" % name)
            worst_abs = max(worst_abs, (got[fin] - ref[fin]).abs().max().item())
        checked.append(name)

    for set_name, idx_np in sets.items():
        idx = torch.as_tensor(idx_np.astype(np.int32), device=dev)
        plan = gather.plan_window_gather(idx_np, n)
        if plan is None or (set_name == "three_clusters") != bool(plan.bad_blocks):
            raise RuntimeError("unexpected plan for %s: %s" % (
                set_name, None if plan is None else len(plan.bad_blocks)))
        for dtype, F in ((torch.float64, 1), (torch.float64, 3), (torch.float32, 1),
                         (torch.int32, 1), (torch.int64, 1)):
            u = payload((n, F) if F > 1 else (n,), dtype)
            check("%s_%s_F%d" % (set_name, str(dtype)[6:], F), u, idx, plan)
        hi, lo = payload((n, 2), torch.float32), payload((n, 2), torch.float32)
        ghi, glo = gather.gather_rows_pair((hi, lo), idx, plan)
        torch.cuda.synchronize()
        if not (torch.equal(_bits(ghi), _bits(hi[idx.long()]))
                and torch.equal(_bits(glo), _bits(lo[idx.long()]))):
            raise RuntimeError("gather pair kernel differs: %s" % set_name)
        checked.append("%s_pair_f32_F2" % set_name)
    # every row width of 1-20 words, an odd number of rows (a ragged last
    # vector), and u viewed one element off its allocation, so that it is
    # not 16-byte aligned and the 16-byte loads are not taken; then the same
    # rows into an output one word off 16-byte alignment: the word instance
    idx_np = _local_idx(rng, n, 16 * 2048 + 5, 7)              # 229,411 rows
    idx, plan = torch.as_tensor(idx_np.astype(np.int32), device=dev), gather.plan_window_gather(
        idx_np, n)
    flat = idx.reshape(-1)
    instances = {}
    widths = ([(torch.float32, F) for F in range(1, 21)]
              + [(torch.float64, F) for F in range(1, 11)] + [(torch.int32, 1), (torch.int64, 1)])
    for dtype, F in widths:
        base = payload(((n + 1) * F,), dtype)
        for off in (0, 1):
            u = base[off:off + n * F]
            u = u.view(n, F) if F > 1 else u
            name = "odd_rows_%s_F%d_offset%d" % (str(dtype)[6:], F, off)
            instances[name] = gather._vector_plan(u.element_size() * F, u.data_ptr(), 1 << 20)
            if instances[name] is None or (off and instances[name] == 16):
                raise RuntimeError("the vector plan of %s: %s" % (name, instances[name]))
            check(name, u, idx, plan)
            words = (u[:, None] if F == 1 else u).contiguous().view(torch.int32)
            W = words.shape[1]
            buf = torch.zeros(flat.numel() * W + 1, dtype=torch.int32, device=dev)
            out = buf[1:].view(-1, W)
            if gather._vector_plan(4 * W, words.data_ptr(), out.data_ptr()) is not None:
                raise RuntimeError("an output off 16-byte alignment took a vector instance")
            gather._launch([words], flat, [out])
            torch.cuda.synchronize()
            ref = gather.gather_rows_plain(u, idx).reshape(flat.numel(), -1)
            if not torch.equal(out, ref.contiguous().view(torch.int32)):
                raise RuntimeError("the word instance differs from u[idx]: %s" % name)
            checked.append(name + "_out_offset1")
    idx = torch.as_tensor(ibvp_idx, device=dev)
    for F in (1, 3):
        u = torch.randn((N_IBVP, F) if F > 1 else (N_IBVP,), generator=gen,
                        dtype=torch.float64, device=dev)
        check("ibvp_2^22_float64_F%d" % F, u, idx, ibvp_plan)
    print(json.dumps({"gather_vs_plain": "bit-exact", "cases": checked,
                      "vector_plan_load_bytes": instances,
                      "max_abs_err": worst_abs, "n": n, "B": B}), flush=True)
    return worst_abs


def _svd_fit(xk, xi, fk):
    """Order-2 2D unweighted least-squares DOFs by SVD (scipy's lstsq,
    LAPACK gelsd, float64), on offsets scaled by each case's
    h = max |xk - xi|; returns the DOFs and h (DOF j scales by h^-deg_j)."""
    from math import factorial

    import scipy.linalg

    invf = np.array([1.0 / (factorial(a) * factorial(b)) for a, b in zip(EX2, EY2)])
    out, hs = np.empty((len(xk), 6)), np.empty(len(xk))
    for j in range(len(xk)):
        d = xk[j] - xi[j]
        hs[j] = h = np.abs(d).max()
        d = d / h
        c = (d[:, 0:1] ** EX2) * (d[:, 1:2] ** EY2) * invf
        out[j] = scipy.linalg.lstsq(c, fk[j], lapack_driver="gelsd")[0] / h ** (EX2 + EY2)
    return out, hs


def _profile(fn):
    """Self device time (ms) of the ten costliest ops over one call of fn,
    from torch.profiler; "not measured" with the reason if it cannot trace."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
        out = {e.key[:80]: e.self_device_time_total / 1e3 for e in rows[:10]
               if e.self_device_time_total > 0}
        return out or "not measured: no device time in the trace"
    except Exception as e:   # the profiler is instrumentation, not the path
        return "not measured: %s" % (e,)


def phase_ibvp(dev, wtt, pts, idx_np, plan, setup):
    """The gather gate row at n = 2^22: prepare once (order 2, uniform,
    Jacobi, chol), then per step fk = gather_rows(u, idx, plan), fi, _ =
    solve(prep, fk), u += 1e-5 (fi[:, X2] + fi[:, Y2]); one field and three
    (one gather, one multi-field solve).  Times, the per-step split, the
    gather launch against its bound and yardsticks, kernel path = plain
    path, and DOF parity against an f64 SVD fit."""
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows, gather

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    X2, Y2 = wtt.i2_X2, wtt.i2_Y2
    pts_t = torch.as_tensor(pts, device=dev)
    idx = torch.as_tensor(idx_np, device=dev)
    t0 = time.perf_counter()
    prep = wtt.prepare(pts_t[idx.long()], pts_t, order=2, scaling="jacobi")
    torch.cuda.synchronize()
    setup = dict(setup, prepare_s=time.perf_counter() - t0,
                 prepare_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 prepared_gb=sum(t.numel() * t.element_size() for t in
                                 (prep.c, prep.w, *prep.fac, prep.row_scale,
                                  prep.col_scale, prep.xi)) / 1e9,
                 coverage=plan.coverage, bad_blocks=len(plan.bad_blocks), nblk=plan.nblk)
    u0 = torch.sin(3 * pts_t[:, 0]) * torch.cos(2 * pts_t[:, 1])
    u3_0 = torch.stack([u0, torch.cos(pts_t[:, 0]) * torch.sin(pts_t[:, 1]),
                        pts_t[:, 0] * pts_t[:, 1]], dim=1)

    def kern(v):
        return gather.gather_rows(v, idx, plan)

    def update(v, fi):
        lap = fi[..., X2] + fi[..., Y2]                   # (B,) or (F, B)
        return v + DT_NU * (lap if v.ndim == 1 else lap.T)

    def step(v, gather_fn=kern):
        fk = gather_fn(v)
        fi, _ = wtt.solve(prep, fk if v.ndim == 1 else fk.permute(2, 0, 1))
        return update(v, fi)

    # the main path: STEPS steps of one field, counts read just after
    fit_kernel.LAUNCHES = fit_rows.LAUNCHES = gather.LAUNCHES = 0
    u = u0
    for _ in range(STEPS):
        u = step(u)
    torch.cuda.synchronize()
    launches = gather.LAUNCHES
    if launches != STEPS or fit_kernel.LAUNCHES or fit_rows.LAUNCHES:
        raise RuntimeError("IBVP path launches: gather %d (want %d), fit %d/%d"
                           % (launches, STEPS, fit_kernel.LAUNCHES, fit_rows.LAUNCHES))
    if not bool(torch.isfinite(u).all()):
        raise RuntimeError("IBVP path: non-finite u")
    gather.LAUNCHES = 0
    u3 = u3_0
    for _ in range(STEPS):
        u3 = step(u3)
    torch.cuda.synchronize()
    launches3 = gather.LAUNCHES
    if launches3 != STEPS or tuple(u3.shape) != (N_IBVP, 3) or not bool(
            torch.isfinite(u3).all()):
        raise RuntimeError("IBVP F=3 path: %d launches, shape %s"
                           % (launches3, tuple(u3.shape)))

    # one step through the kernel equals one step through u[idx]
    a, b = step(u0), step(u0, lambda v: gather.gather_rows_plain(v, idx))
    same, diff = torch.equal(a, b), (a - b).abs().max().item()
    del a, b
    # the DOFs of one solve against an SVD fit on the first cases, held in
    # the scaled coordinates d / h (DOF j times h^deg_j): in raw DOFs the
    # data's own rounding is amplified by h^-deg (h ~ 3e-3 here) in any f64
    # solver, so the raw error is reported, not held
    s, ix = slice(0, B_SCIPY), idx_np[:B_SCIPY]
    parity, raw = {}, {}
    for name, v in (("F1", u0), ("F3", u3_0)):
        fk = kern(v)
        fi, _ = wtt.solve(prep, fk if v.ndim == 1 else fk.permute(2, 0, 1))
        fi, vals = fi.reshape(-1, N_IBVP, 6)[:, s].cpu(), v.reshape(N_IBVP, -1).cpu().numpy()
        for f in range(fi.shape[0]):
            ref, h = _svd_fit(pts[ix], pts[s], vals[ix, f])
            ref, scale = torch.as_tensor(ref), torch.as_tensor(h[:, None] ** (EX2 + EY2))
            parity[name] = max(parity.get(name, 0.0), _rel(fi[f] * scale, ref * scale))
            raw[name] = max(raw.get(name, 0.0), _rel(fi[f], ref))
    del fk, fi
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def run(fn, u_init):
        def go():
            v = u_init
            for _ in range(STEPS):
                v = fn(v)
            return v
        return go

    ms1, ms1_t = _time_ms(run(step, u0))
    ms3, ms3_t = _time_ms(run(step, u3_0))

    def split(v, n=8):
        """Median CUDA-event times of the step's three parts over n steps
        (after one more)."""
        parts = {"gather": [], "solve": [], "update": []}
        for _ in range(n + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            fk = kern(v)
            ev[1].record()
            fi, _ = wtt.solve(prep, fk if v.ndim == 1 else fk.permute(2, 0, 1))
            ev[2].record()
            v = update(v, fi)
            ev[3].record()
            ev[3].synchronize()
            for i, k in enumerate(parts):
                parts[k].append(ev[i].elapsed_time(ev[i + 1]))
        return {k: statistics.median(t[1:]) for k, t in parts.items()}

    split1, split3 = split(u0), split(u3_0)
    profile1 = _profile(lambda: step(u0))

    # the gather launch at the path's shapes, its bound and its yardsticks
    words = u0.view(-1, 1).view(torch.int32)
    out = torch.empty((N_IBVP * K_IBVP, 2), dtype=torch.int32, device=dev)
    flat = idx.reshape(-1)
    launch_ms, launch_t = _time_ms(lambda: gather._launch([words], flat, [out]))
    wrapper_ms, wrapper_t = _time_ms(lambda: gather.gather_rows(u0, idx, plan))
    plain_ms, plain_t = _time_ms(lambda: gather.gather_rows_plain(u0, idx))
    flat_long = flat.long()
    library_ms, library_t = _time_ms(lambda: torch.index_select(u0, 0, flat_long))
    bound = _bound((flat, out, u0), 0.0)
    words3 = u3_0.contiguous().view(torch.int32)
    out3 = torch.empty((N_IBVP * K_IBVP, 6), dtype=torch.int32, device=dev)
    launch3_ms, launch3_t = _time_ms(lambda: gather._launch([words3], flat, [out3]))
    library3_ms, library3_t = _time_ms(lambda: torch.index_select(u3_0, 0, flat_long))
    bound3 = _bound((flat, out3, u3_0), 0.0)
    del out, out3, flat_long
    print(json.dumps({
        "path": "ibvp", "n": N_IBVP, "K": K_IBVP, "steps": STEPS,
        "setup": setup, "launches": {"gather_rows_F1": launches, "gather_rows_F3": launches3,
                                     "per_step": launches / STEPS},
        "ms_per_step": {"F1": ms1 / STEPS, "F3": ms3 / STEPS},
        "ms_per_run_of_%d" % STEPS: {"F1": ms1_t, "F3": ms3_t},
        "split_ms": {"F1": split1, "F3": split3},
        "profile_one_step_F1_self_device_ms": profile1,
        "gather_ms": {"launch_F1": launch_t, "gather_rows_F1": wrapper_t,
                      "plain_u[idx]_F1": plain_t, "index_select_F1": library_t,
                      "launch_F3": launch3_t, "index_select_F3": library3_t},
        "gather_bound_F1": bound, "gather_bound_F3": bound3,
        "gather_achieved_gb_s_F1": bound["bytes"] / launch_ms / 1e6,
        "kernel_step_equals_plain_step": same, "kernel_vs_plain_step_max_abs": diff,
        "dof_parity_vs_svd_scaled": parity, "dof_rel_err_vs_svd_raw": raw,
        "tol": PARITY,
        "peak_mem_gb": round(peak_gb, 3)}), flush=True)
    if not same:
        raise RuntimeError("a step through the gather kernel differs from one through "
                           "u[idx]: %.3e" % diff)
    if max(parity.values()) > PARITY:
        raise RuntimeError("IBVP DOF parity vs SVD (scaled): %s > %.0e" % (parity, PARITY))
    return {"launches": launches, "ms": launch_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound, "ms_F3": launch3_ms,
            "step_ms_F1": ms1 / STEPS, "step_ms_F3": ms3 / STEPS,
            "library_ms_F3": library3_ms, "bound_ms_F3": bound3["bound_ms"],
            "launches_F3": launches3}


def phase_heat_example(dev):
    """``wlsqm_tpu_torch.examples.ibvp_heat.run()`` on the card: each
    field's max error against the exact solution under 5e-3."""
    from wlsqm_tpu_torch.examples import ibvp_heat

    t0 = time.perf_counter()
    res = ibvp_heat.run()
    torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"heat_example": res}), flush=True)
    if not res["device"].startswith("cuda") or res["gather_launches"] != 2 * res["steps"]:
        raise RuntimeError("the heat example did not run its gathers on the card")


# -- the examples: the Euler flow step, the adjoint recovery, the rest --------------

def phase_euler(dev, wtt, smi, heat):
    """The Euler example's flow step at full width: nside = N_EULER_SIDE
    (n = 2^22), K = 24, order 3, 8 flux fields (the example's cloud recipe
    grown; a step that does not fit in device memory fails).  Set-up
    (cloud and Morton order, the boundary band's periodic kNN on the native
    tree, the window plan, ``prepare``) timed on the host; the main path,
    EULER_STEPS SSP-RK3 steps (3 gather_rows launches and 3 multi-field
    solves a step), counted; ms per step (median of REPS runs of
    EULER_STEPS steps, CUDA events) beside the heat step's figures of this
    run; the split into flux, gather, solve and the RK update; the gather
    launch at these shapes (64-byte rows: the vector instance of 16 words in
    16-byte pieces) bit for bit against its plain version, against its bound
    and index_select, beside the word instance these rows took before; the density
    error against the exact vortex at t = EULER_STEPS dt; peak memory.  Then
    three steps at the example's nside 48 on the card against the same
    steps on the CPU (1e-10 relative to max(|U|, 1)), and the example's own
    run to t = 1 on the card.  Returns the launches of the path and the
    gather's figures."""
    from wlsqm_tpu_torch.examples import euler_flow as ef
    from wlsqm_tpu_torch.ops import gather

    line = {"path": "euler", "device": smi, "k": ef.K, "order": ef.ORDER, "fields": 8}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    nside = N_EULER_SIDE
    flow = ef.setup(nside, ef.K, device=dev)
    U = flow.initial()
    dt = ef.cfl_dt(nside)
    _zero_launches()
    for _ in range(EULER_STEPS):
        U = flow.step(U, dt)
    torch.cuda.synchronize()
    launches = _kernel_launches()
    err = ef.density_error(flow, U, EULER_STEPS * dt)
    line.update(n=len(flow.pts), nside=nside, dt=dt, steps=EULER_STEPS,
                setup_s=flow.setup_s, band=flow.band, coverage=flow.plan.coverage,
                bad_blocks=len(flow.plan.bad_blocks), nblk=flow.plan.nblk,
                prepared_gb=sum(t.numel() * t.element_size() for t in (
                    flow.prep.c, flow.prep.w, *flow.prep.fac, flow.prep.row_scale,
                    flow.prep.col_scale)) / 1e9,
                launches=launches, density_max_error=float(err.max()),
                density_rms_error=float(np.sqrt((err ** 2).mean())),
                finite=bool(torch.isfinite(U).all()))
    U0 = flow.initial()

    def run():
        v = U0
        for _ in range(EULER_STEPS):
            v = flow.step(v, dt)
        return v

    ms, ms_t = _time_ms(run)
    line["ms_per_step"] = ms / EULER_STEPS
    line["ms_per_run_of_%d" % EULER_STEPS] = ms_t

    def split(v, n=2):
        """Per step, the median over n steps of each part's CUDA-event time
        summed over the three stages."""
        parts = {"flux": [], "gather": [], "solve": [], "update": []}
        for _ in range(n):
            acc = dict.fromkeys(parts, 0.0)
            stages = []
            for c0, c1 in ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0)):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
                w = stages[-1] if stages else v
                ev[0].record()
                fl = ef.flux_fields(w)
                ev[1].record()
                fk = flow.gather(fl)
                ev[2].record()
                r = flow.divergence(fk)
                ev[3].record()
                stages.append(c0 * v + c1 * (w + dt * r))     # the step's RK combination
                ev[4].record()
                ev[4].synchronize()
                for i, k in enumerate(parts):
                    acc[k] += ev[i].elapsed_time(ev[i + 1])
                del fl, fk, r
            v = stages[-1]
            for k in parts:
                parts[k].append(acc[k])
        return {k: statistics.median(t) for k, t in parts.items()}

    line["split_ms_per_step"] = split(U0)
    fl = ef.flux_fields(U0)
    flat = flow.own.reshape(-1)
    words = fl.contiguous().view(torch.int32)
    out = torch.empty((flat.numel(), words.shape[1]), dtype=torch.int32, device=dev)
    instance = gather._vector_plan(4 * words.shape[1], words.data_ptr(), out.data_ptr())
    launch_ms, launch_t = _time_ms(lambda: gather._launch([words], flat, [out]))
    ref = gather.gather_rows_plain(fl, flow.own).reshape(flat.numel(), -1).view(torch.int32)
    # the main path's instance at its shapes, bit for bit against u[idx]
    bits_equal = torch.equal(out, ref)

    def word_instance():     # the instance these rows took before, for the record
        status = gather.load().lib.wlsqm_gather_words(
            words.data_ptr(), None, flat.data_ptr(), out.data_ptr(), None, words.shape[0],
            flat.numel(), words.shape[1], 0, torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError("the word instance failed: CUDA error %d" % status)

    out.zero_()
    words_ms, words_t = _time_ms(word_instance)
    bits_equal = bits_equal and torch.equal(out, ref)
    del ref
    flat_long = flat.long()
    library_ms, library_t = _time_ms(lambda: torch.index_select(fl, 0, flat_long))
    plain_ms, plain_t = _time_ms(lambda: gather.gather_rows_plain(fl, flow.own))
    bound = _bound((flat, out, fl), 0.0)
    line["gather"] = {"launch_ms": launch_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound": bound, "launch_t": launch_t, "index_select_t": library_t,
                      "vector_plan_load_bytes": instance, "word_instance_ms": words_ms,
                      "word_instance_t": words_t, "bit_equal_to_plain": bits_equal}
    line["peak_mem_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
    del out, flat_long, fl, words, flat, U, U0, flow
    torch.cuda.empty_cache()
    line["heat_step_ms_this_run"] = {"F1": heat["step_ms_F1"], "F3": heat["step_ms_F3"],
                                     "n": N_IBVP, "K": K_IBVP, "order": 2}

    # the example's nside on the card against the CPU, and the example itself
    small = ef.cfl_dt(ef.NSIDE)
    Us = []
    for d in ("cpu", dev):
        f = ef.setup(ef.NSIDE, ef.K, device=d)
        v = f.initial()
        for _ in range(3):
            v = f.step(v, small)
        Us.append(v.cpu())
    line["nside48_card_vs_cpu"] = _rel(Us[1], Us[0])
    t0 = time.perf_counter()
    res = ef.run()
    res["wall_s"] = time.perf_counter() - t0
    line["example"] = res
    line["tol"] = PARITY
    print(json.dumps(line), flush=True)
    if launches != _launches(gather=3 * EULER_STEPS):
        raise RuntimeError("the Euler path's launches: %s (want %d gathers)"
                           % (launches, 3 * EULER_STEPS))
    if not bits_equal or instance != 16:
        raise RuntimeError("the gather at n = %d, K = %d: bits equal %s, instance %s"
                           % (line["n"], ef.K, bits_equal, instance))
    if not line["finite"] or line["density_max_error"] >= ef.TOL:
        raise RuntimeError("the Euler step at n = %d drifted: %.3e"
                           % (line["n"], line["density_max_error"]))
    if line["nside48_card_vs_cpu"] > PARITY:
        raise RuntimeError("the Euler step on the card is %.3e off the CPU's"
                           % line["nside48_card_vs_cpu"])
    if not res["device"].startswith("cuda") or res["gather_launches"] != 3 * res["steps"]:
        raise RuntimeError("the Euler example did not run its gathers on the card")
    return launches, line["gather"]


def phase_adjoint(dev, wtt, smi):
    """The adjoint example on the card: its own run (32 x 32 grid, 60
    steps, one rows-kernel launch with sens a step, the bar final < 0.6
    base), then a 1024 x 1024 grid (B = 2^20, K = 12, neighbours from the
    native host tree): one loss-and-gradient step counted (one rows launch),
    its gradient held to the f64 engine's autograd gradient on the same
    inputs (1e-10 of its largest entry), and ms per loss-and-gradient step
    (median of REPS, CUDA events); then the step's rows launch alone beside
    its bound, the wrapper, the plain version and the library yardstick
    (_adjoint_rows_times).  Returns the launches of the path and the
    launch's figures."""
    from wlsqm_tpu_torch.examples import adjoint_data_recovery as ad
    from wlsqm_tpu_torch.fitter import engine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    line = {"path": "adjoint", "device": smi}
    t0 = time.perf_counter()
    before = _kernel_launches()["fit_rows"]
    res = ad.run()
    line["example"] = dict(res, wall_s=time.perf_counter() - t0,
                           rows_launches=_kernel_launches()["fit_rows"] - before)
    t0 = time.perf_counter()
    p = ad.problem(ADJ_SIDE, device=dev, dense=False)
    line["setup_s"] = time.perf_counter() - t0
    B = len(p.pts)
    _zero_launches()
    _, grad = ad.loss_and_grad(p, p.u_obs)
    torch.cuda.synchronize()
    launches = _kernel_launches()
    u = p.u_obs.clone().requires_grad_(True)
    fi = engine.fit_batch(p.xk, u[p.idx], p.nk, p.xi, p.xk.new_zeros((B, 6)),
                          torch.full((B,), 2, dtype=torch.int32, device=dev),
                          torch.zeros(B, dtype=torch.int64, device=dev),
                          torch.full((B,), wtt.WEIGHT_CENTER, dtype=torch.int32, device=dev),
                          dimension=2, NO=6)[0]
    (ref,) = torch.autograd.grad(ad.loss_of(p, fi[:, wtt.i2_X2] + fi[:, wtt.i2_Y2], u), u)
    del fi, u
    step_ms, step_t = _time_ms(lambda: ad.loss_and_grad(p, p.u_obs))
    line.update(B=B, k=ad.K, launches=launches, grad_vs_engine=_grad_rel(grad, ref),
                ms_per_loss_and_grad=step_ms, loss_and_grad_t=step_t,
                peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3), tol=PARITY)
    rows = _adjoint_rows_times((p.xk, p.u_obs[p.idx], p.nk, p.xi))
    line["rows_launch"] = rows
    print(json.dumps(line), flush=True)
    ex = line["example"]
    if not ex["device"].startswith("cuda") or ex["rows_launches"] != ad.STEPS:
        raise RuntimeError("the adjoint example did not run the rows kernel each step")
    if launches != _launches(rows=1):
        raise RuntimeError("the adjoint step at 2^20 launches %s" % (launches,))
    if line["grad_vs_engine"] > PARITY:
        raise RuntimeError("the adjoint gradient at 2^20 is %.3e off the engine's"
                           % line["grad_vs_engine"])
    return launches, rows


#: examples 3-8 of the port, run on the card at their own sizes
EXAMPLES = ("gradient_stencil_design", "response_surface", "wlsqm_tour",
            "expertsolver_example", "distributed_pipeline", "jit_plan_sharding",
            "drivers_benchmark")


def _summary(res):
    """An example's result with its arrays left out."""
    return {k: v for k, v in res.items() if not isinstance(v, (np.ndarray, dict, list))
            or k in ("rows", "tour_routing")}


def phase_examples(dev, smi):
    """The rest of the port's examples on the card, each at its own size:
    ``run()`` (on the card: no ``device`` given) must not raise and must
    report a CUDA device; each one's kernel launches and wall seconds.
    Returns the launches of the path (all of them)."""
    import importlib

    line = {"path": "examples", "device": smi}
    _zero_launches()
    for name in EXAMPLES:
        mod = importlib.import_module("wlsqm_tpu_torch.examples." + name)
        before = _kernel_launches()
        t0 = time.perf_counter()
        res = mod.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = _kernel_launches()
        line[name] = dict(_summary(res), wall_s=wall,
                          launches={k: after[k] - before[k] for k in after})
        if not str(res["device"]).startswith("cuda"):
            raise RuntimeError("example %s ran on %s" % (name, res["device"]))
    launches = _kernel_launches()
    line["launches"] = launches
    print(json.dumps(line, default=str), flush=True)
    if not launches["fit_moment"] or not launches["fit_rows"]:
        raise RuntimeError("the examples did not reach both fit kernels: %s" % (launches,))
    return launches


# -- the compat surface: ExpertSolver and the fit_* entries ------------------------

def _expert_cloud(B, K=K):
    """The regression gate's expert row (benchmarks/run_regression_gate.py
    l.202-225), seed 5: xk = xi + U(-0.5, 0.5), 2D, order 4, CENTER, and 8
    fields sin((1 + 0.1 i) x) cos y, all NumPy on the host."""
    rng = np.random.default_rng(5)
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (B, K, 2))
    fks = [np.sin((1 + 0.1 * i) * xk[..., 0]) * np.cos(xk[..., 1]) for i in range(8)]
    return xi, xk, fks


def _rel_rows(a, b):
    """Per-case L∞ error of a against b relative to max(|b|, 1), NumPy."""
    return np.abs(a - b).max(1) / np.maximum(np.abs(b).max(1), 1.0)


def _solve_split(dev, wtt, s, fk):
    """The parts of one ``ExpertSolver.solve``, CUDA events each: the fk
    upload from pageable NumPy, the prepared path's solve on the card
    (``api.solve`` on the solver's Prepared), the fi download, and the host
    write-back into the caller's array."""
    B = fk.shape[0]
    fk_d = torch.as_tensor(fk, device=dev)
    fi_d = torch.empty((B, 15), dtype=torch.float64, device=dev)
    fi_h, fi = fi_d.cpu().numpy(), np.zeros((B, 15))
    out = {"upload": _time_ms(lambda: torch.as_tensor(fk, device=dev))[0],
           "solve_prepared": _time_ms(lambda: wtt.solve(s.prepared, fk_d))[0],
           "download": _time_ms(lambda: fi_d.cpu())[0]}
    t0 = time.perf_counter()
    fi[:, :15] = fi_h
    out["write_back_host"] = (time.perf_counter() - t0) * 1e3
    return out


def _expert_paths(dev, wtt, s, xk, xi, fk):
    """One field's solve on the card, device time only, three ways on the
    same geometry: the prepared path ``ExpertSolver.solve`` runs (``api.solve``
    on its Prepared) against the kernel routes it could take instead, the
    data-gated auto route of the fit_* entries (``fit_many(gate="data")``)
    and the geometry-gated plan (``plan_fit_many``, replayed); with the
    data gate's launches and the share of cases it keeps on the kernel.
    Returns (times, the data-gated fi, the per-case data-gate mask)."""
    from wlsqm_tpu_torch.fitter import calibration, condprobe
    from wlsqm_tpu_torch.ops import fit_kernel

    B = fk.shape[0]
    xk_d, xi_d, fk_d = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                        for a in (xk, xi, fk))
    nk_d = torch.full((B,), K, dtype=torch.int32, device=dev)
    com = dict(nk=nk_d, order=ORDER, weighting=wtt.WEIGHT_CENTER)
    plan = wtt.plan_fit_many(xk_d, xi_d, **com)
    _zero_launches()
    fi_gated = wtt.fit_many(xk_d, fk_d, xi_d, gate="data", **com).fi
    launches = _kernel_launches()
    fi_k, key = fit_kernel.fit_kernel(xk_d, fk_d, nk_d, xi_d, dimension=2, order=ORDER,
                                      weighting=wtt.WEIGHT_CENTER, emit_cond=True)
    sure = key * calibration.data_ratio(fi_k, fk_d, nk_d) <= condprobe.data_edges()["moments"]
    times = {"B": B, "prepared_ms": _time_ms(lambda: wtt.solve(s.prepared, fk_d))[0],
             "kernel_data_gate_ms": _time_ms(
                 lambda: wtt.fit_many(xk_d, fk_d, xi_d, gate="data", **com))[0],
             "kernel_plan_ms": _time_ms(
                 lambda: wtt.fit_many(xk_d, fk_d, xi_d, plan=plan, **com))[0],
             "plan_route": plan.route.path, "data_gate_share": float(sure.double().mean()),
             "data_gate_launches": launches}
    return times, fi_gated.cpu().numpy(), sure.cpu().numpy()


def _expert(wtt, B, **extra):
    return wtt.ExpertSolver(2, np.full(B, K, np.int32), np.full(B, ORDER, np.int32),
                            np.zeros(B, np.int64), np.full(B, wtt.WEIGHT_CENTER, np.int32),
                            **extra)


def _kernel_launches():
    """The kernels' launch counts, and of the fit kernels' the launches with
    the key (the package's own counter, :func:`wlsqm_tpu_torch.warmup.launch_counts`)."""
    from wlsqm_tpu_torch.warmup import launch_counts

    return launch_counts()


def _launches(moment=0, rows=0, key_moment=0, key_rows=0, gather=0):
    return {"fit_moment": moment, "fit_rows": rows,
            "cond_estimate@fit_moment": key_moment, "cond_estimate@fit_rows": key_rows,
            "gather_rows": gather}


def _zero_launches():
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows, gather

    fit_kernel.LAUNCHES = fit_rows.LAUNCHES = gather.LAUNCHES = 0
    fit_kernel.COND_LAUNCHES = fit_rows.COND_LAUNCHES = 0


def phase_expert(dev, wtt, smi):
    """``ExpertSolver`` at B = 2^20 on the gate row's expert cloud: prepare,
    8 NumPy solves on the prepared path (no kernel launch), parity against
    scipy and the precision="f64" twin (the same path, bit for bit); the
    solve's device time against the two kernel routes on the same geometry
    at 2^20 and 8192, and the data-gated route held to 1e-10 against the
    prepared solve and the long-double oracle on every case it keeps on the
    kernel (ROADMAP C4); the gate row's rate at 8192, ``solve_device`` on the
    (8, B, K) stack, ``solve_stream`` against sequential ``solve_device``,
    ``conds(estimate=True)`` against the SVD conditions, memory."""
    from wlsqm_tpu_torch.fitter import calibration

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xi, xk, fks = _expert_cloud(B_EXPERT)
    host_s = time.perf_counter() - t0
    s = _expert(wtt, B_EXPERT)
    t0 = time.perf_counter()
    s.prepare(xi, xk)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    fi = np.zeros((B_EXPERT, 15))
    _zero_launches()
    per_solve, solve_s = [], []
    for fk in fks:
        before = sum(_kernel_launches().values())
        t0 = time.perf_counter()
        s.solve(fk, fi)
        solve_s.append(time.perf_counter() - t0)
        per_solve.append(sum(_kernel_launches().values()) - before)
    launches = _kernel_launches()
    if per_solve != [0] * len(fks):
        raise RuntimeError("ExpertSolver.solve launched %s kernels, not the prepared path"
                           % (per_solve,))
    scipy_err = parity_check(xk[:B_SCIPY] - xi[:B_SCIPY, None, :], fks[-1][:B_SCIPY],
                             fi[:B_SCIPY])

    # the lowest-frequency field, sin x cos y: the twin, and the kernel routes
    s.solve(fks[0], fi)
    twin = _expert(wtt, B_EXPERT, precision="f64")
    twin.prepare(xi, xk)
    fi2 = np.zeros((B_EXPERT, 15))
    twin.solve(fks[0], fi2)
    del twin
    torch.cuda.empty_cache()
    twin_equal = bool(np.array_equal(fi, fi2))
    del fi2
    paths_big, fi_g, sure = _expert_paths(dev, wtt, s, xk, xi, fks[0])
    diff = _rel_rows(fi_g, fi)
    sel = np.union1d(np.arange(B_ORACLE),
                     np.flatnonzero(sure)[np.argsort(-diff[sure])[:256]])
    orc = calibration._strong_oracle(xk[sel], xi[sel], fks[0][sel], wtt.WEIGHT_CENTER, 2)
    g_orc, p_orc = _rel_rows(fi_g[sel], orc), _rel_rows(fi[sel], orc)
    acc = {"field": "sin(x) cos(y)", "data_gate_share": float(sure.mean()),
           "data_gate_certified_vs_prepared": float(diff[sure].max()),
           "data_gate_certified_vs_oracle": float(g_orc[sure[sel]].max()),
           "data_gate_rest_vs_prepared": float(diff[~sure].max(initial=0.0)),
           "prepared_vs_oracle": float(p_orc.max()),
           "prepared_vs_oracle_on_certified": float(p_orc[sure[sel]].max()),
           "oracle_cases": int(len(sel))}
    mem_used = s.memory_used()[0]
    del fi_g, orc
    torch.cuda.empty_cache()

    split_big = _solve_split(dev, wtt, s, fks[0])

    # solve_device on the (8, B, K) stack, and solve_stream against it
    stack = torch.stack([torch.as_tensor(fk, device=dev) for fk in fks])
    dev_ms, dev_t = _time_ms(lambda: s.solve_device(stack))
    del stack
    streamed = list(s.solve_stream(fks))
    stream_same = all(np.array_equal(a, s.solve_device(fk)[0].cpu().numpy())
                      and it == 0 for fk, (a, it) in zip(fks, streamed))
    del streamed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rate_big = B_EXPERT * len(fks) / sum(solve_s) / 1e3

    # the gate row's own size and loop: 24 solves, median of REPS
    small = _expert(wtt, B_GATE_EXPERT)
    small.prepare(xi[:B_GATE_EXPERT], xk[:B_GATE_EXPERT])
    fi_s = np.zeros((B_GATE_EXPERT, 15))
    small.solve(fks[0][:B_GATE_EXPERT], fi_s)
    rates = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for i in range(24):
            small.solve(fks[i % 8][:B_GATE_EXPERT], fi_s)
        rates.append(B_GATE_EXPERT * 24 / (time.perf_counter() - t0) / 1e3)
    split_small = _solve_split(dev, wtt, small, fks[0][:B_GATE_EXPERT])
    paths_small = _expert_paths(dev, wtt, small, xk[:B_GATE_EXPERT], xi[:B_GATE_EXPERT],
                                fks[0][:B_GATE_EXPERT])[0]
    del small, s

    # the estimates against the SVD conditions
    dbg = _expert(wtt, B_CONDS, debug=True)
    dbg.prepare(xi[:B_CONDS], xk[:B_CONDS])
    ratio = dbg.conds(estimate=True) / dbg.conds()
    del dbg
    torch.cuda.empty_cache()
    line = {"path": "expert", "B": B_EXPERT, "device": smi, "launches": launches,
            "launches_per_solve": per_solve, "host_setup_s": round(host_s, 3),
            "prepare_s": prepare_s, "solve_s": solve_s,
            "k_solves_per_s_2^20": rate_big,
            "k_solves_per_s_8192": rates, "k_solves_per_s_8192_median":
                statistics.median(rates),
            "split_ms_2^20": split_big, "split_ms_8192": split_small,
            "paths_2^20": paths_big, "paths_8192": paths_small,
            "solve_device_F8_ms": dev_t, "solve_device_F8_median_ms": dev_ms,
            "solve_stream_equal": stream_same, "memory_used_gb": mem_used / 1e9,
            "peak_mem_gb": round(peak_gb, 3), "parity_vs_scipy": scipy_err,
            "f64_twin_equal": twin_equal, "accuracy": acc, "tol": PARITY,
            "cond_estimate_over_svd": [float(ratio.min()), float(ratio.max())]}
    print(json.dumps(line), flush=True)
    held = (scipy_err, acc["data_gate_certified_vs_prepared"],
            acc["data_gate_certified_vs_oracle"])
    if not (max(held) <= PARITY and acc["data_gate_share"] > 0):
        raise RuntimeError("expert parity: scipy %.3e; data gate's certified cases vs the "
                           "prepared solve %.3e, vs the oracle %.3e > %.0e" % (*held, PARITY))
    if not twin_equal:
        raise RuntimeError("the default ExpertSolver differs from its precision='f64' twin")
    if paths_big["data_gate_launches"] != _launches(moment=1, key_moment=1):
        raise RuntimeError("the data-gated route did not launch the moment kernel once: %s"
                           % (paths_big["data_gate_launches"],))
    if not stream_same:
        raise RuntimeError("solve_stream differs from sequential solve_device")
    if not (ratio.min() >= 0.5 and ratio.max() <= 1.01):
        raise RuntimeError("cond estimates outside [0.5, 1.01] of the SVD's: %s"
                           % (line["cond_estimate_over_svd"],))
    return launches


def _bench_np(B, K, dim, seed):
    """The bench workload as NumPy (xi = 0; fk = sin 3x cos 2y + noise)."""
    rng = np.random.default_rng(seed)
    xk = rng.uniform(-1.0, 1.0, (B, K, dim))
    fk = np.sin(3.0 * xk[..., 0]) * np.cos(2.0 * xk[..., -1])
    return xk, fk + 0.01 * rng.standard_normal((B, K))


def _compat_call(wtt, name, path, args, engine_args):
    """One fit_* call: its kernel launches (counted from 0), wall time and
    count; then the same call on the port's f64 engine (under
    ``set_compat_precision("f64")``), which must launch nothing."""
    from wlsqm_tpu_torch import config

    fn = getattr(wtt, name)
    _zero_launches()
    t0 = time.perf_counter()
    it = fn(*args)
    wall = time.perf_counter() - t0
    launches = _kernel_launches()
    saved = config.compat_precision()
    config.set_compat_precision("f64")
    try:
        it_e = fn(*engine_args)
    finally:
        config.set_compat_precision(saved)
    if _kernel_launches() != launches:
        raise RuntimeError("%s on the engine launched a kernel" % name)
    return {"path": path, "call": name, "launches": launches, "wall_s": wall,
            "iterations": it, "engine_iterations": it_e}


def phase_compat(dev, wtt, smi):
    """The fit_* entries on the card: fit_2D_many at 2^20 (the moment kernel,
    one launch), fit_3D_many with sens and a known DOF at 65,536 (the rows
    kernel's warp body), fit_1D_iterative_many at 65,536 under count fidelity
    (the engine) and without (the moment kernel, as the JAX package routes
    1D ALGO_ITERATIVE), and fit_2D on one case; each held to the port's
    engine at 1e-10, the 2D calls also to scipy."""
    from wlsqm_tpu_torch import config

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = []

    def held(rec, fi, fi_e, extra=()):
        rec["vs_engine"] = _rel_nan(torch.as_tensor(fi).reshape(len(fi), -1),
                                    torch.as_tensor(fi_e).reshape(len(fi), -1))
        for a, b in extra:
            rec["vs_engine"] = max(rec["vs_engine"], _rel_nan(
                torch.as_tensor(a).reshape(len(a), -1), torch.as_tensor(b).reshape(len(a), -1)))
        out.append(rec)

    # fit_2D_many at 2^20
    B = B_COMPAT_2D
    xk, fk = _bench_np(B, K, 2, 61)
    cfg = (np.full(B, ORDER, np.int32), np.zeros(B, np.int64),
           np.full(B, wtt.WEIGHT_CENTER, np.int32))
    nk, xi = np.full(B, K, np.int32), np.zeros((B, 2))
    fi = np.zeros((B, 15))
    fi_e = np.zeros((B_ENGINE, 15))
    rec = _compat_call(
        wtt, "fit_2D_many", "fit_2D_many", (xk, fk, nk, xi, fi, None, False, *cfg),
        (xk[:B_ENGINE], fk[:B_ENGINE], nk[:B_ENGINE], xi[:B_ENGINE], fi_e, None, False,
         *(c[:B_ENGINE] for c in cfg)))
    rec["parity_vs_scipy"] = parity_check(xk[:B_SCIPY], fk[:B_SCIPY], fi[:B_SCIPY])
    held(rec, fi[:B_ENGINE], fi_e)
    if rec["launches"] != _launches(moment=1, key_moment=1):
        raise RuntimeError("fit_2D_many did not launch the moment kernel once: %s"
                           % (rec["launches"],))

    # fit_3D_many, do_sens and a known DOF, at 65,536: the rows kernel
    B, K3 = B_COMPAT, K_GRID[3]
    xk, fk = _bench_np(B, K3, 3, 62)
    NO3 = wtt.number_of_dofs(3, ORDER)
    cfg = (np.full(B, ORDER, np.int32), np.full(B, wtt.b3_F, np.int64),
           np.full(B, wtt.WEIGHT_CENTER, np.int32))
    fi0 = np.zeros((B, NO3))
    fi0[:, 0] = fk[:, 0]
    fi, sens = fi0.copy(), np.zeros((B, K3, NO3))
    fi_e, sens_e = fi0.copy(), np.zeros((B, K3, NO3))
    args3 = (xk, fk, np.full(B, K3, np.int32), np.zeros((B, 3)))
    rec = _compat_call(wtt, "fit_3D_many", "fit_3D_many_sens",
                       (*args3, fi, sens, True, *cfg), (*args3, fi_e, sens_e, True, *cfg))
    held(rec, fi, fi_e, [(sens, sens_e)])
    if rec["launches"] != _launches(rows=1, key_rows=1):
        raise RuntimeError("fit_3D_many with sens did not launch the rows kernel once: %s"
                           % (rec["launches"],))
    del sens, sens_e

    # fit_1D_iterative_many at 65,536: under count fidelity, then without
    xk, fk = _bench_np(B, K_GRID[1], 1, 63)
    args1 = (xk[..., 0], fk, np.full(B, K_GRID[1], np.int32), np.zeros(B))
    cfg = (np.full(B, ORDER, np.int32), np.zeros(B, np.int64),
           np.full(B, wtt.WEIGHT_CENTER, np.int32))
    saved = config._ITER_COUNT_FIDELITY
    try:
        for fidelity, want in ((None, 0), (False, 1)):
            config.set_iter_count_fidelity(fidelity)
            fi, fi_e = np.zeros((B, 5)), np.zeros((B, 5))
            rec = _compat_call(
                wtt, "fit_1D_iterative_many",
                "fit_1D_iterative_many_" + ("fidelity" if fidelity is None else "kernel"),
                (*args1, fi, None, False, *cfg, 3), (*args1, fi_e, None, False, *cfg, 3))
            held(rec, fi, fi_e)
            if rec["launches"] != _launches(moment=want, key_moment=want):
                raise RuntimeError("fit_1D_iterative_many (fidelity %s) launched %s"
                                   % (fidelity, rec["launches"]))
    finally:
        config._ITER_COUNT_FIDELITY = saved

    # fit_2D on one case
    xk, fk = _bench_np(1, K, 2, 64)
    fi, fi_e = np.zeros(15), np.zeros(15)
    one = (xk[0], fk[0], np.zeros(2))
    rec = _compat_call(wtt, "fit_2D", "fit_2D_single",
                       (*one, fi, None, False, ORDER, 0, wtt.WEIGHT_CENTER),
                       (*one, fi_e, None, False, ORDER, 0, wtt.WEIGHT_CENTER))
    rec["parity_vs_scipy"] = parity_check(xk, fk, fi[None])
    held(rec, fi[None], fi_e[None])

    line = {"path": "compat", "device": smi, "calls": out, "tol": PARITY,
            "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}
    print(json.dumps(line), flush=True)
    worst = max(max(r["vs_engine"], r.get("parity_vs_scipy", 0.0)) for r in out)
    if worst > PARITY:
        raise RuntimeError("compat parity %.3e > %.0e: %s" % (worst, PARITY, out))
    return {r["path"]: r["launches"] for r in out}


# -- the certified auto route ------------------------------------------------------

def _key_check(name, key, ref, worst):
    """Kernel key against plain key: the same non-finite pattern, finite keys
    within KEY_TOL (relative); tracks the worst differences."""
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(key)):
        raise RuntimeError("conditioning key: non-finite pattern differs: %s" % name)
    if bool(fin.any()):
        diff = (key[fin] - ref[fin]).abs()
        worst["abs"] = max(worst["abs"], diff.max().item())
        rel = (diff / ref[fin]).max().item()
        worst["rel"] = max(worst["rel"], rel)
        if not rel <= KEY_TOL:
            raise RuntimeError("conditioning key vs plain %s: %.3e > %.0e"
                               % (name, rel, KEY_TOL))
    return fin


def _same(name, a, b):
    """The outputs of a launch with the key equal those of one without, bit
    for bit (NaN sens columns of known DOFs compare as bits too)."""
    for x, y in zip(a, b):
        if (x is None) != (y is None) or (x is not None and not torch.equal(
                _bits(x) if x.dtype.is_floating_point else x,
                _bits(y) if y.dtype.is_floating_point else y)):
            raise RuntimeError("outputs differ with and without the key: %s" % name)


def phase_cond_vs_plain(dev, wtt):
    """Both kernels with ``emit_cond=True`` against their plain versions at
    2^18 over the grids of phase_moment_vs_plain and phase_rows_vs_plain (2D
    orders 0-4, both weightings; dims 1-3 with a random knowns mask; ragged
    nk, xi off zero): the finite keys agree to KEY_TOL, the non-finite
    pattern is the same, and every other output is bit-identical with and
    without the key (the rows kernel's sens and ALGO_ITERATIVE outputs too,
    at B_GRID).  Then, at 2D and 3D order 4: key >= 0.999 cond_2 amp by SVD
    on B_COND2 cases, and collapsed or collinear neighbourhoods never
    certify.  Times the launches with the key at the headline
    configuration, their plain versions and ``condprobe.cond_key``, and the
    rows launch without and with the key at the dim3 path's configuration."""
    from wlsqm_tpu_torch.fitter import condprobe, defs
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    gen = torch.Generator(device=dev).manual_seed(2030)
    cpu_gen = torch.Generator().manual_seed(2030)
    worst = {"moments": {"abs": 0.0, "rel": 0.0}, "rows": {"abs": 0.0, "rel": 0.0}}
    per, B = {}, B_PLAIN
    for order in range(ORDER + 1):
        for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
            xk, fk, nk, xi = _cloud(B, gen, dev, order=order, ragged=True, offset=True)
            kw = dict(dimension=2, order=order, weighting=w)
            fi0 = fit_kernel.fit_kernel(xk, fk, nk, xi, **kw)
            fi1, key = fit_kernel.fit_kernel(xk, fk, nk, xi, emit_cond=True, **kw)
            _, ref = fit_kernel.fit_moments_plain(xk, fk, nk, xi, emit_cond=True, **kw)
            torch.cuda.synchronize()
            name = "moments_o%d_w%d" % (order, w)
            _same(name, (fi0,), (fi1,))
            fin = _key_check(name, key, ref, worst["moments"])
            per[name] = {"key_median": key[fin].median().item(),
                         "key_max": key[fin].max().item()}
            del xk, fk, fi0, fi1, key, ref
    grid = [(dim, order, K_GRID[dim], B_PLAIN) for dim in (1, 2, 3) for order in range(ORDER + 1)]
    grid += [(dim, order, K_WIDE, B_GRID) for dim, order in _warp_configs()]
    for dim, order, Kg, Bg in grid:
        NO = defs.number_of_dofs(dim, order)
        w = wtt.WEIGHT_CENTER if (dim + order) % 2 else wtt.WEIGHT_UNIFORM
        xk, fk, nk, xi = _cloud(Bg, gen, dev, dim=dim, K=Kg, order=order,
                                ragged=True, offset=True,
                                lo=2 * NO if dim == 1 else None)
        fi_init = torch.randn((Bg, NO), generator=gen, device=dev, dtype=torch.float64)
        kn = int(torch.randint(0, 1 << NO, (1,), generator=cpu_gen))
        kw = dict(dimension=dim, order=order, weighting=w, knowns=kn)
        name = "rows_d%d_o%d_w%d_K%d" % (dim, order, w, Kg)
        got0 = fit_rows.fit_rows(xk, fk, nk, xi, fi_init, **kw)
        got1 = fit_rows.fit_rows(xk, fk, nk, xi, fi_init, emit_cond=True, **kw)
        ref = fit_rows.fit_rows_plain(xk, fk, nk, xi, fi_init, emit_cond=True, **kw)
        torch.cuda.synchronize()
        _same(name, got0, got1[:3])
        fin = _key_check(name, got1[3], ref[3], worst["rows"])
        per[name] = {"key_median": got1[3][fin].median().item(),
                     "key_max": got1[3][fin].max().item(), "knowns": kn}
        s = slice(0, B_GRID)
        small = (xk[s], fk[s], nk[s], xi[s], fi_init[s])
        for extra in (dict(do_sens=True), dict(max_iter=3)):
            a = fit_rows.fit_rows(*small, **kw, **extra)
            b = fit_rows.fit_rows(*small, emit_cond=True, **kw, **extra)
            _same(name + str(extra), a, b[:3])
            if not torch.equal(_bits(b[3]), _bits(got1[3][s])):
                raise RuntimeError("the key changes with %s: %s" % (extra, name))
        del xk, fk, fi_init, got0, got1, ref

    # the bound est >= cond_2 * amp, and degenerate cases: 2D and 3D, order 4
    bounds = {}
    edges = condprobe.est_certified_edges()
    top_edge = max(e for e in edges.values() if e)
    for dim, Kd in ((2, K), (3, K_GRID[3])):
        xk, fk, nk, xi = _cloud(B_COND2, gen, dev, dim=dim, K=Kd, radius=0.3, offset=True)
        xk[:64] = xi[:64, None, :]                         # collapsed onto xi
        line = xi[64:128, None, :] + (xk[64:128, :, :1] - xi[64:128, None, :1])
        xk[64:128] = line                                  # on a line through xi
        kw = dict(dimension=dim, order=ORDER, weighting=wtt.WEIGHT_CENTER)
        keys = {"rows": fit_rows.fit_rows(xk, fk, nk, xi, emit_cond=True, **kw)[3]}
        if dim == 2:
            keys["moments"] = fit_kernel.fit_kernel(xk, fk, nk, xi, emit_cond=True, **kw)[1]
        cond, amp = condprobe.probe(xk[128:], nk[128:], xi[128:], ORDER,
                                    wtt.WEIGHT_CENTER, dimension=dim,
                                    sample=B_COND2)
        ca = torch.as_tensor(cond * amp, device=dev)
        for body, key in keys.items():
            if bool((key[:128] <= top_edge).any()):
                raise RuntimeError("a degenerate case certifies (%s, %dD): %s"
                                   % (body, dim, key[:128].min().item()))
            ratio = key[128:] / ca
            bounds["%s_%dd" % (body, dim)] = {"min": ratio.min().item(),
                                              "median": ratio.median().item(),
                                              "max": ratio.max().item()}
            if not bool((ratio >= 0.999).all()):
                raise RuntimeError("key < 0.999 cond_2 amp (%s, %dD): %.6f"
                                   % (body, dim, ratio.min().item()))

    # the launches with the key at the headline configuration, B_PLAIN cases
    xk, fk, nk, xi = _cloud(B, torch.Generator(device=dev).manual_seed(42), dev)
    _, _, _, inv_s = fit_kernel._prescale(xk, nk, xi)
    out = torch.empty((B, 15), dtype=torch.float64, device=dev)
    est = torch.empty((B,), dtype=torch.float64, device=dev)
    W, RS = wtt.WEIGHT_CENTER, fit_kernel.DEFAULT_REFINE_STEPS
    kw = dict(order=ORDER, weighting=W, refine_steps=RS)
    times = {
        "moments_launch": _time_ms(lambda: fit_kernel._launch(xk, fk, nk, xi, out, **kw)),
        "moments_launch_key": _time_ms(lambda: fit_kernel._launch(
            xk, fk, nk, xi, out, est, **kw)),
        "rows_launch": _time_ms(lambda: fit_rows._launch(
            xk, fk, nk, xi, inv_s, None, out, None, None, knowns=0, max_iter=0, **kw)),
        "rows_launch_key": _time_ms(lambda: fit_rows._launch(
            xk, fk, nk, xi, inv_s, None, out, None, None, est, knowns=0, max_iter=0,
            **kw)),
        "moments_plain_key": _time_ms(lambda: fit_kernel.fit_moments_plain(
            xk, fk, nk, xi, dimension=2, order=ORDER, weighting=W, emit_cond=True)),
        "rows_plain_key": _time_ms(lambda: fit_rows.fit_rows_plain(
            xk, fk, nk, xi, dimension=2, order=ORDER, weighting=W, emit_cond=True)),
        "library_cond_key": _time_ms(lambda: condprobe.cond_key(
            xk, nk, xi, dimension=2, order=ORDER, weighting=W)),
    }
    # ... and at 3D order 4 (NO = 35: the factor lives in local memory)
    d3 = _cloud(B, torch.Generator(device=dev).manual_seed(44), dev, dim=3, K=K_DIM3)
    _, _, _, inv_s3 = fit_kernel._prescale(d3[0], d3[2], d3[3])
    out3 = torch.empty((B, 35), dtype=torch.float64, device=dev)
    for name, e in (("rows_dim3_launch", None), ("rows_dim3_launch_key", est)):
        times[name] = _time_ms(lambda e=e: fit_rows._launch(
            *d3, inv_s3, None, out3, None, None, e, knowns=0, max_iter=0, **kw))
    times["library_cond_key_dim3"] = _time_ms(lambda: condprobe.cond_key(
        d3[0], d3[2], d3[3], dimension=3, order=ORDER, weighting=W))
    bound_r3 = _bound((*d3, inv_s3, out3, est),
                      _rows_flops(3, ORDER, True, d3[2].long(), RS, False, 0, 0)
                      + float(B * _cond_flops(35, "rows")))
    del d3, inv_s3, out3
    med = {k: v[0] for k, v in times.items()}
    n = nk.long()
    key_flops = float(B * _cond_flops(15, "moments"))
    bound_m = _bound((xk, fk, nk, xi, out, est),
                     _moment_flops(ORDER, True, n, RS) + key_flops)
    bound_r = _bound((xk, fk, nk, xi, inv_s, out, est),
                     _rows_flops(2, ORDER, True, n, RS, False, 0, 0)
                     + float(B * _cond_flops(15, "rows")))
    print(json.dumps({"cond_vs_plain": per, "worst": worst, "tol": KEY_TOL, "B": B,
                      "fi_bit_identical_with_key": True,
                      "key_over_cond2_amp": bounds, "degenerate_never_certify": True,
                      "ms_2^18": {k: v[1] for k, v in times.items()},
                      "bound_moments_key": bound_m, "bound_rows_key": bound_r,
                      "bound_rows_dim3_key": bound_r3}),
          flush=True)
    return {
        "moments": {"ms": med["moments_launch_key"], "plain_ms": med["moments_plain_key"],
                    "library_ms": med["library_cond_key"], **bound_m,
                    "ms_without_key": med["moments_launch"], **{
                        "max_%s_err" % k: v for k, v in worst["moments"].items()}},
        "rows": {"ms": med["rows_launch_key"], "plain_ms": med["rows_plain_key"],
                 "library_ms": med["library_cond_key"], **bound_r,
                 "ms_without_key": med["rows_launch"], **{
                     "max_%s_err" % k: v for k, v in worst["rows"].items()}}}


def phase_calibrate():
    """``calibrate_device`` on the card, at the kernels' default sweep count
    and with a second sweep (does it widen the certified edge?); the shipped
    record must hold each unit of the first within 2x."""
    import dataclasses

    from wlsqm_tpu_torch.fitter import calibration, condprobe

    shipped = calibration.active()
    if not (shipped.certified and shipped.source == "shipped"):
        raise RuntimeError("no shipped calibration record for this card: %s" % (shipped,))
    out = {}
    for steps in (None, 2):
        t0 = time.perf_counter()
        cal = calibration.calibrate_device(persist=False, refine_steps=steps)
        edges = condprobe.est_certified_edges()       # of the record just installed
        gate = condprobe.AUTO_TOL / condprobe.SAFETY
        out["refine_steps_%s" % (steps or "default")] = {
            "record": dataclasses.asdict(cal), "seconds": time.perf_counter() - t0,
            "key_edges": edges,
            "cond_amp_edges": {"rows": gate / cal.f64_cert_unit,
                               "moments": gate / cal.f64_cert_unit_m}}
        if steps is None:
            measured = cal
        calibration._reset_cache()                    # back to the shipped record
    ratios = {}
    for f in dataclasses.fields(shipped):
        a, b = getattr(shipped, f.name), getattr(measured, f.name)
        if f.name.endswith(("unit", "unit_m")):
            ratios[f.name] = b / a
    print(json.dumps({"calibrate": out, "shipped": dataclasses.asdict(shipped),
                      "measured_over_shipped": ratios}), flush=True)
    bad = {k: v for k, v in ratios.items() if not 0.5 <= v <= 2.0}
    if bad:
        raise RuntimeError("the shipped calibration record is off by more than 2x: %s"
                           % (bad,))


def _certified_cloud(B, dev, radii=RADII_CERT):
    """The certified route's batch: xi uniform in [-1, 1]^2, each case's
    radius log-uniform in ``radii``, K = 30 neighbours uniform in the
    radius' square, and a seeded COLLINEAR share of cases squeezed to
    SQUEEZE of their extent across a random direction (along a coordinate
    axis the Jacobi scale would undo the squeeze); fk as the calibration's
    problem (sin 3x cos 2y + 0.3 x y)."""
    gen = torch.Generator(device=dev).manual_seed(2031)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)

    xi = rand(B, 2) * 2 - 1
    radius = torch.exp(math.log(radii[0]) + rand(B) * math.log(radii[1] / radii[0]))
    d = (rand(B, K, 2) * 2 - 1) * radius[:, None, None]
    squeezed = rand(B) < COLLINEAR
    angle = rand(B) * math.pi
    n = torch.stack([torch.cos(angle), torch.sin(angle)], dim=1)      # across-direction
    across = (d * n[:, None, :]).sum(-1, keepdim=True) * n[:, None, :]
    d = torch.where(squeezed[:, None, None], d - (1.0 - SQUEEZE) * across, d)
    xk = xi[:, None, :] + d
    fk = torch.sin(3 * xk[..., 0]) * torch.cos(2 * xk[..., 1]) + 0.3 * xk[..., 0] * xk[..., 1]
    return xk, fk, xi, squeezed


def _oracle_err(fi, xk, fk, xi, sel):
    """Per-case error of fi[sel] against the long-double-refined oracle,
    relative to the case's max |ref| (the calibration's measure); NaN where
    the oracle itself fails (a singular neighbourhood)."""
    from wlsqm_tpu_torch.fitter import calibration

    err = np.full(len(sel), np.nan)
    if len(sel) == 0:
        return err
    a = [t[sel].cpu().numpy() for t in (xk, xi, fk)]
    got = fi[sel].cpu().numpy()
    with np.errstate(all="ignore"):
        for lo in range(0, len(sel), 512):      # a singular case spoils its chunk only
            s = slice(lo, lo + 512)
            try:
                ref = calibration._strong_oracle(a[0][s], a[1][s], a[2][s], 2, 2)
            except np.linalg.LinAlgError:
                continue
            err[s] = np.abs(got[s] - ref).max(-1) / np.abs(ref).max(-1)
    return err


def phase_certified_moments(dev, wtt):
    """The certified route on the configurations the moment kernel newly
    takes: 1D order 4 with ALGO_ITERATIVE (K = 16), 2D order 4 with the value
    known and 2D order 4 with ALGO_ITERATIVE (K = 30), the bench workload at
    B_CERT_NEW each.  The plan's route and launches; the moment kernel's
    share of cases whose key is under its key edge (the calibration
    record's, measured on 2D order 4 basic); on up to B_ORACLE of those the
    worst error against the long-double-refined oracle
    (calibration._reduced_oracle: calibration._strong_oracle, or the
    reduced system's with the known value), relative to the case's max
    |ref|; fails past PARITY."""
    from wlsqm_tpu_torch.fitter import calibration, condprobe
    from wlsqm_tpu_torch.ops import fit_kernel

    edge = condprobe.est_certified_edges()["moments"]
    gen = torch.Generator(device=dev).manual_seed(2033)
    W = wtt.WEIGHT_CENTER
    out = {}
    for name, dim, Kc, kn, it in (("1d_o4_iterative", 1, K_GRID[1], 0, True),
                                  ("2d_o4_known_value", 2, K, 1, False),
                                  ("2d_o4_iterative", 2, K, 0, True)):
        xk, fk, nk, xi = _cloud(B_CERT_NEW, gen, dev, dim=dim, K=Kc)
        NO = wtt.number_of_dofs(dim, ORDER)
        fi0 = torch.zeros((B_CERT_NEW, NO), dtype=torch.float64, device=dev)
        fi0[:, 0] = 0.25
        mi = MAX_ITER if it else 0
        kw = dict(order=ORDER, knowns=kn, weighting=W)
        plan = wtt.plan_fit_many(xk[:B_PLAN], xi[:B_PLAN], iterative=it, **kw)
        _zero_launches()
        res = wtt.fit_many(xk, fk, xi, fi_init=fi0, plan=plan, iterative=it, max_iter=mi,
                           **kw)
        torch.cuda.synchronize()
        launches = _kernel_launches()
        k1 = fit_kernel.fit_kernel(xk, fk, nk, xi, fi0, dimension=dim, order=ORDER,
                                   weighting=W, knowns=kn, max_iter=mi, emit_cond=True)
        fi, key = k1[0], k1[-1]
        cert = (key <= edge).nonzero().squeeze(1)
        on_k1 = (plan.route.path, plan.route.assembly) == ("kernel", "moments")
        if on_k1 and not _same_bits(res.fi, fi):
            raise RuntimeError("%s: the planned route is not the moment kernel's bits" % name)
        sel = cert[torch.randperm(len(cert), generator=torch.Generator().manual_seed(5)
                                  ).to(dev)[:B_ORACLE]].cpu().numpy()
        a = [t[sel].cpu().numpy() for t in (xk, xi, fk, fi0)]
        got = fi[sel].cpu().numpy()
        err = np.full(len(sel), np.nan)
        with np.errstate(all="ignore"):
            for lo in range(0, len(sel), 512):
                s = slice(lo, lo + 512)
                try:
                    ref = calibration._reduced_oracle(a[0][s], a[1][s], a[2][s], a[3][s],
                                                      [0] if kn else [], W, dim, ORDER)
                except np.linalg.LinAlgError:
                    continue
                err[s] = np.abs(got[s] - ref).max(-1) / np.abs(ref).max(-1)
        out[name] = {"route": plan.route.path, "assembly": plan.route.assembly,
                     "launches": launches, "certified_share": len(cert) / B_CERT_NEW,
                     "key_edge": edge, "oracle_cases": int(np.isfinite(err).sum()),
                     "worst_certified_vs_oracle": float(np.nanmax(err)) if len(sel) else None,
                     "key_median": float(key.median())}
        del xk, fk, nk, xi, fi0, res, k1, fi, key
    print(json.dumps({"path": "certified_moments", "B": B_CERT_NEW, "configs": out,
                      "tol": PARITY}), flush=True)
    bad = {n: v for n, v in out.items() if v["worst_certified_vs_oracle"] is not None
           and not v["worst_certified_vs_oracle"] <= PARITY}
    if bad:
        raise RuntimeError("moment kernel past PARITY of the oracle on certified cases: %s"
                           % (bad,))
    return out


def phase_certified(dev, wtt):
    """The certified auto route at full width (B_CERT cases): the plan from
    the first B_PLAN cases, its replay, the eager auto route, the auto
    route with a known DOF (the moment kernel, as the JAX package routes
    it), and the rows body's eager split on that batch (what the auto route
    runs for the groups it sends to the rows kernel), with the launch counts
    read right after; then the checks and the times."""
    from wlsqm_tpu_torch import api
    from wlsqm_tpu_torch.fitter import condprobe
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xk, fk, xi, squeezed = _certified_cloud(B_CERT, dev)
    nk = torch.full((B_CERT,), K, dtype=torch.int32, device=dev)
    kw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER)
    r = slice(0, B_CERT_ROWS)
    kn = wtt.b2_F
    fi_init = torch.zeros((B_CERT_ROWS, 15), dtype=torch.float64, device=dev)
    fi_init[:, 0] = fk[r, 0]          # the known value of F: some neighbour's fk

    # ---- the main path, counts set to 0 just before and read just after ----
    fit_kernel.LAUNCHES = fit_rows.LAUNCHES = 0
    fit_kernel.COND_LAUNCHES = fit_rows.COND_LAUNCHES = 0
    t0 = time.perf_counter()
    plan = wtt.plan_fit_many(xk[:B_PLAN], xi[:B_PLAN], **kw)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    res_plan = wtt.fit_many(xk, fk, xi, plan=plan, **kw)
    res_auto = wtt.fit_many(xk, fk, xi, backend="auto", **kw)
    res_known = wtt.fit_many(xk[r], fk[r], xi[r], backend="auto", knowns=kn,
                             fi_init=fi_init, **kw)
    edge_r = condprobe.split_partition_choice(assembly="rows")[1]
    res_rows = api._eager_split_group(xk[r], fk[r], nk[r], xi[r], fi_init, dim=2,
                                      order=ORDER, knowns=kn, weighting=wtt.WEIGHT_CENTER,
                                      assembly="rows", edge=edge_r)[0]
    torch.cuda.synchronize()
    launches = {"fit_moment": fit_kernel.LAUNCHES, "fit_rows": fit_rows.LAUNCHES,
                "cond_estimate@fit_moment": fit_kernel.COND_LAUNCHES,
                "cond_estimate@fit_rows": fit_rows.COND_LAUNCHES}
    route = plan.route
    shown = ("path", "assembly", "kernel_precision", "refine_steps", "split_edge",
             "tail_frac")
    # the same plan over the calibration sweep's radii: a certified minority
    wide = _certified_cloud(B_PLAN, dev, RADII_WIDE)
    wide_route = wtt.plan_fit_many(wide[0], wide[2], **kw).route
    wide_key = fit_kernel.fit_kernel(wide[0], wide[1], nk[:B_PLAN], wide[2], dimension=2,
                                     emit_cond=True, **kw)[1]
    edge_m = condprobe.split_partition_choice(assembly="moments")[1]
    print(json.dumps({"path": "certified", "B": B_CERT, "plan_from": B_PLAN,
                      "radii": RADII_CERT,
                      "route": {f: getattr(route, f) for f in shown},
                      "plan_s": plan_s, "launches": launches,
                      "radii_wide": RADII_WIDE,
                      "route_wide": {f: getattr(wide_route, f) for f in shown},
                      "certified_share_wide": (wide_key <= edge_m).double().mean().item()}),
          flush=True)
    del wide, wide_key
    if (route.path, route.assembly) != ("kernel-split", "moments"):
        raise RuntimeError("the plan is not a moment-kernel split: %s" % (route,))
    if launches["cond_estimate@fit_moment"] < 4 or launches["cond_estimate@fit_rows"] < 1:
        raise RuntimeError("the certified route did not launch the kernels' keys: %s"
                           % (launches,))
    for name, fi, n in (("plan", res_plan.fi, B_CERT), ("auto", res_auto.fi, B_CERT),
                        ("known", res_known.fi, B_CERT_ROWS), ("rows", res_rows, B_CERT_ROWS)):
        if tuple(fi.shape) != (n, 15):
            raise RuntimeError("certified %s: shape %s" % (name, tuple(fi.shape)))

    # ---- what the route is made of: the kernel alone, the key, the engine ----
    fi_kernel = wtt.fit_many(xk, fk, xi, backend="kernel", **kw).fi
    fi_k1, key = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, emit_cond=True, **kw)
    if not _same_bits(fi_kernel, fi_k1):
        raise RuntimeError("fi differs with and without the key at 2^22")
    del fi_k1
    edge = route.split_edge
    bad = ~(key <= edge)
    n_bad = int(bad.sum())
    k = max(1, min(int(math.ceil(route.tail_frac * B_CERT)), B_CERT))
    over = bad.nonzero().squeeze(1)
    gkw = dict(dim=2, order=ORDER, knowns=0, weighting=wtt.WEIGHT_CENTER)

    # (b) the replay equals its composition: the kernel's result with the
    # first k over-edge cases overwritten by the engine run on those cases
    idx = api._first_over_edge(key, edge, k)
    if not torch.equal(idx[idx < B_CERT], over[:k]):
        raise RuntimeError("the tail window is not the first k over-edge cases")
    idxc = idx.clamp_max(B_CERT - 1)
    tail = api._engine_group(xk[idxc], fk[idxc], nk[idxc], xi[idxc], None, **gkw)
    expect = torch.cat([fi_kernel, fi_kernel.new_empty((1, 15))])
    expect[idx] = tail
    plan_equal = _same_bits(res_plan.fi, expect[:B_CERT])
    del expect, tail
    # (c) the eager route: kernel bits on the certified cases, the engine run
    # on exactly the over-edge cases elsewhere
    tail = api._engine_group(xk[over], fk[over], nk[over], xi[over], None, **gkw)
    auto_equal = (_same_bits(res_auto.fi[~bad], fi_kernel[~bad])
                  and _same_bits(res_auto.fi[over], tail))
    del tail
    # (e) the route with a known DOF (the moment kernel with its knowns and
    # key) and the rows body's split on it: the same two checks with each
    # kernel's key
    fi_e = wtt.fit_many(xk[:B_ENGINE], fk[:B_ENGINE], xi[:B_ENGINE], backend="engine",
                        knowns=kn, fi_init=fi_init[:B_ENGINE], **kw).fi
    fi_m, _, _, key_m = api._run_kernel_group(
        xk[r], fk[r], nk[r], xi[r], fi_init, assembly="moments", refine_steps=None,
        emit_cond=True, **dict(gkw, knowns=kn))
    fi_r, _, _, key_r = fit_rows.fit_rows(xk[r], fk[r], nk[r], xi[r], fi_init, dimension=2,
                                          knowns=kn, emit_cond=True, **kw)
    checks = {}
    for name, res, fi_b, key_b, edge_b in (
            ("known", res_known.fi, fi_m, key_m,
             condprobe.split_partition_choice(assembly="moments")[1]),
            ("rows", res_rows, fi_r, key_r, edge_r)):
        bad_b = ~(key_b <= edge_b)
        over_b = bad_b.nonzero().squeeze(1)
        tail = api._engine_group(xk[r][over_b], fk[r][over_b], nk[r][over_b],
                                 xi[r][over_b], fi_init[over_b], **dict(gkw, knowns=kn))
        checks[name + "_equal"] = (_same_bits(res[~bad_b], fi_b[~bad_b])
                                   and _same_bits(res[over_b], tail))
        checks[name + "_vs_engine"] = _rel(res[:B_ENGINE][~bad_b[:B_ENGINE]],
                                           fi_e[~bad_b[:B_ENGINE]])
        checks[name + "_tail"] = len(over_b)
    rows_equal = checks["known_equal"] and checks["rows_equal"]
    rows_vs_engine = max(checks["known_vs_engine"], checks["rows_vs_engine"])
    del tail, fi_r, fi_m, fi_e

    # the oracle on a seeded sample: every certified case within 1e-10; the
    # tail's own error is reported
    sample = torch.randperm(B_CERT, generator=torch.Generator(device=dev).manual_seed(
        2032), device=dev)[:B_ORACLE]
    window = torch.zeros(B_CERT, dtype=torch.bool, device=dev)
    window[over[:k]] = True
    groups = {"certified": sample[~bad[sample]],
              "tail": sample[bad[sample] & ~squeezed[sample]],
              "tail_collinear": sample[bad[sample] & squeezed[sample]]}
    errors = {}
    for name, fi in (("plan", res_plan.fi), ("auto", res_auto.fi), ("kernel", fi_kernel)):
        for g, sel in groups.items():
            if name == "plan" and g != "certified":
                sel = sel[window[sel]]           # overflow cases stay on the kernel
            e = _oracle_err(fi, xk, fk, xi, sel)
            fin = e[np.isfinite(e)]
            errors["%s_%s" % (name, g)] = {
                "cases": len(sel), "oracle_failed": int(len(e) - len(fin)),
                "max": float(fin.max()) if len(fin) else None,
                "median": float(np.median(fin)) if len(fin) else None}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # ---- times ----
    times = {
        "fit_many_plan": _time_ms(lambda: wtt.fit_many(xk, fk, xi, plan=plan, **kw)),
        "fit_many_auto": _time_ms(lambda: wtt.fit_many(xk, fk, xi, backend="auto", **kw)),
        "fit_many_kernel": _time_ms(lambda: wtt.fit_many(xk, fk, xi, backend="kernel", **kw)),
        "engine_on_tail": _time_ms(lambda: api._engine_group(
            xk[over], fk[over], nk[over], xi[over], None, **gkw)),
        "probe": _time_ms(lambda: condprobe.probe(xk, nk, xi, ORDER, wtt.WEIGHT_CENTER,
                                                  dimension=2)),
    }
    out = torch.empty((B_CERT, 15), dtype=torch.float64, device=dev)
    est = torch.empty((B_CERT,), dtype=torch.float64, device=dev)
    lkw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER,
               refine_steps=fit_kernel.DEFAULT_REFINE_STEPS)
    times["launch"] = _time_ms(lambda: fit_kernel._launch(xk, fk, nk, xi, out, **lkw))
    times["launch_key"] = _time_ms(lambda: fit_kernel._launch(xk, fk, nk, xi, out, est,
                                                              **lkw))
    med = {name: v[0] for name, v in times.items()}
    print(json.dumps({
        "path": "certified", "split_edge": edge, "rows_edge": edge_r,
        "certified_share": 1.0 - n_bad / B_CERT, "tail": n_bad, "tail_window": k,
        "tail_overflow": max(n_bad - k, 0), "collinear": int(squeezed.sum()),
        "known_split": checks,
        "key": {"median": key.nanmedian().item(), "max_finite": key[
            torch.isfinite(key)].max().item(), "non_finite": int((~torch.isfinite(key)).sum())},
        "plan_equals_composition": plan_equal, "auto_equals_composition": auto_equal,
        "known_and_rows_equal_composition": rows_equal,
        "known_and_rows_certified_vs_engine": rows_vs_engine,
        "err_vs_oracle": errors, "oracle_sample": B_ORACLE, "tol": PARITY,
        "ms": {name: v[1] for name, v in times.items()},
        "key_share_of_launch_ms": med["launch_key"] - med["launch"],
        "fits_per_s": {name: B_CERT / med[name] * 1e3 for name in (
            "fit_many_plan", "fit_many_auto", "fit_many_kernel")},
        "peak_mem_gb": round(peak_gb, 3)}), flush=True)
    if not (plan_equal and auto_equal and rows_equal):
        raise RuntimeError("a certified route differs from its composition: plan %s, "
                           "auto %s, known and rows %s" % (plan_equal, auto_equal, checks))
    for name in ("plan_certified", "auto_certified"):
        e = errors[name]
        if e["oracle_failed"] or not e["max"] <= PARITY:
            raise RuntimeError("certified cases against the oracle (%s): %s > %.0e"
                               % (name, e, PARITY))
    if not rows_vs_engine <= PARITY:
        raise RuntimeError("known-DOF routes, certified cases vs engine: %.3e > %.0e"
                           % (rows_vs_engine, PARITY))
    return launches


def measure_rows_cut():
    """The table that set fit_rows.WARP_MIN_NO, run by hand, not by main():
    both bodies of the rows kernel at NO = 10 (2D order 3, 3D order 2), 15
    (2D order 4) and 20 (3D order 3), 2^18 cases, CENTER, launch alone,
    without and with sens.  Two extra libraries are built from the same
    source, their headers generated with the rule moved (all four thread,
    all four warp); the shipped library has one body per instance.

        python3 -c "import chip_smoke; chip_smoke.measure_rows_cut()"
    """
    import ctypes
    from unittest import mock

    from wlsqm_tpu_torch import native
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    dev = torch.device("cuda")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sig = {fit_rows._ENTRY: (i32, [vp] * 10 + [i64, i32, i32, i32, i32, i64, i32, i32, vp])}
    libs = {}
    for body, cut in (("thread", 21), ("warp", 10)):
        with mock.patch.object(fit_rows, "WARP_MIN_NO", cut):
            header = fit_rows.tables_header()
        libs[body] = native.build("fit_rows_cut_" + body, [fit_rows._SRC],
                                  {fit_rows._HEADER: header}, sig).lib
    gen = torch.Generator(device=dev).manual_seed(5)
    table = {}
    for dim, order, Kc in ((2, 3, K), (3, 2, K_DIM3), (2, 4, K), (3, 3, K_DIM3)):
        NO = defs.number_of_dofs(dim, order)
        xk, fk, nk, xi = _cloud(B_PLAIN, gen, dev, dim=dim, K=Kc, order=order)
        _, _, _, inv_s = fit_kernel._prescale(xk, nk, xi)
        out = torch.empty((B_PLAIN, NO), dtype=torch.float64, device=dev)
        sens = torch.empty((B_PLAIN, Kc, NO), dtype=torch.float64, device=dev)
        row = {}
        for body, lib in libs.items():
            for with_sens in (False, True):
                def launch(lib=lib, with_sens=with_sens):
                    status = lib.wlsqm_fit_rows(
                        xk.data_ptr(), fk.data_ptr(), nk.data_ptr(), xi.data_ptr(),
                        inv_s.data_ptr(), None, out.data_ptr(), None,
                        sens.data_ptr() if with_sens else None, None, B_PLAIN, Kc, dim,
                        order, defs.WEIGHT_CENTER, 0, fit_rows.DEFAULT_REFINE_STEPS, 0,
                        torch.cuda.current_stream().cuda_stream)
                    if status != 0:
                        raise RuntimeError("rows kernel launch failed: CUDA error %d" % status)
                row["%s%s_ms" % (body, "_sens" if with_sens else "")] = _time_ms(launch)[0]
        table["d%d_order%d_NO%d_K%d" % (dim, order, NO, Kc)] = row
        del xk, fk, nk, xi, inv_s, out, sens
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"rows_cut_2^18_launch_ms": table, "card": smi.splitlines()[0],
                      "warp_min_no": fit_rows.WARP_MIN_NO}), flush=True)
    return table


_GATHER_VARIANTS = r"""
#include "%s"
namespace {
// the row-group design: one thread per R = 2 output rows, 8-byte loads, the
// group's 16-byte vectors stored by the same thread (48 B at F = 3)
template <int W, bool EVICT_LAST>
__global__ void __launch_bounds__(kThreads)
gather_group(const uint32_t* __restrict__ u, const int32_t* __restrict__ idx,
             uint32_t* __restrict__ out, int64_t n, int64_t rows) {
  const int64_t r0 = 2 * ((int64_t)blockIdx.x * kThreads + threadIdx.x);
  if (r0 + 2 > rows) return;  // even row counts only
  const int2 ix = __ldg(reinterpret_cast<const int2*>(idx + r0));
  uint64_t pol = 0;
  if (EVICT_LAST) asm volatile("createpolicy.fractional.L2::evict_last.b64 %%0, 1.0;" : "=l"(pol));
  uint32_t w[2 * W];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t* p = u + clamp_row(j ? ix.y : ix.x, n) * W;
#pragma unroll
    for (int c = 0; c < W / 2; ++c) {
      if (EVICT_LAST) {
        asm volatile("ld.global.nc.L2::cache_hint.v2.u32 {%%0, %%1}, [%%2], %%3;"
                     : "=r"(w[j * W + 2 * c]), "=r"(w[j * W + 2 * c + 1]) : "l"(p + 2 * c), "l"(pol));
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + c);
        w[j * W + 2 * c] = v.x, w[j * W + 2 * c + 1] = v.y;
      }
    }
  }
  uint4* o = reinterpret_cast<uint4*>(out + r0 * W);
#pragma unroll
  for (int v = 0; v < W / 2; ++v)
    __stcs(o + v, make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]));
}
// the shipped 16-byte-vector kernel (8-byte pieces) with evict_last on the u loads
template <int W>
__global__ void __launch_bounds__(kThreads)
vec16_evict_last(const uint32_t* __restrict__ u, const int32_t* __restrict__ idx,
                 uint32_t* __restrict__ out, int64_t n, int64_t rows) {
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (4 * v + 4 > rows * W) return;  // whole vectors only
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %%0, 1.0;" : "=l"(pol));
  uint32_t x[4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int64_t p = 2 * v + q, r = p / (W / 2);
    const uint32_t* src = u + clamp_row(__ldg(idx + r), n) * W + (p - r * (W / 2)) * 2;
    asm volatile("ld.global.nc.L2::cache_hint.v2.u32 {%%0, %%1}, [%%2], %%3;"
                 : "=r"(x[2 * q]), "=r"(x[2 * q + 1]) : "l"(src), "l"(pol));
  }
  __stcs(reinterpret_cast<uint4*>(out) + v, make_uint4(x[0], x[1], x[2], x[3]));
}
// one thread per row of W = 4 NV words (W a run time argument, NV <= MAXV):
// all of its 16-byte loads in flight, then its 16-byte streaming stores
template <int MAXV>
__global__ void __launch_bounds__(kThreads)
gather_row_thread(const uint32_t* __restrict__ u, const int32_t* __restrict__ idx,
                  uint32_t* __restrict__ out, int64_t n, int64_t rows, int W) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int nv = W / 4;
  const uint4* src = reinterpret_cast<const uint4*>(u + clamp_row(__ldg(idx + r), n) * W);
  uint4* dst = reinterpret_cast<uint4*>(out + r * W);
  uint4 x[MAXV];
#pragma unroll
  for (int q = 0; q < MAXV; ++q)
    if (q < nv) x[q] = __ldg(src + q);
#pragma unroll
  for (int q = 0; q < MAXV; ++q)
    if (q < nv) __stcs(dst + q, x[q]);
}
Call one_plane(const void* u, const void* idx, void* out, int64_t n, int64_t rows, int words,
               void* st) {
  return Call{(const uint32_t*)u, nullptr, (const int32_t*)idx, (uint32_t*)out, nullptr, n,
              rows, words, (cudaStream_t)st};
}
int widest(int words) { return (4 * words) %% 16 == 0 ? 16 : (4 * words) %% 8 == 0 ? 8 : 4; }
template <int W, bool E>
int run(const void* u, const void* idx, void* out, int64_t n, int64_t rows, void* st) {
  const unsigned grid = (unsigned)((rows / 2 + kThreads - 1) / kThreads);
  gather_group<W, E><<<grid, kThreads, 0, (cudaStream_t)st>>>(
      (const uint32_t*)u, (const int32_t*)idx, (uint32_t*)out, n, rows);
  return (int)cudaGetLastError();
}
template <int W>
int run_vec(const void* u, const void* idx, void* out, int64_t n, int64_t rows, void* st) {
  const unsigned grid = (unsigned)((rows * W / 4 + kThreads - 1) / kThreads);
  vec16_evict_last<W><<<grid, kThreads, 0, (cudaStream_t)st>>>(
      (const uint32_t*)u, (const int32_t*)idx, (uint32_t*)out, n, rows);
  return (int)cudaGetLastError();
}
}  // namespace
// variant 0: row groups; 1: row groups with evict_last on the u loads;
// 2: 16-byte vectors with evict_last on the u loads; 3: the run-time-width
// vectors (gather_vecs) at any width, with the widest pieces the row allows;
// 4: the compile-time-width vectors (gather_vec16) at 8, 10 and 16 words;
// 5: one thread a row (rows of 4-32 words, a multiple of 4)
extern "C" int gather_variant(int variant, const void* u, const void* idx, void* out,
                              int64_t n, int64_t rows, int words, void* st) {
  const Call c = one_plane(u, idx, out, n, rows, words, st);
  if (variant == 3) {
    switch (widest(words)) {
      case 16: launch_vecs<16>(c); break;
      case 8: launch_vecs<8>(c); break;
      default: launch_vecs<4>(c);
    }
    return (int)cudaGetLastError();
  }
  if (variant == 4) {
    if (words == 8) launch_vec<8, 16>(c);
    else if (words == 10) launch_vec<10, 8>(c);
    else if (words == 16) launch_vec<16, 16>(c);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  if (variant == 5) {
    if (words %% 4 || words > 32) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((rows + kThreads - 1) / kThreads);
    gather_row_thread<8><<<grid, kThreads, 0, (cudaStream_t)st>>>(
        (const uint32_t*)u, (const int32_t*)idx, (uint32_t*)out, n, rows, words);
    return (int)cudaGetLastError();
  }
  if (variant == 2) return words == 2 ? run_vec<2>(u, idx, out, n, rows, st)
                                      : run_vec<6>(u, idx, out, n, rows, st);
  if (words == 2) return variant ? run<2, true>(u, idx, out, n, rows, st)
                                 : run<2, false>(u, idx, out, n, rows, st);
  if (words == 6) return variant ? run<6, true>(u, idx, out, n, rows, st)
                                 : run<6, false>(u, idx, out, n, rows, st);
  return (int)cudaErrorInvalidValue;
}
"""


def measure_gather_variants():
    """The designs the gather kernel was chosen from, run by hand, not by
    main(), built here from gather.cu plus the variants, each checked bit for
    bit against u[idx], in turns (forward, then backward), beside
    torch.index_select:

    * at the IBVP shapes (n = 2^22, K = 28, f64, F = 1 and 3): the word
      instance (PR 3's design), the shipped 16-byte vectors (a template per
      width), the row-group design (a thread per two rows, 16-byte stores)
      and the vectors, each without and with an L2 evict_last hint on the u
      loads, and the run-time-width vectors;
    * at the Euler step's shapes (its 2^22-point cloud, K = 24, f64, F = 8,
      4 and 5: rows of 64, 32 and 40 bytes): the word instance, the shipped
      instance (the run-time-width vectors, which _vector_plan picks), the
      same vectors with the width a template, and one thread a row with all
      of its 16-byte loads in flight (widths a multiple of 4 words).

        python3 -c "import chip_smoke; chip_smoke.measure_gather_variants()"
    """
    import ctypes

    from wlsqm_tpu_torch import native
    from wlsqm_tpu_torch.examples import euler_flow as ef
    from wlsqm_tpu_torch.ops import gather

    dev = torch.device("cuda")
    src_dir = os.path.join(native.BUILD_ROOT, "gather_variants_src")
    os.makedirs(src_dir, exist_ok=True)
    src = os.path.join(src_dir, "gather_variants.cu")
    with open(src, "w") as f:
        f.write(_GATHER_VARIANTS % os.path.join(native.CSRC, "gather.cu"))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib = native.build("gather_variants", [src], {}, {
        "gather_variant": (i32, [i32, vp, vp, vp, i64, i64, i32, vp]),
        gather._ENTRY: (i32, [vp, vp, vp, vp, vp, i64, i64, i32, i32, vp])}).lib

    def measure(idx_np, n, F, names):
        flat = torch.as_tensor(np.ascontiguousarray(idx_np, dtype=np.int32),
                               device=dev).reshape(-1)
        flat_long, rows = flat.long(), flat.numel()
        u = torch.randn((n, F), dtype=torch.float64, device=dev)
        words, W = u.view(torch.int32), 2 * F
        dst = torch.empty((rows, W), dtype=torch.int32, device=dev)

        def entry(load_bytes):
            def go():
                status = getattr(lib, gather._ENTRY)(
                    words.data_ptr(), None, flat.data_ptr(), dst.data_ptr(), None, n,
                    rows, W, load_bytes, torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError("gather launch failed: CUDA error %d" % status)
            return go

        def variant(v):
            def go():
                status = lib.gather_variant(v, words.data_ptr(), flat.data_ptr(), dst.data_ptr(),
                                            n, rows, W, torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError("gather variant failed: CUDA error %d" % status)
            return go

        shipped = gather._vector_plan(4 * W, words.data_ptr(), dst.data_ptr()) or 0
        every = {"words": entry(0), "shipped": entry(shipped), "vec16_evict_last": variant(2),
                 "row_groups": variant(0), "row_groups_evict_last": variant(1),
                 "runtime_width": variant(3), "template_width": variant(4),
                 "row_thread": variant(5)}
        runs = [(name, every[name]) for name in names]
        times = {name: [] for name in names}
        times["index_select"] = []
        ref = u[flat_long].view(torch.int32).reshape(rows, W)
        for name, fn in runs + runs[::-1]:
            dst.zero_()
            times[name].append(_time_ms(fn)[0])
            torch.cuda.synchronize()
            if not torch.equal(dst, ref):
                raise RuntimeError("gather variant %s differs from u[idx] at F = %d" % (name, F))
        for _ in range(2):
            times["index_select"].append(_time_ms(lambda: torch.index_select(u, 0, flat_long))[0])
        res = {**times, "shipped_load_bytes": shipped,
               "bound_ms": _bound((flat, dst, u), 0.0)["bound_ms"]}
        print(json.dumps({"F%d_K%d" % (F, idx_np.shape[1]): res}), flush=True)
        return res

    out = {}
    _, idx_np, _, _ = ibvp_setup()
    for F in (1, 3):
        out["ibvp_F%d" % F] = measure(idx_np, N_IBVP, F, (
            "words", "shipped", "vec16_evict_last", "row_groups", "row_groups_evict_last",
            "runtime_width"))
    del idx_np
    pts = ef.cloud(N_EULER_SIDE)
    _, own, _ = ef.periodic_neighbours(pts, ef.K)
    for F in (8, 4, 5):
        names = ("words", "shipped", "template_width") + (("row_thread",) if F % 2 == 0 else ())
        out["euler_F%d" % F] = measure(own, len(pts), F, names)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"gather_variants_ms_median_of_5_twice": out, "card": smi.splitlines()[0],
                      "ibvp": {"n": N_IBVP, "K": K_IBVP},
                      "euler": {"n": len(pts), "K": ef.K}}), flush=True)
    return out


def _moment_variants_lib(emit_cond):
    """The moment kernel's source with its design variants compiled in
    (``csrc/fit_moment_variants.cuh``, -DWLSQM_MOMENT_VARIANTS=1)."""
    import ctypes
    import os

    from wlsqm_tpu_torch import native
    from wlsqm_tpu_torch.ops import fit_kernel

    vp, i32 = ctypes.c_void_p, ctypes.c_int
    with open(os.path.join(native.CSRC, "fit_moment_variants.cuh")) as f:
        variants = f.read()
    return native.build(
        "fit_moment_variants%s" % ("_cond" if emit_cond else ""), [fit_kernel._SRC],
        {fit_kernel._HEADER: fit_kernel.tables_header(), "fit_moment_variants.cuh": variants},
        {"wlsqm_fit_moment_variant": (i32, [i32] + [vp] * 7 + [ctypes.c_int64, i32, i32, vp]),
         "wlsqm_moment_phase_cycles": (i32, [vp])},
        defines=("WLSQM_EMIT_COND=%d" % emit_cond, "WLSQM_MOMENT_DIM=2",
                 "WLSQM_MOMENT_VARIANTS=1"), includes=fit_kernel._INCLUDES)


def _phase_cycles(lib, names=()):
    """Per-phase clock64 sums since the last read (thread 0 of each block),
    as shares of their total."""
    import ctypes

    buf = (ctypes.c_ulonglong * 8)()
    torch.cuda.synchronize()
    status = lib.wlsqm_moment_phase_cycles(buf)
    if status != 0:
        raise RuntimeError("phase cycles: CUDA error %d" % status)
    total = float(sum(buf)) or 1.0
    return {name: round(buf[i] / total, 4) for i, name in enumerate(names)}


MOMENT_VARIANTS = {0: "thread_registers", 1: "thread_registers_own_scale",
                   2: "thread_smem_factor", 3: "group4_direct", 4: "group4_one_buffer",
                   5: "group4_two_buffers", 6: "group2_direct", 7: "group2_one_buffer",
                   8: "group2_two_buffers", 9: "shipped", 10: "own_scale_ladders",
                   11: "own_scale_ladders_reciprocal"}
MOMENT_PHASES = ("scale_max_d2", "assembly", "butterfly_stores", "cholesky", "solve_sweep",
                 "store", "key")


def measure_moment_variants():
    """The designs the moment kernel was chosen from, run by hand, not by
    main(): at the headline configuration (2D order 4, K = 30, CENTER) on
    2^18 and 2^23 cases, without and with the key, launch alone, in turns
    (forward then backward, median of 5 each), each checked against the
    plain version (2^18) or the shipped kernel (2^23).  Variant 0 is the
    register body that preceded the shipped one (inv_s from _prescale, de-scaled after it: its route adds those
    passes, timed beside it); 1 the same body scaling itself; 2 one thread
    per case with the factor in shared memory ([entry][case]); 3-5 four
    lanes per case with no staging, one buffer, two buffers; 6-8 two lanes
    per case; 9 the shipped body; 10 and 11 body 1 with the shipped body's
    moment sums, then also its reciprocal pivots (measure_moment_units).

        python3 -c "import chip_smoke; chip_smoke.measure_moment_variants()"
    """
    from wlsqm_tpu_torch.ops import fit_kernel

    dev = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(_moment_variants_lib, (False, True)))
    for lib in libs:
        print(json.dumps({"library": os.path.basename(lib.path), "nvcc_s": lib.build_seconds,
                          "ptxas": _ptxas_summary(lib.log)}), flush=True)
    W, RS = 2, fit_kernel.DEFAULT_REFINE_STEPS
    table = {}
    for B in (B_PLAIN, B_MAIN):
        xk, fk, nk, xi = _cloud(B, torch.Generator(device=dev).manual_seed(42), dev)
        _, _, e_s, inv_s = fit_kernel._prescale(xk, nk, xi)
        dscale = fit_kernel._dof_scale(e_s, 2, ORDER)
        amp = fit_kernel.cond_amp_factor(inv_s, ORDER)
        ref = (fit_kernel.fit_moments_plain(xk, fk, nk, xi, dimension=2, order=ORDER,
                                            weighting=W, emit_cond=True)
               if B <= B_PLAIN else
               fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=ORDER, weighting=W,
                                     emit_cond=True))
        out = torch.empty((B, 15), dtype=torch.float64, device=dev)
        est = torch.empty((B,), dtype=torch.float64, device=dev)
        row, phases = {}, {}
        for cond, lib in zip((False, True), libs):
            for v in list(MOMENT_VARIANTS) + list(MOMENT_VARIANTS)[::-1]:
                def go(v=v, lib=lib.lib, cond=cond):
                    status = lib.wlsqm_fit_moment_variant(
                        v, xk.data_ptr(), fk.data_ptr(), nk.data_ptr(), xi.data_ptr(),
                        inv_s.data_ptr(), out.data_ptr(), est.data_ptr() if cond else None,
                        B, K, RS, torch.cuda.current_stream().cuda_stream)
                    if status != 0:
                        raise RuntimeError("moment variant %d failed: CUDA error %d" % (v, status))
                name = MOMENT_VARIANTS[v] + ("_key" if cond else "")
                _phase_cycles(lib.lib)
                row.setdefault(name, []).append(_time_ms(go)[0])
                if 3 <= v <= 8:
                    phases.setdefault(name, _phase_cycles(lib.lib, MOMENT_PHASES))
                go()
                torch.cuda.synchronize()
                fi = out * dscale if v == 0 else out
                err = _rel(fi, ref[0])
                kerr = 0.0
                if cond:
                    key = est * amp if v == 0 else est
                    fin = torch.isfinite(ref[1])
                    kerr = ((key[fin] - ref[1][fin]).abs() / ref[1][fin]).max().item()
                if not (err <= PARITY and kerr <= KEY_TOL):
                    raise RuntimeError("moment variant %s: fi %.3e, key %.3e" % (name, err, kerr))
        row["register_body_route_passes"] = [_time_ms(lambda: (fit_kernel._prescale(xk, nk, xi),
                                                     out * fit_kernel._dof_scale(
                                                         e_s, 2, ORDER)))[0]]
        row["shipped_fit_kernel"] = [_time_ms(lambda: fit_kernel.fit_kernel(
            xk, fk, nk, xi, dimension=2, order=ORDER, weighting=W))[0]]
        table["B=%d" % B] = row
        table["phase_shares_B=%d" % B] = phases
        del xk, fk, nk, xi, e_s, inv_s, dscale, amp, ref, out, est
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"moment_variants_launch_ms_median_of_5_twice": table,
                      "card": smi.splitlines()[0], "K": K}), flush=True)
    return table


#: one arithmetic change at a time, from the register body scaling itself
#: to the shipped body (csrc/fit_moment_variants.cuh)
MOMENT_UNIT_VARIANTS = (1, 10, 11, 9)
UNIT_SEEDS = (20260817, 1, 2)   # the shipped sweep's seed, and two more


def measure_moment_units():
    """Which change of the moment body's arithmetic moved its calibration
    units, run by hand, not by main(): the calibration sweep
    (``calibration.calibrate_device``, not persisted, on UNIT_SEEDS) with
    the moment kernel replaced by variants 1 -> 10 -> 11 -> 9 in turn (the
    moment sums as power ladders, then reciprocal pivots in the solves,
    then the back solve's summation order), and each variant's fi against
    the one before on 8,192 cases of the sweep's family (share of cases
    whose bits differ, largest relative difference).

        python3 -c "import chip_smoke; chip_smoke.measure_moment_units()"
    """
    from wlsqm_tpu_torch.fitter import calibration, condprobe, defs
    from wlsqm_tpu_torch.ops import fit_kernel

    lib = _moment_variants_lib(True)
    print(json.dumps({"library": os.path.basename(lib.path), "nvcc_s": lib.build_seconds}),
          flush=True)
    real = fit_kernel.fit_kernel

    def variant_fit(v):
        def fit(xk, fk, nk, xi, *, dimension, order, weighting, emit_cond=False,
                refine_steps=fit_kernel.DEFAULT_REFINE_STEPS):
            if (dimension, order, emit_cond) != (2, ORDER, True):
                raise ValueError("the variants cover 2D order 4 with the key")
            B, Kn, _ = xk.shape
            xk, fk, xi = xk.contiguous(), fk.contiguous(), xi.contiguous()
            nk = nk.to(torch.int32).contiguous()
            out = torch.empty((B, 15), dtype=torch.float64, device=xk.device)
            est = torch.empty((B,), dtype=torch.float64, device=xk.device)
            status = lib.lib.wlsqm_fit_moment_variant(
                v + (100 if weighting == defs.WEIGHT_UNIFORM else 0), xk.data_ptr(),
                fk.data_ptr(), nk.data_ptr(), xi.data_ptr(), None, out.data_ptr(),
                est.data_ptr(), B, Kn, refine_steps, torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError("moment variant %d failed: CUDA error %d" % (v, status))
            return out, est
        return fit

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    xk, fk, xi = (torch.as_tensor(a, device=dev) for a in calibration._problem(
        rng, 8192, K, 0.1, 2))
    nk = torch.full((8192,), K, dtype=torch.int32, device=dev)
    table, prev = {}, None
    try:
        for v in MOMENT_UNIT_VARIANTS:
            fit_kernel.fit_kernel = variant_fit(v)
            row = {}
            for seed in UNIT_SEEDS:
                cal = calibration.calibrate_device(persist=False, seed=seed)
                row[str(seed)] = {
                    "f64_unit_m": cal.f64_unit_m, "f64_cert_unit_m": cal.f64_cert_unit_m,
                    "est_f64_cert_unit_m": cal.est_f64_cert_unit_m,
                    "edge_cond_amp": condprobe.AUTO_TOL / (condprobe.SAFETY
                                                           * cal.f64_cert_unit_m)}
            fi, _ = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=ORDER,
                                          weighting=defs.WEIGHT_CENTER, emit_cond=True)
            if prev is not None:
                row["vs_previous"] = {
                    "cases_bits_differ": (fi.view(torch.int64) != prev.view(torch.int64))
                    .any(1).double().mean().item(),
                    "max_rel": _rel(fi, prev)}
            prev = fi
            table[MOMENT_VARIANTS[v]] = row
            print(json.dumps({MOMENT_VARIANTS[v]: row}), flush=True)
    finally:
        fit_kernel.fit_kernel = real
        calibration._reset_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"moment_units_by_variant": table, "card": smi.splitlines()[0]}),
          flush=True)
    return table



#: the phase clock's counters (csrc/fit_moment.cu, -DWLSQM_PHASE_CLOCK=1)
MOMENT_CLOCK_PHASES = ("staging", "scale_normaliser", "assembly", "matrix_build", "cholesky",
                       "key", "first_solve", "refine_sweeps", "trip1_residual",
                       "trip2_residual", "trip3_residual", "trip1_sweep", "trip2_sweep",
                       "trip3_sweep", "store", "total")


def _moment_phase_lib(dim, emit_cond):
    """The moment kernel built with its phase clock (-DWLSQM_PHASE_CLOCK=1):
    a measurement library that no route loads."""
    import ctypes

    from wlsqm_tpu_torch import native
    from wlsqm_tpu_torch.ops import fit_kernel

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return native.build(
        "fit_moment_d%d%s_phase" % (dim, "_cond" if emit_cond else ""), [fit_kernel._SRC],
        {fit_kernel._HEADER: fit_kernel.tables_header()},
        {fit_kernel._ENTRY: (i32, [vp] * 8 + [i64, i32, i32, i32, i32, i64, i64, i32, i32, i32,
                                               vp]),
         "wlsqm_moment_phase_buffer": (i32, [vp])},
        defines=("WLSQM_EMIT_COND=%d" % emit_cond, "WLSQM_MOMENT_DIM=%d" % dim,
                 "WLSQM_PHASE_CLOCK=1"), includes=fit_kernel._INCLUDES)


def _moment_phase_split(lib, data, *, dim, max_iter, emit_cond, order=ORDER, weighting=2):
    """One configuration through the phase-clock library: its launch time
    (median of REPS) beside the shipped library's, and per phase the mean
    clock64 cycles a case spent there and its share of the whole fit; the
    trip phases also per case that ran them."""
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel

    xk, fk, nk, xi = data
    B, Kn, _ = xk.shape
    NO = defs.number_of_dofs(dim, order)
    dev = xk.device
    out = torch.empty((B, NO), dtype=torch.float64, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev) if max_iter else None
    est = torch.empty((B,), dtype=torch.float64, device=dev) if emit_cond else None
    clocks = torch.zeros((B, len(MOMENT_CLOCK_PHASES)), dtype=torch.int64, device=dev)
    if lib.lib.wlsqm_moment_phase_buffer(clocks.data_ptr()) != 0:
        raise RuntimeError("phase clock: the buffer was not set")
    W, RS = weighting, fit_kernel.DEFAULT_REFINE_STEPS

    def ptr(t):
        return None if t is None else t.data_ptr()

    def go():   # ext 0: the call's own instance, as fit_kernel._launch picks it
        status = lib.lib.wlsqm_fit_moment(
            xk.data_ptr(), fk.data_ptr(), nk.data_ptr(), xi.data_ptr(), None, out.data_ptr(),
            ptr(iters), ptr(est), B, Kn, dim, order, W, 0, 0, RS, max_iter, 0,
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError("phase-clock launch failed: CUDA error %d" % status)

    clock_ms = _time_ms(go)
    shipped_ms = _time_ms(lambda: fit_kernel._launch(
        xk, fk, nk, xi, torch.empty_like(out), None if est is None else torch.empty_like(est),
        iters=None if iters is None else torch.empty_like(iters), order=order, weighting=W,
        refine_steps=RS, max_iter=max_iter))
    clocks.zero_()
    go()
    torch.cuda.synchronize()
    ref = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=dim, order=order, weighting=W,
                                max_iter=max_iter, emit_cond=emit_cond)
    fi_ref = ref if not (max_iter or emit_cond) else ref[0]
    c = clocks.double()
    mean = c.mean(0)
    total = mean[-1].item()
    ran = (c > 0).double().sum(0).clamp_min(1.0)
    return {"B": B, "K": Kn, "fi_bits_equal_shipped": _same_bits(out, fi_ref),
            "launch_ms_clock_build": clock_ms[0],
            "launch_ms_shipped": shipped_ms[0],
            "cycles_per_case": {n: round(mean[i].item(), 1)
                                for i, n in enumerate(MOMENT_CLOCK_PHASES)},
            "share": {n: round(mean[i].item() / total, 4)
                      for i, n in enumerate(MOMENT_CLOCK_PHASES[:-1])},
            "cycles_per_case_that_ran_it": {n: round((c[:, i].sum() / ran[i]).item(), 1)
                                            for i, n in enumerate(MOMENT_CLOCK_PHASES)
                                            if "trip" in n},
            "counts": (None if iters is None else
                       torch.bincount(iters.long(), minlength=max_iter + 1).tolist())}


def measure_moment_phases(paths=None):
    """Where a moment-kernel case spends its time, run by hand, not by main():
    the kernel built with its phase clock (-DWLSQM_PHASE_CLOCK=1, each case's
    clock64() cycles per phase: staging, scale, assembly, matrix build,
    Cholesky, key, first solve, sweeps, each ALGO_ITERATIVE trip's residual
    pass and sweep, store) on the smoke's paths: headline (2D basic, 2^23),
    iterative (max_iter = 3, 2^23, without and with the key), dim3 (3D
    order 4, K = 48, the warp body, 2^21, without and with the key), dim1
    (phase_dim1's cloud, 1D order 4, K = 15, UNIFORM, 2^23: basic, with the
    key, and max_iter = 3) and dim3_thread (3D order 2, K = 48, CENTER, the
    thread body, 2^21, without and with the key); ``paths``, a tuple of
    those names (their ``_key`` twins run with them), or all.  Its fi is
    held to the shipped library's bits; its launch is timed beside the
    shipped one's (what the clock reads costs).

        python3 -c "import chip_smoke; chip_smoke.measure_moment_phases()"
    """
    dev = torch.device("cuda")
    runs = (("headline", 2, False, 0, B_MAIN, 42, K, ORDER, 2),
            ("iterative", 2, False, MAX_ITER, B_MAIN, 45, K, ORDER, 2),
            ("iterative_key", 2, True, MAX_ITER, B_MAIN, 45, K, ORDER, 2),
            ("dim3", 3, False, 0, B_ROWS, 44, K_DIM3, ORDER, 2),
            ("dim3_key", 3, True, 0, B_ROWS, 44, K_DIM3, ORDER, 2),
            ("dim1", 1, False, 0, B_MAIN, 46, K_DIM1, ORDER, 1),
            ("dim1_key", 1, True, 0, B_MAIN, 46, K_DIM1, ORDER, 1),
            ("dim1_iterative", 1, False, MAX_ITER, B_MAIN, 46, K_DIM1, ORDER, 1),
            ("dim3_thread", 3, False, 0, B_ROWS, 47, K_DIM3, ORDER_DIM3_THREAD, 2),
            ("dim3_thread_key", 3, True, 0, B_ROWS, 47, K_DIM3, ORDER_DIM3_THREAD, 2))
    if paths is not None:
        runs = tuple(r for r in runs if r[0] in paths or r[0].removesuffix("_key") in paths)
    combos = sorted({(r[1], r[2]) for r in runs})
    with concurrent.futures.ThreadPoolExecutor(len(combos)) as pool:
        libs = dict(zip(combos, pool.map(lambda a: _moment_phase_lib(*a), combos)))
    for (dim, cond), lib in libs.items():
        print(json.dumps({"library": os.path.basename(os.path.dirname(lib.path)),
                          "nvcc_s": lib.build_seconds, "ptxas": _ptxas_summary(lib.log)}),
              flush=True)
    table = {}
    for name, dim, cond, mi, B, seed, k, order, w in runs:
        gen = torch.Generator(device=dev).manual_seed(seed)
        data = (_dim1_cloud(B, gen, dev, K=k) if dim == 1 else
                _cloud(B, gen, dev, dim=dim, K=k, order=order))
        table[name] = _moment_phase_split(libs[(dim, cond)], data, dim=dim, max_iter=mi,
                                          emit_cond=cond, order=order, weighting=w)
        print(json.dumps({name: table[name]}), flush=True)
        del data
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"moment_phases": table, "card": smi.splitlines()[0]}), flush=True)
    return table

#: the rows kernel's phase clock counters (csrc/fit_rows.cu, -DWLSQM_PHASE_CLOCK=1)
ROWS_CLOCK_PHASES = ("staging_center", "assembly", "jacobi_cholesky", "key", "solve_refine",
                     "iterative", "sens", "stores", "total")


def _rows_phase_lib():
    """The rows kernel built with its phase clock (-DWLSQM_PHASE_CLOCK=1):
    a measurement library that no route loads."""
    import ctypes

    from wlsqm_tpu_torch import native
    from wlsqm_tpu_torch.ops import fit_rows

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return native.build(
        "fit_rows_phase", [fit_rows._SRC], {fit_rows._HEADER: fit_rows.tables_header()},
        {fit_rows._ENTRY: (i32, [vp] * 10 + [i64, i32, i32, i32, i32, i64, i32, i32, vp]),
         "wlsqm_rows_phase_buffer": (i32, [vp])},
        defines=("WLSQM_EMIT_COND=0", "WLSQM_PHASE_CLOCK=1"), includes=fit_rows._INCLUDES)


def _rows_phase_split(lib, data, *, dim, order, do_sens):
    """One CENTER configuration through the rows kernel's phase-clock
    library: its launch (median of REPS) beside the shipped library's, fi
    and sens held to the shipped bits, and per phase the mean clock64
    cycles a case spent there and its share of the whole fit."""
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    xk, fk, nk, xi = data
    B, Kn, _ = xk.shape
    NO = defs.number_of_dofs(dim, order)
    dev = xk.device
    W, RS = defs.WEIGHT_CENTER, fit_rows.DEFAULT_REFINE_STEPS
    _, _, _, inv_s = fit_kernel._prescale(xk, nk, xi)
    out, ref = (torch.empty((B, NO), dtype=torch.float64, device=dev) for _ in range(2))
    sens, sref = ((torch.empty((B, Kn, NO), dtype=torch.float64, device=dev) if do_sens
                   else None) for _ in range(2))
    clocks = torch.zeros((B, len(ROWS_CLOCK_PHASES)), dtype=torch.int64, device=dev)
    if lib.lib.wlsqm_rows_phase_buffer(clocks.data_ptr()) != 0:
        raise RuntimeError("phase clock: the buffer was not set")

    def go():
        status = lib.lib.wlsqm_fit_rows(
            xk.data_ptr(), fk.data_ptr(), nk.data_ptr(), xi.data_ptr(), inv_s.data_ptr(), None,
            out.data_ptr(), None, None if sens is None else sens.data_ptr(), None, B, Kn, dim,
            order, W, 0, RS, 0, torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError("phase-clock launch failed: CUDA error %d" % status)

    def shipped():
        fit_rows._launch(xk, fk, nk, xi, inv_s, None, ref, None, sref, order=order, weighting=W,
                         knowns=0, refine_steps=RS, max_iter=0)

    clock_ms, shipped_ms = _time_ms(go), _time_ms(shipped)
    clocks.zero_()
    go()
    torch.cuda.synchronize()
    c = clocks.double()
    mean = c.mean(0)
    total = mean[-1].item()
    return {"B": B, "K": Kn, "dim": dim, "order": order, "NO": NO, "do_sens": do_sens,
            "body": "warp" if fit_rows.warp_body(dim, order) else "thread",
            "bits_equal_shipped": _same_bits(out, ref) and (
                sens is None or _same_bits(sens, sref)),
            "launch_ms_clock_build": clock_ms[0], "launch_ms_shipped": shipped_ms[0],
            "cycles_per_case": {n: round(mean[i].item(), 1)
                                for i, n in enumerate(ROWS_CLOCK_PHASES)},
            "share": {n: round(mean[i].item() / total, 4)
                      for i, n in enumerate(ROWS_CLOCK_PHASES[:-1])}}


def _adjoint_cloud(dev):
    """The adjoint example's neighbourhoods grown to ADJ_SIDE^2 = 2^20
    cases (K = 12, the native host tree) and its data u_obs[idx]: the rows
    launch of its loss-and-gradient step."""
    from wlsqm_tpu_torch.examples import adjoint_data_recovery as ad

    p = ad.problem(ADJ_SIDE, device=dev, dense=False)
    return p, (p.xk, p.u_obs[p.idx], p.nk, p.xi)


def _adjoint_rows_times(data):
    """The adjoint step's rows launch (2D, order 2, K = 12, CENTER, do_sens,
    the default refine_steps: the thread body) alone, median of REPS: its
    bound (_bound, _rows_flops), the fit_rows wrapper and the
    fit_rows_diffable forward around it (their time beyond the launch: the
    wrapper's _prescale, _dof_scale and de-scale), the plain version and the
    K2 row's library yardstick (torch.linalg.lstsq on the sqrt(w)-weighted
    basis with [sqrt(w) fk, diag(sqrt(w))], basis build excluded)."""
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    xk, fk, nk, xi = data
    B, Kn, dim = xk.shape
    order, W, RS = 2, defs.WEIGHT_CENTER, fit_rows.DEFAULT_REFINE_STEPS
    NO = defs.number_of_dofs(dim, order)
    dev = xk.device
    _, _, _, inv_s = fit_kernel._prescale(xk, nk, xi)
    out = torch.empty((B, NO), dtype=torch.float64, device=dev)
    sens = torch.empty((B, Kn, NO), dtype=torch.float64, device=dev)
    args = (xk, fk, nk, xi, inv_s, None, out, None, sens)
    bound = _bound(args, _rows_flops(dim, order, True, nk.long(), RS, True, 0, 0))
    kw = dict(dimension=dim, order=order, weighting=W)
    times = {
        "launch": _time_ms(lambda: fit_rows._launch(*args, order=order, weighting=W, knowns=0,
                                                    refine_steps=RS, max_iter=0)),
        "fit_rows_wrapper": _time_ms(lambda: fit_rows.fit_rows(xk, fk, nk, xi, do_sens=True,
                                                               **kw)),
        "fit_rows_diffable_forward": _time_ms(lambda: fit_rows.fit_rows_diffable(
            xk, fk, nk, xi, **kw)),
        "plain": _time_ms(lambda: fit_rows.fit_rows_plain(xk, fk, nk, xi, do_sens=True, **kw))}
    A, sw, fkm = _weighted_basis(xk, fk, nk, xi, dim, order, W)
    rhs = torch.cat([(sw * fkm)[..., None], torch.diag_embed(sw)], dim=2)
    times["library_lstsq"] = _time_ms(lambda: torch.linalg.lstsq(A, rhs))
    del A, rhs, sw, fkm
    med = {k: v[0] for k, v in times.items()}
    return {"B": B, "K": Kn, "dim": dim, "order": order, "do_sens": True, "refine_steps": RS,
            "ms": {k: v[1] for k, v in times.items()}, "median_ms": med,
            "beyond_launch_ms": med["fit_rows_wrapper"] - med["launch"],
            "bound": bound, "launch_share_of_bound": bound["bound_ms"] / med["launch"],
            "library": "torch.linalg.lstsq on the prebuilt sqrt(w)-weighted basis "
                       "(basis build excluded)"}


def measure_rows_phases():
    """Where a rows-kernel case spends its time, run by hand, not by main():
    the kernel built with its phase clock (-DWLSQM_PHASE_CLOCK=1, each case's
    clock64() cycles per phase: staging and the CENTER pass, assembly, Jacobi
    and Cholesky, key, solve and sweeps, ALGO_ITERATIVE, the sens loop,
    stores) on the adjoint step's launch (the thread body: 2D order 2,
    K = 12, do_sens, 2^20 cases of the example's grid) and on the sens path
    (the warp body: 2D order 4, K = 30, do_sens, 2^21, phase_sens's cloud);
    then the adjoint launch alone against its bound, the wrapper, the plain
    version and the library yardstick (_adjoint_rows_times).

        python3 -c "import chip_smoke; chip_smoke.measure_rows_phases()"
    """
    from wlsqm_tpu_torch.ops import fit_rows

    dev = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:   # the shipped library beside it
        lib, _ = pool.map(lambda f: f(), (_rows_phase_lib, fit_rows.load))
    print(json.dumps({"library": os.path.basename(os.path.dirname(lib.path)),
                      "nvcc_s": lib.build_seconds, "ptxas": _ptxas_summary(lib.log)}), flush=True)
    table = {}
    _, adj = _adjoint_cloud(dev)
    table["adjoint_thread"] = _rows_phase_split(lib, adj, dim=2, order=2, do_sens=True)
    print(json.dumps({"adjoint_thread": table["adjoint_thread"]}), flush=True)
    table["adjoint_rows_launch"] = _adjoint_rows_times(adj)
    print(json.dumps({"adjoint_rows_launch": table["adjoint_rows_launch"]}), flush=True)
    del adj
    torch.cuda.empty_cache()
    sens = _cloud(B_ROWS, torch.Generator(device=dev).manual_seed(43), dev)
    table["sens_warp"] = _rows_phase_split(lib, sens, dim=2, order=ORDER, do_sens=True)
    print(json.dumps({"sens_warp": table["sens_warp"]}), flush=True)
    del sens
    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"rows_phases": table, "card": smi.splitlines()[0]}), flush=True)
    return table


def _rows_path_times():
    """The rows kernel's launches through whichever wlsqm_tpu_torch is first
    on sys.path: the adjoint step's (the thread body, 2^20, with sens) and
    the sens path's and the dim3 cloud's (the warp body, 2^21), median and
    the REPS times after one warm-up, each with a SHA-256 of its outputs'
    bytes; the thread body's launch at ROWS_THREAD_CONFIGS (B_PLAIN cases,
    CENTER, without and with sens); and a SHA-256 of every thread-body output (fi, the counts, sens,
    the key) over the thread-body grid: dims 1-3, orders with NO < 11, both
    weightings, K for each shared-memory layout of the thread body (K_GRID,
    12, 60, and the staging edge ROWS_STAGE_EDGE and one past it), with
    sens and a random knowns mask, with max_iter 3, and with the key, ragged
    nk with NaN padding; at the staging edge and one past it, the max_iter 3
    counts against the plain version's, pooled by dim (equal, within one,
    histogram distance)."""
    import hashlib

    import wlsqm_tpu_torch as wtt
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    dev = torch.device("cuda")
    out = {"package": os.path.dirname(os.path.abspath(wtt.__file__))}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:   # both libraries at once
        list(pool.map(fit_rows.load, (False, True)))

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            if t is not None:
                h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    _, adj = _adjoint_cloud(dev)
    clouds = {"adjoint": (adj, 2, 2),
              "sens": (_cloud(B_ROWS, torch.Generator(device=dev).manual_seed(43), dev), 2, ORDER),
              "dim3": (_cloud(B_ROWS, torch.Generator(device=dev).manual_seed(44), dev, dim=3,
                              K=K_DIM3), 3, ORDER)}
    for name, (data, dim, order) in clouds.items():
        xk, fk, nk, xi = data
        B, Kn, _ = xk.shape
        NO = defs.number_of_dofs(dim, order)
        _, _, _, inv_s = fit_kernel._prescale(xk, nk, xi)
        fi = torch.empty((B, NO), dtype=torch.float64, device=dev)
        sens = (torch.empty((B, Kn, NO), dtype=torch.float64, device=dev) if name != "dim3"
                else None)
        ms = _time_ms(lambda: fit_rows._launch(xk, fk, nk, xi, inv_s, None, fi, None, sens,
                                               order=order, weighting=wtt.WEIGHT_CENTER,
                                               knowns=0, refine_steps=1, max_iter=0))
        torch.cuda.synchronize()
        out[name] = {"launch_ms": ms, "sha256": sha(fi, sens)}
        del xk, fk, nk, xi, inv_s, fi, sens, data
        clouds[name] = None
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(2031)
    times = {}
    for dim, order, Kc in ROWS_THREAD_CONFIGS:
        xk, fk, nk, xi = _cloud(B_PLAIN, gen, dev, dim=dim, K=Kc, order=order)
        NO = defs.number_of_dofs(dim, order)
        _, _, _, inv_s = fit_kernel._prescale(xk, nk, xi)
        fi = torch.empty((B_PLAIN, NO), dtype=torch.float64, device=dev)
        sens = torch.empty((B_PLAIN, Kc, NO), dtype=torch.float64, device=dev)
        for with_sens in (False, True):
            times["d%d_o%d_K%d%s" % (dim, order, Kc, "_sens" if with_sens else "")] = _time_ms(
                lambda: fit_rows._launch(xk, fk, nk, xi, inv_s, None, fi, None,
                                         sens if with_sens else None, order=order,
                                         weighting=wtt.WEIGHT_CENTER, knowns=0, refine_steps=1,
                                         max_iter=0))[0]
    out["thread_configs_ms"] = times
    cpu_gen = torch.Generator().manual_seed(2031)
    grid = {}
    edge_counts = {}
    for dim in (1, 2, 3):
        edge = ROWS_STAGE_EDGE[dim]
        tally = edge_counts["d%d_K%d_%d" % (dim, edge, edge + 1)] = [0, 0, 0, 0]
        for order in range(ORDER + 1):
            if fit_rows.warp_body(dim, order):
                continue
            NO = defs.number_of_dofs(dim, order)
            for Kg in sorted({K_GRID[dim], max(12, 2 * NO), 60, edge, edge + 1}):
                for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
                    xk, fk, nk, xi = _cloud(8191, gen, dev, dim=dim, K=Kg, order=order,
                                            ragged=True, offset=True,
                                            lo=2 * NO if dim == 1 else None)
                    fi0 = torch.randn((8191, NO), generator=gen, device=dev, dtype=torch.float64)
                    kn = int(torch.randint(0, 1 << NO, (1,), generator=cpu_gen))
                    res = []
                    for knowns, do_sens, mi, cond in ((0, True, 0, False), (kn, True, 0, False),
                                                      (kn, False, 3, False), (kn, True, 0, True),
                                                      (0, False, 3, True)):
                        r = fit_rows.fit_rows(xk, fk, nk, xi, fi0, dimension=dim, order=order,
                                              weighting=w, knowns=knowns, do_sens=do_sens,
                                              max_iter=mi, emit_cond=cond)
                        res += r
                        if mi and not cond:
                            it = r[1]
                    grid["d%d_o%d_K%d_w%d" % (dim, order, Kg, w)] = sha(*res)
                    if Kg in (edge, edge + 1):
                        ref = fit_rows.fit_rows_plain(xk, fk, nk, xi, fi0, dimension=dim,
                                                      order=order, weighting=w, knowns=kn,
                                                      max_iter=3)[1]
                        hist = torch.bincount(it, minlength=4) - torch.bincount(ref, minlength=4)
                        tally[0] += int((it == ref).sum())
                        tally[1] += int(((it - ref).abs() <= 1).sum())
                        tally[2] += int(hist.abs().sum()) // 2
                        tally[3] += it.numel()
    out["thread_grid_sha256"] = grid
    out["edge_counts_vs_plain"] = {k: {"equal": t[0] / t[3], "within_one": t[1] / t[3],
                                       "histogram_distance": t[2] / t[3], "cases": t[3]}
                                   for k, t in edge_counts.items()}
    return out


def _rows_norm_lib():
    """The rows kernel built to write its ALGO_ITERATIVE trips' norms
    (-DWLSQM_ROWS_NORMS=1): a measurement library that no route loads."""
    import ctypes

    from wlsqm_tpu_torch import native
    from wlsqm_tpu_torch.ops import fit_rows

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return native.build(
        "fit_rows_norms", [fit_rows._SRC], {fit_rows._HEADER: fit_rows.tables_header()},
        {fit_rows._ENTRY: (i32, [vp] * 10 + [i64, i32, i32, i32, i32, i64, i32, i32, vp]),
         "wlsqm_rows_norm_buffer": (i32, [vp])},
        defines=("WLSQM_EMIT_COND=0", "WLSQM_ROWS_NORMS=1"), includes=fit_rows._INCLUDES)


def _plain_trip_norms(xk, fk, nk, xi, fi0, *, dimension, order, weighting, knowns):
    """The rows kernel's plain version's ALGO_ITERATIVE l∞ residual norms,
    (B, MAX_ITER): trip t's norm from the plain version's own scaled
    solution after t trips (ops.fit_rows._solve_rows at max_iter = t), in
    the operations its trip loop runs, so the same bits; a case's norms
    after its stop are its last solution's."""
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    delta, kmask, e_s, inv_s = fit_kernel._prescale(xk, nk, xi)
    KN = fit_rows.known_dofs(knowns, dimension, order)
    ghat = fit_rows._scaled_knowns(fi0, fit_kernel._dof_scale(e_s, dimension, order), KN)
    d, f = delta * inv_s[:, None, None], torch.where(kmask, fk, 0.0)
    c = fit_rows.basis_rows(d, dimension, order)
    out = []
    for t in range(MAX_ITER):
        xh = fit_rows._solve_rows(d, f, kmask, ghat, dimension=dimension, order=order,
                                  weighting=weighting, KN=KN,
                                  refine_steps=fit_rows.DEFAULT_REFINE_STEPS, do_sens=False,
                                  max_iter=t)[0]
        r = torch.where(kmask, f - (c @ xh[..., None])[..., 0], 0.0)
        out.append(r.abs().amax(dim=-1))
    return torch.stack(out, 1)


def _ulps(a, b):
    """|a - b| in units in the last place of max(|a|, |b|)."""
    m = torch.maximum(a.abs(), b.abs())
    return (a - b).abs() / (torch.nextafter(m, torch.full_like(m, math.inf)) - m)


def measure_count_ties(B=1031, configs=((2, (30, 63, 130)), (1, (16, 85)))):
    """C7: where the rows kernel's thread body and its plain version part on
    an ALGO_ITERATIVE count, which kind of disagreement it is; run by hand,
    not by main().  At each (dim, K), every thread-body order, both
    weightings, max_iter 3, on the card test's clouds
    (test_rows_thread_body_layouts_match_plain: B = 1031, seed K + w, a
    random knowns mask drawn as it draws them, random fi_init): the kernel
    built to write each trip's l∞ residual norm (_rows_norm_lib; its fi and
    counts held to the shipped library's bits) and the plain version's
    norms (_plain_trip_norms).  A case whose counts differ is an
    exact-stagnation tie when the side that stopped first (count t) saw its
    norm repeat bit for bit at trip t while the other side's moved by at most
    COUNT_TIE_ULPS ulps there (docs/porting.md:40-44, C2's class); any other
    disagreement is counted apart.  Prints per (dim, K) the pooled tally
    (equal, within one, histogram distance) and the split.

        python3 -c "import chip_smoke; chip_smoke.measure_count_ties()"
    """
    import importlib.util

    import wlsqm_tpu_torch as wtt
    from wlsqm_tpu_torch.ops import fit_rows

    spec = importlib.util.spec_from_file_location(   # by path: "tests" may name another package
        "_card_tests", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                    "test_torch_cuda.py"))
    card_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card_tests)

    dev = torch.device("cuda")
    lib = _rows_norm_lib()
    table = {}
    shipped_load = fit_rows.load
    for dim, Ks in configs:
        for K in Ks:
            g = torch.Generator().manual_seed(100 + dim)
            fg = torch.Generator(device=dev).manual_seed(7 * K + dim)
            tally = {"cases": 0, "equal": 0, "within_one": 0, "histogram_apart": 0,
                     "disagree": 0, "ties": 0, "other": 0, "kernel_stopped_first": 0,
                     "ulps_at_stop": {"<=1": 0, "2": 0, "3-%d" % COUNT_TIE_ULPS: 0,
                                      "%d-16" % (COUNT_TIE_ULPS + 1): 0, "17-256": 0,
                                      ">256": 0},
                     "other_examples": [], "same_bits_as_shipped": True,
                     "kernel_repeats": 0, "plain_repeats": 0}
            for order in range(ORDER + 1):
                if fit_rows.warp_body(dim, order):
                    continue
                NO = wtt.number_of_dofs(dim, order)
                for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
                    xk, fk, nk, xi = card_tests._cloud(dev, B, K, order, K + w, dim,
                                                       lo=2 * NO if dim == 1 else None)
                    fi0 = torch.randn((B, NO), generator=fg, dtype=torch.float64, device=dev)
                    kn = int(torch.randint(0, 1 << NO, (1,), generator=g))
                    kw = dict(dimension=dim, order=order, weighting=w, knowns=kn,
                              max_iter=MAX_ITER)
                    nk_k = torch.full((B, MAX_ITER), math.nan, dtype=torch.float64, device=dev)
                    if lib.lib.wlsqm_rows_norm_buffer(nk_k.data_ptr()) != 0:
                        raise RuntimeError("count ties: the norm buffer was not set")
                    fit_rows.load = lambda emit_cond=False: lib
                    try:
                        got = fit_rows.fit_rows(xk, fk, nk, xi, fi0, **kw)
                    finally:
                        fit_rows.load = shipped_load
                    shipped = fit_rows.fit_rows(xk, fk, nk, xi, fi0, **kw)
                    ref = fit_rows.fit_rows_plain(xk, fk, nk, xi, fi0, **kw)
                    np_ = _plain_trip_norms(xk, fk, nk, xi, fi0, dimension=dim, order=order,
                                            weighting=w, knowns=kn)
                    torch.cuda.synchronize()
                    tally["same_bits_as_shipped"] &= (_same_bits(got[0], shipped[0])
                                                      and torch.equal(got[1], shipped[1]))
                    ck, cp = got[1].long(), ref[1].long()
                    tally["cases"] += B
                    tally["equal"] += int((ck == cp).sum())
                    tally["within_one"] += int(((ck - cp).abs() <= 1).sum())
                    tally["histogram_apart"] += int(
                        (torch.bincount(ck, minlength=MAX_ITER + 1)
                         - torch.bincount(cp, minlength=MAX_ITER + 1)).abs().sum()) // 2
                    # how often each side's norm repeats at all (a stop before max_iter)
                    tally["kernel_repeats"] += int((ck < MAX_ITER).sum())
                    tally["plain_repeats"] += int((cp < MAX_ITER).sum())
                    for i in (ck != cp).nonzero().squeeze(1).tolist():
                        t = int(min(ck[i], cp[i]))
                        first_k = bool(ck[i] < cp[i])
                        stop, go = (nk_k[i], np_[i]) if first_k else (np_[i], nk_k[i])
                        tally["disagree"] += 1
                        tally["kernel_stopped_first"] += first_k
                        u = float(_ulps(go[t], go[t - 1]))
                        bins = tally["ulps_at_stop"]
                        bins[next(b for b, hi in zip(bins, (1, 2, COUNT_TIE_ULPS, 16, 256,
                                                            math.inf)) if u <= hi)] += 1
                        if 1 <= t < MAX_ITER and bool(stop[t] == stop[t - 1]) \
                                and u <= COUNT_TIE_ULPS:
                            tally["ties"] += 1
                        else:
                            tally["other"] += 1
                            if len(tally["other_examples"]) < 8:
                                tally["other_examples"].append({
                                    "order": order, "w": w, "case": i, "counts": [
                                        int(ck[i]), int(cp[i])],
                                    "kernel_norms": nk_k[i].tolist(),
                                    "plain_norms": np_[i].tolist(), "ulps_at_stop": u})
            n = tally["cases"]
            tally.update(equal_share=tally["equal"] / n, within_one_share=tally["within_one"] / n,
                         histogram_distance=tally["histogram_apart"] / n,
                         tie_share_of_disagreements=tally["ties"] / max(tally["disagree"], 1))
            table["d%d_K%d" % (dim, K)] = tally
            print(json.dumps({"count_ties": {"d%d_K%d" % (dim, K): tally}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"count_ties_by_K": {k: {x: v[x] for x in (
        "cases", "equal_share", "within_one_share", "histogram_distance", "disagree", "ties",
        "other", "tie_share_of_disagreements", "kernel_stopped_first")}
        for k, v in table.items()}, "card": smi.splitlines()[0]}), flush=True)
    if not all(v["same_bits_as_shipped"] for v in table.values()):
        raise RuntimeError("the norm build's fi or counts are not the shipped library's bits")
    return table

def _gather_path_times():
    """The gather kernel's launches through whichever wlsqm_tpu_torch is
    first on sys.path: the IBVP step's (n = 2^22, K = 28, f64, F = 1 and 3)
    and the Euler step's (its 2^22-point cloud, K = 24, F = 8 f64), median and
    the REPS times after one warm-up, each with whether it is u[idx] bit for
    bit."""
    import wlsqm_tpu_torch as wtt
    from wlsqm_tpu_torch.examples import euler_flow as ef
    from wlsqm_tpu_torch.ops import gather

    dev = torch.device("cuda")
    out = {"package": os.path.dirname(os.path.abspath(wtt.__file__))}
    _, ibvp_idx, _, _ = ibvp_setup()
    pts = ef.cloud(N_EULER_SIDE)
    _, own, _ = ef.periodic_neighbours(pts, ef.K)
    gen = torch.Generator(device=dev).manual_seed(2033)
    for name, idx_np, n, F in (("ibvp_F1", ibvp_idx, N_IBVP, 1), ("ibvp_F3", ibvp_idx, N_IBVP, 3),
                               ("euler_F8", own, len(pts), 8)):
        flat = torch.as_tensor(np.ascontiguousarray(idx_np, dtype=np.int32), device=dev).reshape(-1)
        u = torch.randn((n, F), generator=gen, dtype=torch.float64, device=dev)
        words = u.view(torch.int32)
        dst = torch.empty((flat.numel(), words.shape[1]), dtype=torch.int32, device=dev)
        ms = _time_ms(lambda: gather._launch([words], flat, [dst]))
        torch.cuda.synchronize()
        out[name] = {"launch_ms": ms, "bit_equal": torch.equal(
            dst, u[flat.long()].view(torch.int32).reshape(flat.numel(), -1))}
        del flat, u, words, dst
        torch.cuda.empty_cache()
    return out


def measure_gather_paths(other_root):
    """The gather kernel's IBVP and Euler launches of this checkout against
    another one (the parent commit, unpacked by ``git archive`` into a
    git-ignored directory), run by hand, not by main(): other, this, this,
    other, each in a process of its own (_gather_path_times).

        python3 -c "import chip_smoke; chip_smoke.measure_gather_paths('build/parent')"
    """
    runs = _other_this_this_other(other_root, "_gather_path_times")
    paths = ("ibvp_F1", "ibvp_F3", "euler_F8")
    print(json.dumps({"gather_paths_bit_equal": {p: all(r[p]["bit_equal"] for r in runs)
                                                 for p in paths},
                      "launch_ms_median": {p: [r[p]["launch_ms"][0] for r in runs]
                                           for p in paths}}), flush=True)
    return runs


#: thread-body configurations (dim, order, K) that measure_rows_paths times:
#: the rows cut's NO = 10 pair (measure_rows_cut), 1D order 4, and 2D order 2
#: at the headline's K (nothing staged)
ROWS_THREAD_CONFIGS = ((2, 3, K), (3, 2, K_DIM3), (1, 4, K_GRID[1]), (2, 2, K))


def measure_rows_paths(other_root):
    """The rows kernel's launches of this checkout against another one (the
    parent commit, unpacked by ``git archive`` into a git-ignored
    directory), run by hand, not by main(): other, this, this, other, each
    in a process of its own (_rows_path_times), and whether the outputs are
    the same bits in all four, path by path and over the thread-body grid.

        python3 -c "import chip_smoke; chip_smoke.measure_rows_paths('build/parent')"
    """
    runs = _other_this_this_other(other_root, "_rows_path_times")
    paths = ("adjoint", "sens", "dim3")
    same = {p: len({r[p]["sha256"] for r in runs}) == 1 for p in paths}
    grid = runs[0]["thread_grid_sha256"]
    same["thread_grid"] = all(r["thread_grid_sha256"] == grid for r in runs)
    differ = sorted(k for k in grid if any(r["thread_grid_sha256"][k] != grid[k] for r in runs))
    print(json.dumps({"rows_paths_same_bits_as_other": same, "thread_grid_configs": len(grid),
                      "thread_grid_differ": differ,
                      "launch_ms_median": {p: [r[p]["launch_ms"][0] for r in runs]
                                           for p in paths},
                      "edge_counts_vs_plain": [r["edge_counts_vs_plain"] for r in runs],
                      "thread_configs_ms": {c: [r["thread_configs_ms"][c] for r in runs]
                                            for c in runs[0]["thread_configs_ms"]}}), flush=True)
    return runs, same


def _auto_route_times():
    """fit_many(backend="auto") and fit_many(plan=) on phase_certified's
    cloud (B_CERT cases; the plan from its first B_PLAN), median and the
    REPS times after one warm-up, through whichever wlsqm_tpu_torch is first
    on sys.path."""
    import wlsqm_tpu_torch as wtt

    dev = torch.device("cuda")
    xk, fk, xi, _ = _certified_cloud(B_CERT, dev)
    kw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER)
    plan = wtt.plan_fit_many(xk[:B_PLAN], xi[:B_PLAN], **kw)
    return {"package": os.path.dirname(os.path.abspath(wtt.__file__)),
            "route": plan.route.path, "split_edge": plan.route.split_edge,
            "fit_many_auto_ms": _time_ms(lambda: wtt.fit_many(xk, fk, xi, backend="auto", **kw)),
            "fit_many_plan_ms": _time_ms(lambda: wtt.fit_many(xk, fk, xi, plan=plan, **kw))}


def _headline_route_times():
    """The headline path (phase_headline's cloud at B_MAIN): fit_many(plan=)
    and fit_kernel, median and the REPS times after one warm-up, through
    whichever wlsqm_tpu_torch is first on sys.path."""
    import wlsqm_tpu_torch as wtt
    from wlsqm_tpu_torch.ops import fit_kernel

    dev = torch.device("cuda")
    xk, fk, nk, xi = _cloud(B_MAIN, torch.Generator(device=dev).manual_seed(42), dev)
    kw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER)
    plan = wtt.plan_fit_many(xk[:B_PLAN], xi[:B_PLAN], **kw)
    return {"package": os.path.dirname(os.path.abspath(wtt.__file__)),
            "route": plan.route.path, "assembly": plan.route.assembly,
            "fit_many_plan_ms": _time_ms(lambda: wtt.fit_many(xk, fk, xi, plan=plan, **kw)),
            "fit_kernel_ms": _time_ms(lambda: fit_kernel.fit_kernel(
                xk, fk, nk, xi, dimension=2, **kw))}


def _other_this_this_other(other_root, fn):
    """Run this file's ``fn`` in four processes of their own, each importing
    one checkout's wlsqm_tpu_torch (built there): other, this, this, other."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import importlib.util, json, sys; sys.path.insert(0, %r); "
            "spec = importlib.util.spec_from_file_location('smoke', %r); "
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
            "print(json.dumps(m.%s()))")
    runs = []
    for root in (other_root, here, here, other_root):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", code % (root, os.path.abspath(__file__), fn)],
                              cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError("%s in %s failed:\n%s" % (fn, root, proc.stderr[-4000:]))
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({fn + "_other_this_this_other": runs, "card": smi.splitlines()[0]}),
          flush=True)
    return runs


def measure_auto_route(other_root):
    """The certified auto route of this checkout against another one (the
    parent commit, unpacked by ``git archive`` into a git-ignored
    directory), run by hand, not by main(): other, this, this, other, each
    in a process of its own that imports that checkout's wlsqm_tpu_torch
    (built there, with its own shipped calibration record) and times it
    with this file's _auto_route_times.

        python3 -c "import chip_smoke; chip_smoke.measure_auto_route('build/parent')"
    """
    return _other_this_this_other(other_root, "_auto_route_times")


def measure_headline_route(other_root):
    """The headline path of this checkout against another one, as
    measure_auto_route (other, this, this, other; _headline_route_times):

        python3 -c "import chip_smoke; chip_smoke.measure_headline_route('build/parent')"
    """
    return _other_this_this_other(other_root, "_headline_route_times")



def _moment_path_times():
    """The moment kernel's launches on the headline path (phase_headline's
    cloud, B_MAIN, the 2D basic instance), the dim3 path (phase_dim3's,
    B_ROWS, the warp body), the iterative path (phase_iterative's, B_MAIN,
    max_iter = MAX_ITER, the 2D ALGO_ITERATIVE instance), the dim1 path
    (phase_dim1's, B_MAIN, basic and max_iter = MAX_ITER) and the
    dim3_thread path (phase_dim3_thread's, B_ROWS): median and the REPS
    times after one warm-up, and a SHA-256 of fi's and the counts' bytes
    (on the dim1 and dim3_thread paths also of the launch with the key, fi
    and the key), through whichever wlsqm_tpu_torch is first on sys.path;
    fi's first B_ENGINE rows are saved beside this file (under
    build/chip_smoke/, by package) for measure_moment_paths to compare.  The
    iterative launch also at max_iter = 0, 1, 2 on the same instance (ext=2:
    the one with ALGO_ITERATIVE; a package without it takes its one with
    knowns and ALGO_ITERATIVE), so each trip's cost is a difference of
    launch times."""
    import hashlib

    import wlsqm_tpu_torch as wtt
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel

    dev = torch.device("cuda")
    out = {"package": os.path.dirname(os.path.abspath(wtt.__file__))}

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            if t is not None:
                h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    C, U = wtt.WEIGHT_CENTER, wtt.WEIGHT_UNIFORM
    for name, dim, B, seed, k, mi, order, w in (
            ("headline", 2, B_MAIN, 42, K, 0, ORDER, C),
            ("dim3", 3, B_ROWS, 44, K_DIM3, 0, ORDER, C),
            ("iterative", 2, B_MAIN, 45, K, MAX_ITER, ORDER, C),
            ("dim1", 1, B_MAIN, 46, K_DIM1, 0, ORDER, U),
            ("dim1_iterative", 1, B_MAIN, 46, K_DIM1, MAX_ITER, ORDER, U),
            ("dim3_thread", 3, B_ROWS, 47, K_DIM3, 0, ORDER_DIM3_THREAD, C)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        xk, fk, nk, xi = (_dim1_cloud(B, gen, dev, K=k) if dim == 1 else
                          _cloud(B, gen, dev, dim=dim, K=k, order=order))
        fi = torch.empty((B, defs.number_of_dofs(dim, order)), dtype=torch.float64, device=dev)
        its = torch.empty((B,), dtype=torch.int32, device=dev) if mi else None
        kw = dict(order=order, weighting=w, refine_steps=1)
        ms = _time_ms(lambda: fit_kernel._launch(xk, fk, nk, xi, fi, iters=its, max_iter=mi,
                                                 **kw))
        torch.cuda.synchronize()
        rec = {"launch_ms": ms, "fi_sha256": sha(fi), "counts_sha256": sha(its)}
        if name == "iterative":
            by_trips = {}
            for m in range(mi):
                by_trips[m] = _time_ms(lambda: fit_kernel._launch(
                    xk, fk, nk, xi, fi.clone(), iters=its.clone() if m else None, max_iter=m,
                    ext=2, **kw))[0]
            by_trips[mi] = ms[0]
            rec["launch_ms_by_max_iter"] = by_trips
        if dim != 2 and not fit_kernel.warp_body(dim, order):
            fik, est = torch.empty_like(fi), torch.empty((B,), dtype=torch.float64, device=dev)
            itk = torch.empty_like(its) if mi else None
            rec["key_launch_ms"] = _time_ms(lambda: fit_kernel._launch(
                xk, fk, nk, xi, fik, est, iters=itk, max_iter=mi, **kw))
            torch.cuda.synchronize()
            rec["key_sha256"] = sha(fik, itk, est)
        keep = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
        os.makedirs(keep, exist_ok=True)
        sample = os.path.join(keep, "paths_%s_%s.pt" % (
            hashlib.sha256(out["package"].encode()).hexdigest()[:12], name))
        torch.save(fi[:B_ENGINE].cpu(), sample)
        rec["fi_sample"] = sample
        out[name] = rec
        del xk, fk, nk, xi, fi, its
        torch.cuda.empty_cache()
    return out


#: the paths measure_moment_paths compares
MOMENT_PATHS = ("headline", "dim3", "iterative", "dim1", "dim1_iterative", "dim3_thread")


def measure_moment_paths(other_root):
    """The moment kernel's launches on MOMENT_PATHS of this checkout against
    another one (the parent commit, unpacked by ``git archive`` into a
    git-ignored directory), run by hand, not by main(): other, this, this,
    other, each in a process of its own (_moment_path_times), and whether
    fi, the counts and (on the 1D and 3D thread paths) the key are the same
    bits in all four.

        python3 -c "import chip_smoke; chip_smoke.measure_moment_paths('build/parent')"
    """
    runs = _other_this_this_other(other_root, "_moment_path_times")
    same = {p: len({(r[p]["fi_sha256"], r[p]["counts_sha256"], r[p].get("key_sha256"))
                    for r in runs}) == 1 for p in MOMENT_PATHS}
    rel = {}
    for p in MOMENT_PATHS:
        a, b = (torch.load(runs[i][p]["fi_sample"]) for i in (0, 1))
        rel[p] = _rel(b, a)
        for r in runs:
            if os.path.exists(r[p]["fi_sample"]):
                os.remove(r[p]["fi_sample"])
    print(json.dumps({"moment_paths_same_bits_as_other": same,
                      "fi_rel_to_other_first_%d_cases" % B_ENGINE: rel,
                      "launch_ms_median": {p: [r[p]["launch_ms"][0] for r in runs]
                                           for p in MOMENT_PATHS},
                      "key_launch_ms_median": {p: [r[p]["key_launch_ms"][0] for r in runs]
                                               for p in MOMENT_PATHS
                                               if "key_launch_ms" in runs[0][p]},
                      "iterative_launch_ms_by_max_iter": [r["iterative"]["launch_ms_by_max_iter"]
                                                          for r in runs]}), flush=True)
    return runs, same



def measure_warp_residency(counts=(12, 16, 20, 24)):
    """The moment kernel's warp body (dim3 path: 3D order 4, K = 48, CENTER,
    B_ROWS) built with each count of resident cases an SM in its launch
    bounds (-DWLSQM_WARP_MIN_BLOCKS; the shipped source says 16), run by
    hand, not by main(): each build's registers and spills, and its launch
    (median of REPS, in turns forward then backward) with fi held to the
    shipped build's bits.

        python3 -c "import chip_smoke; chip_smoke.measure_warp_residency()"
    """
    import ctypes

    from wlsqm_tpu_torch import native
    from wlsqm_tpu_torch.ops import fit_kernel

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

    def build(nb):
        return native.build(
            "fit_moment_d3_warp%d" % nb, [fit_kernel._SRC],
            {fit_kernel._HEADER: fit_kernel.tables_header()},
            {fit_kernel._ENTRY: (i32, [vp] * 8 + [i64, i32, i32, i32, i32, i64, i64, i32, i32,
                                                   i32, vp])},
            defines=("WLSQM_EMIT_COND=0", "WLSQM_MOMENT_DIM=3",
                     "WLSQM_WARP_MIN_BLOCKS=%d" % nb), includes=fit_kernel._INCLUDES)

    dev = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(len(counts)) as pool:
        libs = dict(zip(counts, pool.map(build, counts)))
    xk, fk, nk, xi = _cloud(B_ROWS, torch.Generator(device=dev).manual_seed(44), dev, dim=3,
                            K=K_DIM3)
    ref = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=3, order=ORDER, weighting=2)
    out = torch.empty_like(ref)
    table = {nb: {"ptxas": {k: v for k, v in _ptxas_summary(lib.log).items()
                            if k.startswith("fit_moment_warp<3,4")}, "launch_ms": []}
             for nb, lib in libs.items()}
    for nb in list(counts) + list(counts)[::-1]:
        def go(lib=libs[nb].lib):
            status = lib.wlsqm_fit_moment(
                xk.data_ptr(), fk.data_ptr(), nk.data_ptr(), xi.data_ptr(), None, out.data_ptr(),
                None, None, B_ROWS, K_DIM3, 3, ORDER, 2, 0, 0, 1, 0, 0,
                torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError("warp body (%d resident) failed: CUDA error %d" % (nb, status))
        table[nb]["launch_ms"].append(_time_ms(go)[0])
        table[nb]["same_bits_as_shipped"] = _same_bits(out, ref)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"warp_residency": table, "card": smi.splitlines()[0]}), flush=True)
    return table

def measure_engine_batch_invariance():
    """Where the f64 engine's results depend on the batch they are computed
    in: each of 4 equal slices of a 2^20-case headline batch through the
    engine alone, against the same rows of the one 2^20-case call, stage by
    stage (the prepared state, the RHS contraction, the solve); then the RHS
    contraction ``einsum("bkj,bk->bj")`` (cuBLAS's batched gemv) on random
    (B, 30, 15) inputs, B = 2^20, as slices of 65,535 / 65,536 / 2^18 cases
    at the start and at the end of the batch: the rows of each slice call
    that differ from the one call.  Run by hand (~1 min)."""
    import dataclasses

    from wlsqm_tpu_torch.fitter import engine

    dev = torch.device("cuda")
    B = 1 << 20
    xk, fk, nk, xi = _cloud(B, torch.Generator(device=dev).manual_seed(91), dev)
    case = (torch.full((B,), ORDER, dtype=torch.int32, device=dev),
            torch.zeros(B, dtype=torch.int64, device=dev),
            torch.full((B,), 2, dtype=torch.int32, device=dev))
    kw = dict(dimension=2, NO=15)
    one = engine.prepare(xk, nk, xi, *case, **kw)
    b1 = engine._rhs(one, torch.where(one.w > 0, fk, 0.0))
    x1 = engine._solve(one, b1)
    shards = {}
    for j, s in enumerate(torch.arange(B, device=dev).tensor_split(4)):
        s = slice(int(s[0]), int(s[-1]) + 1)
        prep = engine.prepare(xk[s], nk[s], xi[s], *(c[s] for c in case), **kw)
        b2 = engine._rhs(prep, torch.where(prep.w > 0, fk[s], 0.0))
        differ = [f.name for f in dataclasses.fields(prep)
                  if isinstance(getattr(prep, f.name), torch.Tensor) and not torch.equal(
                      getattr(one, f.name)[s].nan_to_num(), getattr(prep, f.name).nan_to_num())]
        differ += [] if torch.equal(one.fac[0][s], prep.fac[0]) else ["fac"]
        shards["shard%d" % j] = {"prepared_fields_differing": differ,
                                 "rhs_equal": torch.equal(b1[s], b2),
                                 "solve_equal": torch.equal(x1[s], engine._solve(prep, b2)),
                                 "solve_rel": _rel(engine._solve(prep, b2), x1[s])}
    g = torch.Generator(device=dev).manual_seed(5)
    cw = torch.randn((B, 30, 15), generator=g, device=dev, dtype=torch.float64)
    r = torch.randn((B, 30), generator=g, device=dev, dtype=torch.float64)
    full = torch.einsum("bkj,bk->bj", cw, r)
    gemv = {}
    for n in (65535, 65536, 1 << 18):
        for start in (0, B - n):
            part = torch.einsum("bkj,bk->bj", cw[start:start + n], r[start:start + n])
            bad = (part != full[start:start + n]).any(1).nonzero().squeeze(1) + start
            gemv["%d_at_%d" % (n, start)] = {"rows_differing": int(bad.numel()),
                                             "first": int(bad[0]) if bad.numel() else None,
                                             "last": int(bad[-1]) if bad.numel() else None}
    print(json.dumps({"engine_batch_invariance": shards, "gemv_slices": gemv,
                      "rows_in_full_pieces_of_65535": 16 * 65535}), flush=True)


# -- gradients, the stream, the sharded layer, serialization, warmup, the tree --

def _events_ms(fn):
    """One call of ``fn`` timed with CUDA events (ms), and its result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _grad_rel(a, b) -> float:
    """max |a - b| over max |b|: a gradient against the engine's."""
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


def phase_grad(dev, wtt):
    """Gradients through the public route on the card, headline and sens
    configurations at 2^18: ``fit_many`` with xk and fk requiring grad warns,
    launches no kernel and gives the engine's gradient; ``backend="kernel"``
    and a kernel plan raise; ``fit_rows_diffable`` (one rows launch with
    sens) gives the engine's fk gradient to 1e-10; ``fixed_trip`` is the
    loop form bit for bit.  The backward passes are timed.  Returns the
    launches of the path."""
    import warnings

    from wlsqm_tpu_torch.fitter import engine
    from wlsqm_tpu_torch.ops import fit_rows

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B = B_GRAD
    gen = torch.Generator(device=dev).manual_seed(71)
    xk, fk, nk, xi = _cloud(B, gen, dev)
    cfg = (torch.full((B,), ORDER, dtype=torch.int32, device=dev),
           torch.zeros(B, dtype=torch.int64, device=dev),
           torch.full((B,), wtt.WEIGHT_CENTER, dtype=torch.int32, device=dev))
    kw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER)
    plan = wtt.plan_fit_many(xk[:B_PLAN], xi[:B_PLAN], **kw)
    out = {"path": "grad", "B": B}
    with warnings.catch_warnings():    # one small pass first: the backward's own set-up
        warnings.simplefilter("ignore")
        for do_sens in (False, True):
            x, f = xk[:4096].clone().requires_grad_(True), fk[:4096].clone().requires_grad_(True)
            r = wtt.fit_many(x, f, xi[:4096], do_sens=do_sens, **kw)
            torch.autograd.grad(r.fi.sum() + (r.sens.nan_to_num().sum() if do_sens else 0),
                                (x, f))
    _zero_launches()
    g_fk = None
    for do_sens in (False, True):
        name = "sens" if do_sens else "headline"
        xg, fg = xk.clone().requires_grad_(True), fk.clone().requires_grad_(True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = wtt.fit_many(xg, fg, xi, do_sens=do_sens, **kw)
        if not any("autograd" in str(w.message) for w in caught):
            raise RuntimeError("fit_many under autograd did not warn (%s)" % name)
        wfi = torch.randn(res.fi.shape, generator=gen, device=dev, dtype=torch.float64)
        ws = (torch.randn(res.sens.shape, generator=gen, device=dev, dtype=torch.float64)
              if do_sens else None)

        def loss(fi, sens):
            total = (fi * wfi).sum()
            return total + (sens.nan_to_num() * ws).sum() if do_sens else total

        bwd_ms, (gx, gf) = _events_ms(lambda: torch.autograd.grad(
            loss(res.fi, res.sens), (xg, fg)))
        xe, fe = xk.clone().requires_grad_(True), fk.clone().requires_grad_(True)
        fwd_ms, ref = _events_ms(lambda: engine.fit_batch(
            xe, fe, nk, xi, xk.new_zeros((B, 15)), *cfg, dimension=2, NO=15,
            do_sens=do_sens))
        ebwd_ms, (ex, ef) = _events_ms(lambda: torch.autograd.grad(
            loss(ref[0], ref[1] if do_sens else None), (xe, fe)))
        out[name] = {"vs_engine_fk": _grad_rel(gf, ef), "vs_engine_xk": _grad_rel(gx, ex),
                     "fit_many_backward_ms": bwd_ms, "engine_forward_ms": fwd_ms,
                     "engine_backward_ms": ebwd_ms}
        if not do_sens:
            g_fk, wfi_h = ef, wfi
        for bad in (dict(backend="kernel"), dict(plan=plan)):
            try:
                wtt.fit_many(xg, fg, xi, do_sens=do_sens, **kw, **bad)
            except ValueError:
                continue
            raise RuntimeError("a kernel route under autograd did not raise: %s" % (bad,))
        del res, gx, gf, ref, ex, ef, xg, fg, xe, fe
    torch.cuda.synchronize()
    engine_launches = _kernel_launches()
    if any(engine_launches.values()):
        raise RuntimeError("fit_many under autograd launched a kernel: %s" % engine_launches)

    # fit_rows_diffable: one rows launch with sens, backward one contraction
    fd = fk.clone().requires_grad_(True)
    fwd_ms, fi = _events_ms(lambda: fit_rows.fit_rows_diffable(
        xk, fd, nk, xi, dimension=2, order=ORDER, weighting=wtt.WEIGHT_CENTER))
    bwd_ms, (gd,) = _events_ms(lambda: torch.autograd.grad((fi * wfi_h).sum(), (fd,)))
    launches = _kernel_launches()
    out["fit_rows_diffable"] = {"vs_engine_fk": _grad_rel(gd, g_fk), "forward_ms": fwd_ms,
                                "backward_ms": bwd_ms, "launches": launches}
    del fi, gd, fd

    # fixed_trip: max_iter masked trips, no host read; the loop form's bits
    fkn = fk + 1e-3 * torch.randn(fk.shape, generator=gen, device=dev, dtype=torch.float64)
    args = (xk, fkn, nk, xi, xk.new_zeros((B, 15)), *cfg)
    ikw = dict(dimension=2, NO=15, iterative=True, max_iter=5)
    loop_ms, loop = _events_ms(lambda: engine.fit_batch(*args, **ikw))
    fixed_ms, fixed = _events_ms(lambda: engine.fit_batch(*args, fixed_trip=True, **ikw))
    same = torch.equal(loop[0], fixed[0]) and torch.equal(loop[2], fixed[2])
    out["fixed_trip"] = {"bit_equal": same, "loop_ms": loop_ms, "fixed_trip_ms": fixed_ms,
                         "max_count": int(loop[2].max())}
    out["peak_mem_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
    out["tol"] = PARITY
    print(json.dumps(out), flush=True)
    worst = max(max(out[n]["vs_engine_fk"], out[n]["vs_engine_xk"])
                for n in ("headline", "sens"))
    worst = max(worst, out["fit_rows_diffable"]["vs_engine_fk"])
    if worst > PARITY:
        raise RuntimeError("gradient against the engine's: %.3e > %.0e" % (worst, PARITY))
    if not same:
        raise RuntimeError("fixed_trip differs from the loop form")
    if launches != _launches(rows=1):
        raise RuntimeError("fit_rows_diffable did not launch the rows kernel once: %s"
                           % (launches,))
    return launches


def stream_cloud(dev):
    """The headline configuration on a host cloud of B_STREAM cases (xk
    uniform in [-1, 1]^2, fk = sin 3x cos 2y + 0.01 noise; xi = 0): made on
    the card from a seed, a chunk at a time, and copied into NumPy arrays;
    with each case's moment key (K3 in the moment body, launched here, on no
    counted path), as a NumPy array."""
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel

    xk = np.empty((B_STREAM, K, 2))
    fk = np.empty((B_STREAM, K))
    keys = np.empty(B_STREAM)
    gen = torch.Generator(device=dev).manual_seed(81)
    step = CHUNK_STREAM
    for lo in range(0, B_STREAM, step):
        x, f, nk, xi = _cloud(step, gen, dev)
        torch.from_numpy(xk[lo:lo + step]).copy_(x)
        torch.from_numpy(fk[lo:lo + step]).copy_(f)
        torch.from_numpy(keys[lo:lo + step]).copy_(fit_kernel.fit_kernel(
            x, f, nk, xi, dimension=2, order=ORDER, weighting=defs.WEIGHT_CENTER,
            emit_cond=True)[1])
    return xk, fk, keys


def phase_stream(dev, wtt, smi, resident_ms):
    """``fit_stream`` of the headline configuration on a 2^24-case host
    cloud (~12 GB of NumPy), chunk 2^21: its rate beside the serial sum
    (H2D + fit + D2H of one chunk, times the chunks), the PCIe byte bound at
    the copy rates this run measures, and the resident ``fit_many`` on
    2^23.  Every chunk bit-equal to ``fit_many(plan=)`` of that chunk; scipy
    parity on the first 1,024 cases.  Returns the cloud, the result, the
    moment keys and the launches of the path."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xk, fk, keys = stream_cloud(dev)
    cloud_s = time.perf_counter() - t0
    kw = dict(order=ORDER, weighting=wtt.WEIGHT_CENTER)
    out = np.empty((B_STREAM, 15))
    out.fill(0.0)                      # touched: the stream's time is not page faults
    _zero_launches()
    t0 = time.perf_counter()
    res = wtt.fit_stream(xk, fk, chunk=CHUNK_STREAM, out=out, **kw)
    first_s = time.perf_counter() - t0
    launches = _kernel_launches()
    # again: the first call also allocates its pinned slots, which PyTorch's
    # host allocator then keeps for the next
    t0 = time.perf_counter()
    wtt.fit_stream(xk, fk, chunk=CHUNK_STREAM, out=out, **kw)
    stream_s = time.perf_counter() - t0
    # the stream's own plan, made again: on its first chunk (2^21 cases) the
    # key's maximum may pass the moment body's edge, and the plan then names
    # the rows body; the bit-for-bit check below holds the stream to it
    plan = wtt.plan_fit_many(xk[:CHUNK_STREAM], **kw)
    body = {"moments": "fit_moment", "rows": "fit_rows"}.get(plan.route.assembly)
    if res.fi is not out or body is None or launches[body] < B_STREAM // CHUNK_STREAM:
        raise RuntimeError("fit_stream (plan %s) launched %s for %d chunks"
                           % (plan.route, launches, B_STREAM // CHUNK_STREAM))

    from wlsqm_tpu_torch.fitter import condprobe

    edge = condprobe.est_certified_edges()["moments"]
    # every chunk against fit_many(plan=) of that chunk, bit for bit
    equal = True
    for lo in range(0, B_STREAM, CHUNK_STREAM):
        sl = slice(lo, lo + CHUNK_STREAM)
        ref = wtt.fit_many(torch.from_numpy(xk[sl]).to(dev), torch.from_numpy(fk[sl]).to(dev),
                           plan=plan, **kw).fi
        equal &= torch.equal(ref.cpu(), torch.from_numpy(out[sl]))
    scipy_err = parity_check(xk[:B_SCIPY], fk[:B_SCIPY], out[:B_SCIPY])

    # one chunk's parts, serially: upload from pinned memory, fit, download
    n = CHUNK_STREAM
    hx = torch.from_numpy(xk[:n]).pin_memory()
    hf = torch.from_numpy(fk[:n]).pin_memory()
    dx, df = torch.empty_like(hx, device=dev), torch.empty_like(hf, device=dev)
    h2d_ms, _ = _time_ms(lambda: (dx.copy_(hx, non_blocking=True),
                                  df.copy_(hf, non_blocking=True)))
    fit_ms, _ = _time_ms(lambda: wtt.fit_many(dx, df, plan=plan, **kw))
    fi_d = wtt.fit_many(dx, df, plan=plan, **kw).fi
    ho = torch.empty(fi_d.shape, dtype=torch.float64, pin_memory=True)
    d2h_ms, _ = _time_ms(lambda: ho.copy_(fi_d, non_blocking=True))
    chunks = B_STREAM // n
    up_bytes, down_bytes = (hx.numel() + hf.numel()) * 8, ho.numel() * 8
    h2d_gbs, d2h_gbs = up_bytes / h2d_ms / 1e6, down_bytes / d2h_ms / 1e6
    serial_ms = (h2d_ms + fit_ms + d2h_ms) * chunks
    bound_ms = max(up_bytes * chunks / h2d_gbs / 1e6, down_bytes * chunks / d2h_gbs / 1e6)
    del hx, hf, dx, df, fi_d, ho
    line = {"path": "stream", "device": smi, "B": B_STREAM, "chunk": CHUNK_STREAM,
            "cloud_s": cloud_s, "first_stream_s": first_s, "stream_s": stream_s,
            "fits_per_s": B_STREAM / stream_s,
            "serial_sum_ms": serial_ms, "overlap": serial_ms / (stream_s * 1e3),
            "chunk_h2d_ms": h2d_ms, "chunk_fit_ms": fit_ms, "chunk_d2h_ms": d2h_ms,
            "h2d_GB_s": h2d_gbs, "d2h_GB_s": d2h_gbs, "pcie_bound_ms": bound_ms,
            "pcie_bound_fits_per_s": B_STREAM / bound_ms * 1e3,
            "resident_fit_many_2^23_fits_per_s": B_MAIN / resident_ms * 1e3,
            "per_chunk_bit_equal": equal, "parity_vs_scipy": scipy_err,
            "launches": launches, "route": plan.route.path,
            "assembly": plan.route.assembly, "moment_key_max": float(keys.max()),
            "moment_key_edge": edge, "cases_over_moment_edge": int((keys > edge).sum()),
            "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}
    print(json.dumps(line), flush=True)
    if not equal:
        raise RuntimeError("fit_stream differs from fit_many(plan=) on a chunk")
    if scipy_err > PARITY:
        raise RuntimeError("fit_stream parity against scipy %.3e > %.0e" % (scipy_err, PARITY))
    return (xk, fk, out, keys), launches


def phase_sharded(dev, wtt, smi, idx_np, ibvp_plan, stream):
    """The sharded layer on one card: ``sharded_fit_pallas`` (headline at
    2^22) on D = 1 and on 4 logical shards of the card, bit-equal to the
    one-device call; ``sharded_fit_many`` (the engine, at 2^20: its
    one-device call at 2^22 would not fit beside its temporaries) bit-equal
    to the engine on each shard's cases, and to 1e-10 of the one-device
    call (cuBLAS's batched gemv computes the rows past 16 x 65,535 of a
    2^20 call with another kernel: the last shard differs in the last bits);
    ``sharded_gather_values`` with the plan on the IBVP cloud, D = 1 and 4,
    bit-equal to ``gather_rows`` (each shard launches the gather kernel);
    ``fit_stream(mesh=[card] * 4)`` on the 2^24 cloud under the one-device
    stream's plan, bit-equal to that stream, and under its own plan, held to
    1e-10 of scipy on the 1,024 cases with the largest moment keys and of
    the one-device stream on every case.  Returns the launches of the path
    (D = 4)."""
    from wlsqm_tpu_torch.fitter import engine
    from wlsqm_tpu_torch.ops import fit_kernel, gather
    from wlsqm_tpu_torch.parallel import sharding

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(91)
    xk, fk, nk, xi = _cloud(B_SHARD, gen, dev)
    kw = dict(dimension=2, order=ORDER, weighting=wtt.WEIGHT_CENTER)
    one_ms, one = _events_ms(lambda: fit_kernel.fit_kernel(xk, fk, nk, xi, **kw))
    meshes = {D: sharding.make_mesh(devices=[dev] * D) for D in (1, 4)}
    line = {"path": "sharded", "device": smi, "B_kernel": B_SHARD, "B_engine": B_SHARD_ENGINE,
            "N_gather": N_IBVP}
    equal = {}
    for D, mesh in meshes.items():
        got = sharding.join(sharding.sharded_fit_pallas(mesh, xk, fk, nk, xi, **kw))
        equal["fit_pallas_D%d" % D] = torch.equal(got, one)
        line["fit_pallas_D%d_ms" % D] = _time_ms(
            lambda: sharding.sharded_fit_pallas(mesh, xk, fk, nk, xi, **kw))[0]
    line["fit_kernel_ms"] = _time_ms(lambda: fit_kernel.fit_kernel(xk, fk, nk, xi, **kw))[0]
    del one, got

    s = slice(0, B_SHARD_ENGINE)
    Be = B_SHARD_ENGINE
    args = (xk[s], fk[s], nk[s], xi[s], xk.new_zeros((Be, 15)),
            torch.full((Be,), ORDER, dtype=torch.int32, device=dev),
            torch.zeros(Be, dtype=torch.int64, device=dev),
            torch.full((Be,), wtt.WEIGHT_CENTER, dtype=torch.int32, device=dev))
    ekw = dict(dimension=2, NO=15)
    ref = engine.fit_batch(*args, **ekw)[0]
    for D, mesh in meshes.items():
        ms, got = _events_ms(lambda: sharding.sharded_fit_many(mesh, *args, **ekw)[0])
        # the engine on each shard's cases in turn, on the default stream: what
        # the streams and threads must not change
        own = torch.cat([engine.fit_batch(*a, **ekw)[0] for a in zip(
            *(torch.tensor_split(t, D) for t in args))])
        got = sharding.join(got)
        equal["fit_many_D%d" % D] = torch.equal(got, own)
        line["fit_many_D%d_bit_equal_to_one_device" % D] = torch.equal(got, ref)
        line["fit_many_D%d_vs_one_device" % D] = _rel(got, ref)
        line["fit_many_D%d_ms" % D] = ms
    line["engine_one_device_ms"] = _events_ms(lambda: engine.fit_batch(*args, **ekw))[0]
    del ref, got, own, args, xk, fk, nk, xi
    torch.cuda.empty_cache()

    idx = torch.from_numpy(idx_np).to(dev)
    u = torch.randn((N_IBVP,), generator=gen, device=dev, dtype=torch.float64)
    ref = gather.gather_rows(u, idx, ibvp_plan)
    for D, mesh in meshes.items():
        got = sharding.join(sharding.sharded_gather_values(mesh, u, idx, plan=ibvp_plan))
        equal["gather_D%d" % D] = torch.equal(got.view(torch.int64), ref.view(torch.int64))
        line["gather_D%d_ms" % D] = _time_ms(
            lambda: sharding.sharded_gather_values(mesh, u, idx, plan=ibvp_plan))[0]
    line["gather_rows_ms"] = _time_ms(lambda: gather.gather_rows(u, idx, ibvp_plan))[0]
    del ref, got

    # the path as a user drives it, counted: four logical shards throughout
    xk_np, fk_np, out1, keys = stream
    gen = torch.Generator(device=dev).manual_seed(91)
    xk, fk, nk, xi = _cloud(B_SHARD, gen, dev)
    out4, out4d = np.empty_like(out1), np.empty_like(out1)
    out4.fill(0.0)
    out4d.fill(0.0)
    mesh = meshes[4]
    skw = dict(chunk=CHUNK_STREAM, mesh=mesh, order=ORDER, weighting=wtt.WEIGHT_CENTER)
    _zero_launches()
    sharding.sharded_fit_pallas(mesh, xk, fk, nk, xi, **kw)
    sharding.sharded_gather_values(mesh, u, idx, plan=ibvp_plan)
    # the one-device stream's plan (a mesh plans on 16,384 cases, which may name
    # the other body: both certified, other bits) ...
    plan = wtt.plan_fit_many(xk_np[:CHUNK_STREAM], order=ORDER, weighting=wtt.WEIGHT_CENTER)
    t0 = time.perf_counter()
    wtt.fit_stream(xk_np, fk_np, out=out4, plan=plan, **skw)
    line["stream_mesh4_s"] = time.perf_counter() - t0
    # ... and the mesh's own plan, as a user gets it
    t0 = time.perf_counter()
    wtt.fit_stream(xk_np, fk_np, out=out4d, **skw)
    line["stream_mesh4_default_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = _kernel_launches()
    equal["stream_mesh4"] = bool(np.array_equal(out4, out1))
    line["bit_equal"] = equal
    # the default mesh stream replays its 16,384-case plan over every case: held
    # to scipy on the B_SCIPY cases with the largest moment keys, and to the
    # one-device stream everywhere
    mplan = wtt.plan_fit_many(xk_np[:16384], order=ORDER, weighting=wtt.WEIGHT_CENTER)
    top = np.sort(np.argpartition(keys, -B_SCIPY)[-B_SCIPY:])
    line["stream_mesh4_default_route"] = str(mplan.route)
    line["stream_mesh4_default_top_keys"] = [float(keys[top].min()), float(keys[top].max())]
    line["stream_mesh4_default_top_key_vs_scipy"] = parity_check(
        xk_np[top], fk_np[top], out4d[top])
    line["stream_top_key_vs_scipy"] = parity_check(xk_np[top], fk_np[top], out1[top])
    line["stream_mesh4_default_vs_stream"] = float(
        max(_rel_rows(out4d[lo:lo + CHUNK_STREAM], out1[lo:lo + CHUNK_STREAM]).max()
            for lo in range(0, B_STREAM, CHUNK_STREAM)))
    line["launches"] = launches
    line["peak_mem_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
    print(json.dumps(line), flush=True)
    if not all(equal.values()):
        raise RuntimeError("a sharded call differs from the one-device call: %s" % (equal,))
    worst = max(line["fit_many_D%d_vs_one_device" % D] for D in meshes)
    if worst > PARITY:
        raise RuntimeError("sharded_fit_many %.3e off the one-device engine" % worst)
    worst = max(line["stream_mesh4_default_top_key_vs_scipy"],
                line["stream_mesh4_default_vs_stream"])
    if worst > PARITY:
        raise RuntimeError("the default mesh stream is %.3e off scipy or the stream" % worst)
    if launches["gather_rows"] != 4 or launches["fit_moment"] < 4:
        raise RuntimeError("the sharded path did not launch the kernels per shard: %s"
                           % (launches,))
    return launches


def phase_serialization(dev, wtt):
    """A Prepared of 2^16 order-4 cases to an npz file and back (the JAX
    package's layout), and through the torch.save pair: solve after loading
    is bit-equal."""
    import shutil

    from wlsqm_tpu_torch.utils import serialization

    gen = torch.Generator(device=dev).manual_seed(101)
    xk, fk, nk, xi = _cloud(B_SERIAL, gen, dev)
    prep = wtt.prepare(xk, xi, order=ORDER, weighting=wtt.WEIGHT_CENTER)
    fi1, sens1 = wtt.solve(prep, fk, do_sens=True)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    line = {"path": "serialization", "B": B_SERIAL}
    try:
        for name, save, load in (
                ("npz", serialization.save_prepared, serialization.load_prepared),
                ("torch", serialization.save_prepared_torch, serialization.load_prepared_torch)):
            path = os.path.join(root, "prepared." + name)
            t0 = time.perf_counter()
            save(path, prep)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = load(path)
            load_s = time.perf_counter() - t0
            fi2, sens2 = wtt.solve(back, fk, do_sens=True)
            line[name] = {"save_s": save_s, "load_s": load_s,
                          "file_mb": os.path.getsize(path) / 1e6,
                          "device": str(back.c.device),
                          "bit_equal": torch.equal(fi1, fi2) and torch.equal(
                              sens1.nan_to_num(), sens2.nan_to_num())}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(line), flush=True)
    if not all(line[n]["bit_equal"] and line[n]["device"].startswith("cuda")
               for n in ("npz", "torch")):
        raise RuntimeError("a Prepared did not round-trip bit for bit: %s" % (line,))


def phase_warmup(dev, wtt):
    """``warmup()`` with its default configurations: in this process, where
    the libraries are built and loaded (warm), and in a fresh interpreter,
    which loads the built libraries and launches every instance for the first
    time (cold; the nvcc builds themselves are ``phase_build``'s).  Returns
    the launches of the warm call."""
    _zero_launches()
    t0 = time.perf_counter()
    reports = wtt.warmup()
    warm_s = time.perf_counter() - t0
    launches = _kernel_launches()
    code = ("import json, time; t0 = time.perf_counter(); import wlsqm_tpu_torch as w; "
            "r = w.warmup(); print(json.dumps({'s': time.perf_counter() - t0, "
            "'launches': [x['launches'] for x in r]}))")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    cold_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError("warmup in a fresh interpreter failed:\n" + proc.stderr[-4000:])
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    line = {"path": "warmup", "warm_s": warm_s, "cold_process_wall_s": cold_wall,
            "cold_warmup_s": cold["s"], "launches": launches,
            "configs": [{k: r[k] for k in ("config", "path", "assembly", "compile_s", "run_s",
                                          "launches")} for r in reports]}
    print(json.dumps(line), flush=True)
    for rep in reports:
        n = rep["launches"]
        if (n["fit_moment"] + n["fit_rows"] < 2
                or n["cond_estimate@fit_moment"] + n["cond_estimate@fit_rows"] < 1):
            raise RuntimeError("warmup did not launch a configuration's instances: %s" % rep)
    if cold["launches"] != [r["launches"] for r in reports]:
        raise RuntimeError("the fresh interpreter's warmup launched otherwise: %s" % cold)
    return launches


def phase_kdtree(pts, idx_np, setup):
    """The native k-d tree on the IBVP cloud (2^22 points, K = 28): build
    and query seconds beside scipy's cKDTree on all cores, with equal
    neighbour sets (and equal to the IBVP set-up's, which used it)."""
    import scipy.spatial

    from wlsqm_tpu_torch import native
    from wlsqm_tpu_torch.utils import neighbors

    if not native.available():
        raise RuntimeError("the native k-d tree is not available on this machine")
    if not isinstance(neighbors.host_tree(pts[:16]), native.KDTree):
        raise RuntimeError("host_tree did not pick the native tree")
    t0 = time.perf_counter()
    tree = native.KDTree(pts)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, idx_n = tree.query(pts, k=K_IBVP)
    query_s = time.perf_counter() - t0
    del tree
    t0 = time.perf_counter()
    st = scipy.spatial.cKDTree(pts)
    sbuild_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, idx_s = st.query(pts, k=K_IBVP, workers=-1)
    squery_s = time.perf_counter() - t0
    del st
    same = bool(np.array_equal(np.sort(idx_n, 1), np.sort(idx_s, 1)))
    same_setup = bool(np.array_equal(idx_n.astype(np.int32), idx_np))
    line = {"path": "kdtree", "n": len(pts), "k": K_IBVP, "cores": os.cpu_count(),
            "native_build_s": build_s, "native_query_s": query_s,
            "scipy_build_s": sbuild_s, "scipy_query_s": squery_s,
            "ibvp_setup_knn_s": setup["knn_host_s"],
            "neighbour_sets_equal": same, "equal_to_setup": same_setup}
    print(json.dumps(line), flush=True)
    if not (same and same_setup):
        raise RuntimeError("the native tree's neighbours differ from scipy's: %s" % (line,))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1
    import wlsqm_tpu_torch as wtt

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
    phase_moment_scale(dev)
    m_abs, m_rel = phase_moment_vs_plain(dev, wtt)
    r_abs, r_rel = phase_rows_vs_plain(dev, wtt)
    phase_iterative_counts(dev)
    cond = phase_cond_vs_plain(dev, wtt)
    phase_calibrate()
    phase_radius_sweep(dev, wtt)
    torch.cuda.empty_cache()
    moment = phase_headline(dev, wtt)
    torch.cuda.empty_cache()
    iterative = phase_iterative(dev, wtt)
    torch.cuda.empty_cache()
    sens = phase_sens(dev, wtt)
    torch.cuda.empty_cache()
    dim3, dim3_rows = phase_dim3(dev, wtt)
    torch.cuda.empty_cache()
    dim3_thread, dim3_thread_rows = phase_dim3_thread(dev, wtt)
    torch.cuda.empty_cache()
    dim1, dim1_iterative, dim1_key_ms, dim1_launches = phase_dim1(dev, wtt)
    torch.cuda.empty_cache()
    cert_launches = phase_certified(dev, wtt)
    torch.cuda.empty_cache()
    phase_certified_moments(dev, wtt)
    torch.cuda.empty_cache()
    pts, idx_np, plan, setup = ibvp_setup()
    g_abs = phase_gather_vs_plain(dev, idx_np, plan)
    ibvp = phase_ibvp(dev, wtt, pts, idx_np, plan, setup)
    torch.cuda.empty_cache()
    phase_heat_example(dev)
    torch.cuda.empty_cache()
    euler, euler_gather = phase_euler(dev, wtt, smi.splitlines()[0], ibvp)
    torch.cuda.empty_cache()
    adjoint, adjoint_rows = phase_adjoint(dev, wtt, smi.splitlines()[0])
    torch.cuda.empty_cache()
    examples = phase_examples(dev, smi.splitlines()[0])
    torch.cuda.empty_cache()
    expert = phase_expert(dev, wtt, smi.splitlines()[0])
    torch.cuda.empty_cache()
    compat = phase_compat(dev, wtt, smi.splitlines()[0])
    torch.cuda.empty_cache()
    grad = phase_grad(dev, wtt)
    torch.cuda.empty_cache()
    stream, stream_launches = phase_stream(dev, wtt, smi.splitlines()[0],
                                           moment["route_ms_2^23"])
    torch.cuda.empty_cache()
    sharded = phase_sharded(dev, wtt, smi.splitlines()[0], idx_np, plan, stream)
    del stream
    torch.cuda.empty_cache()
    phase_serialization(dev, wtt)
    warm = phase_warmup(dev, wtt)
    phase_kdtree(pts, idx_np, setup)
    by_path = {"headline": _launches(moment=moment["launches"]),
               "sens": _launches(rows=sens["launches"]),
               "iterative": _launches(moment=iterative["launches"]),
               "dim3": _launches(moment=dim3["launches"]),
               "dim3_thread": _launches(moment=dim3_thread["launches"]),
               "dim1": dim1_launches,
               "expert": expert, **compat, "grad": grad, "stream": stream_launches,
               "sharded": sharded, "warmup": warm, "euler": euler, "adjoint": adjoint,
               "examples": examples}

    def entry(name, source, replaces, abs_err, rel_err, t, config, batch=B_PLAIN, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": t["launches"], "max_abs_err": abs_err, "max_rel_err": rel_err,
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "batch": batch, "config": config, **extra}

    print(json.dumps({"kernels": [
        entry("fit_moment", "wlsqm_tpu_torch/csrc/fit_moment.cu",
              "wlsqm_tpu/ops/pallas_fit.py:438", m_abs, m_rel, moment,
              "headline: 2D order 4 K=30 CENTER (the thread body); max_abs_err over "
              "dims 1-3, orders 0-4, knowns, max_iter",
              launches_by_path={p: n["fit_moment"] for p, n in by_path.items()}),
        entry("fit_moment@iterative", "wlsqm_tpu_torch/csrc/fit_moment.cu",
              "wlsqm_tpu/ops/pallas_fit.py:438", m_abs, m_rel, iterative,
              "iterative: 2D order 4 K=30 CENTER max_iter=3 (the thread body with "
              "ALGO_ITERATIVE); ms_full: the launch at 2^23",
              ms_full=iterative["launch_ms_full"], route_ms_full=iterative["route_ms_full"]),
        entry("fit_moment@dim3", "wlsqm_tpu_torch/csrc/fit_moment.cu",
              "wlsqm_tpu/ops/pallas_fit.py:438", m_abs, m_rel, dim3,
              "dim3: 3D order 4 K=48 CENTER (the warp body); ms_full: the launch at 2^21; "
              "rows_*: the rows kernel (warp body) timed beside it on the same cloud "
              "through a plan naming the rows body (rows_ms_full: its launch at 2^21)",
              ms_full=dim3["launch_ms_full"], route_ms_full=dim3["route_ms_full"],
              **{"rows_" + k: dim3_rows[k] for k in ("ms", "plain_ms", "bound_ms",
                                                      "library_ms")},
              rows_ms_full=dim3_rows["launch_ms_full"]),
        entry("fit_moment@dim1", "wlsqm_tpu_torch/csrc/fit_moment.cu",
              "wlsqm_tpu/ops/pallas_fit.py:438", m_abs, m_rel,
              dict(dim1, launches=dim1_launches["fit_moment"]),
              "dim1: 1D order 4 K=15 UNIFORM (the reference's configuration 3, 1D half; the "
              "thread body's basic instance); ms_full: the launch at 2^23; ms_full_key: the "
              "launch with the key (what the certified route runs); iterative_*: max_iter=3 "
              "(its ALGO_ITERATIVE instance, what the data-gated iterative route runs)",
              ms_full=dim1["launch_ms_full"], route_ms_full=dim1["route_ms_full"],
              ms_full_key=dim1_key_ms, bound_ms_full=dim1["bound_ms_full"],
              **{"iterative_" + k: dim1_iterative[k] for k in (
                  "ms", "plain_ms", "library_ms", "bound_ms", "launch_ms_full",
                  "bound_ms_full", "route_ms_full")}),
        entry("fit_moment@dim3_thread", "wlsqm_tpu_torch/csrc/fit_moment.cu",
              "wlsqm_tpu/ops/pallas_fit.py:438", m_abs, m_rel, dim3_thread,
              "dim3_thread: 3D order 2 K=48 CENTER (the thread body's basic instance); "
              "ms_full: the launch at 2^21; rows_*: the rows kernel (thread body) timed "
              "beside it on the same cloud through a plan naming the rows body "
              "(rows_ms_full: its launch at 2^21)",
              ms_full=dim3_thread["launch_ms_full"], route_ms_full=dim3_thread["route_ms_full"],
              bound_ms_full=dim3_thread["bound_ms_full"],
              **{"rows_" + k: dim3_thread_rows[k] for k in ("ms", "plain_ms", "bound_ms",
                                                             "library_ms")},
              rows_ms_full=dim3_thread_rows["launch_ms_full"]),
        entry("fit_rows", "wlsqm_tpu_torch/csrc/fit_rows.cu",
              "wlsqm_tpu/ops/pallas_fit.py:901", r_abs, r_rel, sens,
              "sens: 2D order 4 K=30 CENTER do_sens (warp body)",
              launches_by_path={p: n["fit_rows"] for p, n in by_path.items()}),
        entry("fit_rows@adjoint", "wlsqm_tpu_torch/csrc/fit_rows.cu",
              "wlsqm_tpu/ops/pallas_fit.py:901", r_abs, r_rel,
              {"launches": adjoint["fit_rows"], "ms": adjoint_rows["median_ms"]["launch"],
               "plain_ms": adjoint_rows["median_ms"]["plain"],
               "library_ms": adjoint_rows["median_ms"]["library_lstsq"],
               **adjoint_rows["bound"]},
              "adjoint step: 2D order 2 K=12 CENTER do_sens (the thread body), its "
              "1024 x 1024 grid; wrapper_ms: fit_rows around the launch",
              batch=adjoint_rows["B"],
              wrapper_ms=adjoint_rows["median_ms"]["fit_rows_wrapper"]),
        entry("gather_rows", "wlsqm_tpu_torch/csrc/gather.cu",
              "wlsqm_tpu/ops/gather.py:168", g_abs, 0.0, ibvp,
              "IBVP step: n=2^22, K=28, f64, F=1 (ms_F3, library_ms_F3, bound_ms_F3: "
              "F=3); launches over %d steps, library torch.index_select; *_euler: the "
              "Euler step's gather, n=2^22, K=24, F=8 f64 (word_instance_ms_euler: the "
              "word instance on the same rows)" % STEPS,
              batch=N_IBVP, **{k: ibvp[k] for k in ("ms_F3", "library_ms_F3", "bound_ms_F3",
                                                    "launches_F3")},
              ms_euler=euler_gather["launch_ms"], bound_ms_euler=euler_gather["bound"]["bound_ms"],
              library_ms_euler=euler_gather["library_ms"],
              word_instance_ms_euler=euler_gather["word_instance_ms"],
              launches_by_path={p: n["gather_rows"] for p, n in by_path.items()}),
        *(entry("cond_estimate@" + kernel, "wlsqm_tpu_torch/csrc/%s.cu" % src,
                "wlsqm_tpu/ops/pallas_fit.py:382", t["max_abs_err"], t["max_rel_err"],
                dict(t, launches=cert_launches["cond_estimate@" + kernel]),
                "the launch with the key: 2D order 4 K=30 CENTER basic; launches on "
                "the certified route (the rows body: its split on the known-DOF "
                "batch); library condprobe.cond_key",
                launches_by_path={p: n["cond_estimate@" + kernel]
                                  for p, n in by_path.items()})
          for kernel, src, t in (("fit_moment", "fit_moment", cond["moments"]),
                                 ("fit_rows", "fit_rows", cond["rows"]))),
    ], "total_s": round(time.perf_counter() - t_start, 1)}),
        flush=True)
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
