"""Smoke run of the PyTorch port on one NVIDIA card: build, check, time.

Drives the headline fit — 2D, order 4, K = 30, WEIGHT_CENTER, basic
algorithm, no knowns, the workload of bench.py — through the port's public
route (``plan_fit_many`` then ``fit_many(plan=)``) on 2^23 cases, after
building the moment-assembly CUDA kernel from ``wlsqm_tpu_torch/csrc`` and
checking it against its plain torch version.  Each phase prints one line;
the last line is ``{"ok": true, "device": {...}}``.  Any failed build,
launch or check raises, so the script exits non-zero and prints no result
line; so does a machine without a CUDA device.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import torch

B_MAIN = 1 << 23        # the "10M-point-scale" headline cloud of bench.py
B_CHECK = 65536         # kernel against its plain version
B_PLAIN = 1 << 18       # the plain version's (B, K, NM) intermediates cap it
B_ENGINE = 65536        # slice checked against the port's f64 engine
B_SCIPY = 1024          # slice checked against bench.parity_check (scipy f64)
K = 30
ORDER = 4
PARITY = 1e-10          # L∞ error relative to max(|ref|, 1), bench.parity_check's bar
REPS = 5                # timed repetitions after one warm-up; the median is reported


def _rel(a, b) -> float:
    """Worst per-case L∞ error relative to max(|ref|, 1)."""
    return ((a - b).abs().amax(1) / b.abs().amax(1).clamp_min(1.0)).max().item()


def _cloud(B, gen, dev, *, order=ORDER, ragged=False, offset=False):
    """The bench workload (bench.py:102-108): xk uniform in [-1, 1]^2,
    fk = sin 3x cos 2y + 0.01 noise.  ``ragged``: odd cases keep nk in
    [1.5 NO, K] with NaN in the padded slots.  ``offset``: xi off zero."""
    xk = torch.rand((B, K, 2), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
    fk = torch.sin(3.0 * xk[..., 0]) * torch.cos(2.0 * xk[..., 1])
    fk += 0.01 * torch.randn((B, K), generator=gen, device=dev, dtype=torch.float64)
    xi = torch.zeros((B, 2), device=dev, dtype=torch.float64)
    if offset:
        xi = (torch.rand((B, 2), generator=gen, device=dev, dtype=torch.float64) - 0.5) * 0.2
        xk += xi[:, None, :]
    nk = torch.full((B,), K, dtype=torch.int32, device=dev)
    if ragged:
        from wlsqm_tpu_torch.fitter import defs

        lo = (3 * defs.number_of_dofs(2, order)) // 2
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


def _ptxas_summary(log: str) -> dict:
    """Registers, stack and spill bytes of each kernel instance, from
    ``nvcc -Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"fit_moment_2dILi(\d+)ELi(\d+)E", line)
        if m and "Compiling entry function" in line:
            name = "order%s_w%s" % m.groups()
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1
    import wlsqm_tpu_torch as wtt
    from bench import parity_check
    from wlsqm_tpu_torch.ops import fit_kernel

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print("device: %s, count %d, torch %s, CUDA %s"
          % (kind, torch.cuda.device_count(), torch.__version__, torch.version.cuda))
    print(smi.splitlines()[0])

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib = fit_kernel.load()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3),
                      "nvcc_s": round(lib.build_seconds, 3), "library": lib.path,
                      "ptxas": _ptxas_summary(lib.log)}))

    # -- the kernel against its plain version ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(2026)
    worst_rel, worst_abs = 0.0, 0.0
    checks = [(ORDER, w, B_CHECK) for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER)]
    checks += [(o, w, 8191) for o in range(ORDER) for w in (wtt.WEIGHT_UNIFORM,
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
    print(json.dumps({"kernel_vs_plain_rel": per, "worst_rel": worst_rel,
                      "worst_abs": worst_abs, "tol": PARITY}))

    # -- the main path at full size ------------------------------------------
    del xk, fk, nk, xi, got, ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(42)
    xk, fk, nk, xi = _cloud(B_MAIN, gen, dev)
    plan = wtt.plan_fit_many(xk[:32768], xi[:32768], order=ORDER,
                             weighting=wtt.WEIGHT_CENTER)
    if plan.route.path != "kernel":
        raise RuntimeError("the headline plan did not route to the kernel: %s" % (plan,))
    inputs_gb = (xk.numel() + fk.numel() + xi.numel()) * 8 / 1e9
    fit_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    res = wtt.fit_many(xk, fk, xi, order=ORDER, weighting=wtt.WEIGHT_CENTER, plan=plan)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fit_kernel.LAUNCHES
    if launches < 1:
        raise RuntimeError("fit_many(plan=) did not launch the kernel")
    fi = res.fi
    if tuple(fi.shape) != (B_MAIN, 15) or not bool(torch.isfinite(fi).all()):
        raise RuntimeError("main path: bad DOFs, shape %s" % (tuple(fi.shape),))
    scipy_err = parity_check(xk[:B_SCIPY].cpu().numpy(), fk[:B_SCIPY].cpu().numpy(),
                             fi[:B_SCIPY].cpu().numpy())
    eng = wtt.fit_many(xk[:B_ENGINE], fk[:B_ENGINE], xi[:B_ENGINE], order=ORDER,
                       weighting=wtt.WEIGHT_CENTER, backend="engine").fi
    engine_err = _rel(fi[:B_ENGINE], eng)
    print(json.dumps({"main_path_B": B_MAIN, "route": plan.route.path,
                      "launches": launches, "first_call_s": round(first_s, 4),
                      "inputs_outputs_gb": round(inputs_gb + fi.numel() * 8 / 1e9, 3),
                      "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
                      "parity_vs_scipy": scipy_err, "vs_engine": engine_err,
                      "tol": PARITY}))
    if not (scipy_err <= PARITY and engine_err <= PARITY):
        raise RuntimeError("main path parity: scipy %.3e, engine %.3e > %.0e"
                           % (scipy_err, engine_err, PARITY))
    del res, eng, fi

    # -- times ---------------------------------------------------------------
    route_ms, route_t = _time_ms(lambda: wtt.fit_many(
        xk, fk, xi, order=ORDER, weighting=wtt.WEIGHT_CENTER, plan=plan))
    kernel_ms, kernel_t = _time_ms(lambda: fit_kernel.fit_kernel(
        xk, fk, nk, xi, dimension=2, order=ORDER, weighting=wtt.WEIGHT_CENTER))
    _, _, _, inv_s = fit_kernel._prescale(xk, nk, xi)
    out = torch.empty((B_MAIN, 15), dtype=torch.float64, device=dev)
    launch_ms, launch_t = _time_ms(lambda: fit_kernel._launch(
        xk, fk, nk, xi, inv_s, out, order=ORDER, weighting=wtt.WEIGHT_CENTER,
        refine_steps=fit_kernel.DEFAULT_REFINE_STEPS))
    del out, inv_s
    s = slice(0, B_PLAIN)
    small_ms, small_t = _time_ms(lambda: fit_kernel.fit_kernel(
        xk[s], fk[s], nk[s], xi[s], dimension=2, order=ORDER,
        weighting=wtt.WEIGHT_CENTER))
    plain_ms, plain_t = _time_ms(lambda: fit_kernel.fit_moments_plain(
        xk[s], fk[s], nk[s], xi[s], dimension=2, order=ORDER,
        weighting=wtt.WEIGHT_CENTER))
    print(json.dumps({
        "fits_per_s": {"fit_many_plan_2^23": B_MAIN / route_ms * 1e3,
                       "fit_kernel_2^23": B_MAIN / kernel_ms * 1e3,
                       "kernel_launch_only_2^23": B_MAIN / launch_ms * 1e3,
                       "fit_kernel_2^18": B_PLAIN / small_ms * 1e3,
                       "fit_moments_plain_2^18": B_PLAIN / plain_ms * 1e3},
        "ms": {"fit_many_plan_2^23": route_t, "fit_kernel_2^23": kernel_t,
               "kernel_launch_only_2^23": launch_t, "fit_kernel_2^18": small_t,
               "fit_moments_plain_2^18": plain_t},
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}))

    print(json.dumps({"kernels": [{
        "name": "fit_moment_2d", "route": "cuda",
        "source": "wlsqm_tpu_torch/csrc/fit_moment.cu",
        "replaces": "wlsqm_tpu/ops/pallas_fit.py:438",
        "launches": launches, "max_abs_err": worst_abs, "max_rel_err": worst_rel,
        "ms": small_ms, "plain_ms": plain_ms, "batch": B_PLAIN}]}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
