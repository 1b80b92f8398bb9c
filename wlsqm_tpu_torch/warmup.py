"""Pre-building and warming the CUDA kernels: make the first call's cost a
managed one.

Port of :mod:`wlsqm_tpu.warmup`.  The JAX package pre-compiles its Pallas
kernels per static configuration.  Here the kernels are nine nvcc libraries
built at a kernel's first use (:mod:`wlsqm_tpu_torch.native`: the moment
kernel's per dimension and the rows kernel's, each without and with its
conditioning key, and the gather), one to two minutes of nvcc together (and the host k-d tree, a few seconds of g++), after which a configuration's first launch costs only the
loading of its instance.  :func:`warmup` builds them all (one compiler run
each, started together), then runs each configuration through ``plan_fit_many``
+ ``fit_many(plan=)`` and launches the configuration's kernel body once
without and once with the key, so that a service's first production call
finds everything built and loaded.  The libraries persist under
``build/wlsqm_tpu_torch/``; a later process loads them without building.

Typical use::

    import wlsqm_tpu_torch as wtt

    reports = wtt.warmup()                 # the reference's benchmark configurations
    # -> [{'config': ..., 'route': ..., 'compile_s': ..., 'run_s': ...}, ...]

A config may carry a :class:`wlsqm_tpu_torch.api.FitPlan` (``plan=``) or
representative geometry (``xk=``, ``xi=``, ``nk=``) from which the
production route is planned; an explicit ``assembly`` / ``refine_steps``
(or the JAX package's ``precision``, which computes in f64 here) runs the
kernel body directly instead.  On a CPU device (``device="cpu"``) nothing is
built: the configurations run the kernels' plain versions.
"""

from __future__ import annotations

import concurrent.futures
import functools
import time

import numpy as np
import torch

__all__ = ["warmup", "launch_counts", "DEFAULT_CONFIGS"]

#: the JAX package's benchmark-suite configurations (headline, iterative,
#: sens, 3D, and the moment body in 3D)
DEFAULT_CONFIGS = (
    dict(dimension=2, order=4, K=30),
    dict(dimension=2, order=4, K=30, iterative=True),
    dict(dimension=2, order=4, K=30, do_sens=True),
    dict(dimension=3, order=4, K=48),
    dict(dimension=3, order=4, K=48, assembly="moments"),
)

#: cases per warm-up call
BATCH = 1024


def _representative_cloud(rng, B, K, dimension):
    """A well-conditioned random cloud for planning and launching."""
    xi = rng.uniform(-1.0, 1.0, (B, dimension))
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (B, K, dimension))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., -1])
    return xk, fk, xi


def build_all() -> dict:
    """Build (or load) the nine nvcc libraries and the host k-d tree, one
    compiler run each, started together.  Returns {library: its
    :class:`wlsqm_tpu_torch.native.Library`} (the tree None where there is
    no g++); a failed build raises."""
    from wlsqm_tpu_torch import native
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows, gather

    jobs = {"fit_moment_d%d%s" % (d, "_cond" if c else ""):
            functools.partial(fit_kernel.load, d, c) for d in (1, 2, 3) for c in (False, True)}
    jobs.update({"fit_rows": lambda: fit_rows.load(False),
                 "fit_rows_cond": lambda: fit_rows.load(True),
                 "gather": gather.load, "kdtree": native.load})
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def launch_counts() -> dict:
    """The kernels' launch counters, by kernel (the fit kernels' launches
    with the key apart): ``fit_moment``, ``fit_rows``,
    ``cond_estimate@fit_moment``, ``cond_estimate@fit_rows``,
    ``gather_rows``."""
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows, gather

    return {"fit_moment": fit_kernel.LAUNCHES, "fit_rows": fit_rows.LAUNCHES,
            "cond_estimate@fit_moment": fit_kernel.COND_LAUNCHES,
            "cond_estimate@fit_rows": fit_rows.COND_LAUNCHES,
            "gather_rows": gather.LAUNCHES}


def warmup(configs=DEFAULT_CONFIGS, *, verbose: bool = False, device=None) -> list[dict]:
    """Build the kernels and warm each configuration's route and kernel body.

    Each config is a dict with keys: dimension (required), order (default
    2), K (required unless ``xk`` is given), weighting (default
    WEIGHT_CENTER), knowns (default 0), do_sens / iterative / max_iter
    (defaults off); assembly ("auto", "moments", "rows"), refine_steps,
    precision — an explicit kernel body, run directly; plan (a
    :class:`wlsqm_tpu_torch.api.FitPlan`) or xk / xi / nk (representative
    geometry) — warm the route production would take.

    On a card every library is built first (a failure raises).  Returns one
    report per config: ``config`` (echo), ``route`` (str), ``path``,
    ``assembly`` (the kernel body launched), ``compile_s`` (the first
    call's wall time), ``run_s`` (the second call's), ``cached``
    (``compile_s`` close to ``run_s``) and ``launches`` (the kernel launches
    the config made).  A launch failure raises.
    """
    from wlsqm_tpu_torch import api, config
    from wlsqm_tpu_torch.fitter import defs
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    device = config.resolve_device(device)
    cuda = device.type == "cuda"
    if cuda:
        t0 = time.perf_counter()
        built = build_all()
        if verbose:
            print("warmup: libraries built in %.1f s: %s" % (
                time.perf_counter() - t0, {k: v and v.build_seconds for k, v in built.items()}),
                flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(0)
    reports = []
    for cfg in configs:
        cfg = dict(cfg)
        dimension = int(cfg.get("dimension", 2))
        order = int(cfg.get("order", 2))
        weighting = int(cfg.get("weighting", defs.WEIGHT_CENTER))
        knowns = int(cfg.get("knowns", 0))
        do_sens = bool(cfg.get("do_sens", False))
        iterative = bool(cfg.get("iterative", False))
        max_iter = int(cfg.get("max_iter", 10))
        if cfg.get("xk") is not None:
            xk = np.asarray(cfg["xk"], np.float64)
            if xk.ndim == 2:
                xk = xk[:, :, None]
            xi = (np.asarray(cfg["xi"], np.float64) if cfg.get("xi") is not None
                  else np.zeros((xk.shape[0], dimension)))
            fk = np.sin(xk[..., 0]) * np.cos(xk[..., -1])
            nk = cfg.get("nk")
        else:
            xk, fk, xi = _representative_cloud(rng, BATCH, int(cfg["K"]), dimension)
            nk = None
        B, K = xk.shape[:2]
        t = {k: config.as_tensor(v, device) for k, v in (("xk", xk), ("fk", fk), ("xi", xi))}
        t["nk"] = (torch.full((B,), K, dtype=torch.int32, device=device) if nk is None
                   else config.as_tensor(nk, device, torch.int32))

        want = cfg.get("assembly")
        want = None if want in (None, "auto") else want
        # an explicit body is forced, as fit_pallas(assembly=) is; else the
        # body the certified route would take
        assembly = (api._assembly(dimension, order, knowns, weighting, do_sens, want,
                                  forced=want is not None)
                    or api._assembly(dimension, order, knowns, weighting, do_sens))
        plan = cfg.get("plan")
        explicit = any(cfg.get(k) is not None for k in ("precision", "assembly",
                                                        "refine_steps"))
        if plan is None and not explicit:
            plan = api.plan_fit_many(xk, xi, nk=nk, order=order, knowns=knowns,
                                     weighting=weighting, do_sens=do_sens,
                                     iterative=iterative, device=device)
        rs = cfg.get("refine_steps")
        rs = fit_kernel.DEFAULT_REFINE_STEPS if rs is None else int(rs)

        def body(emit_cond):
            fi0 = t["xk"].new_zeros((B, defs.number_of_dofs(dimension, order)))
            kw = dict(dimension=dimension, order=order, weighting=weighting, knowns=knowns,
                      refine_steps=rs, max_iter=max_iter if iterative else 0,
                      emit_cond=emit_cond)
            if assembly == "moments":
                fit_kernel.fit_kernel(t["xk"], t["fk"], t["nk"], t["xi"], fi0, **kw)
            elif assembly == "rows":
                fit_rows.fit_rows(t["xk"], t["fk"], t["nk"], t["xi"], fi0, do_sens=do_sens,
                                  **kw)

        def run():
            if plan is not None:
                api.fit_many(t["xk"], t["fk"], t["xi"], nk=t["nk"], order=order,
                             knowns=knowns, weighting=weighting, do_sens=do_sens,
                             iterative=iterative, max_iter=max_iter, plan=plan,
                             device=device)
            body(False)
            body(True)
            sync()

        before = launch_counts()
        t0 = time.perf_counter()
        run()
        compile_s = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        t0 = time.perf_counter()
        run()
        run_s = time.perf_counter() - t0
        rep = dict(config={k: v for k, v in cfg.items() if k not in ("xk", "xi", "nk", "plan")},
                   route=str(plan) if plan is not None else "kernel(f64, %s)" % assembly,
                   path=plan.route.path if plan is not None else "kernel",
                   assembly=assembly, compile_s=compile_s, run_s=run_s,
                   cached=compile_s < 3 * run_s + 1.0, launches=launches)
        reports.append(rep)
        if verbose:
            print("warmup %-60s %7.2fs (steady %.3fs)" % (rep["route"], compile_s, run_s),
                  flush=True)
    return reports


def main() -> None:  # pragma: no cover - thin CLI
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="Build the wlsqm_tpu_torch CUDA kernels and warm their routes")
    ap.add_argument("--configs", default=None,
                    help="path to a JSON list of config dicts "
                         "(default: the benchmark-suite set)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    configs = DEFAULT_CONFIGS
    if args.configs:
        with open(args.configs) as f:
            configs = json.load(f)
    print(json.dumps(warmup(configs, verbose=True, device=args.device), indent=1))


if __name__ == "__main__":  # pragma: no cover
    main()
