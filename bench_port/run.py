"""Run one cell of the port's benchmark on the card and print its result.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``wlsqm_tpu_torch``, on a machine
with the CUDA cards the cell asks for (without them it exits non-zero and
prints no result).  Set-up (imports, kernel libraries from the build
directory, inputs from the seed, the cell's own warm-up) is timed from the
first line of this file to the window's start; then the window runs for
``--seconds``.  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a traced window.  After the window
the outputs are held against the plain reference; each number compared is
printed with its limit as the last lines of standard error and, under
``checks``, last in the result, the last line of standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache of the program at a fixed path inside the checkout; the
    # kernel libraries build into <checkout>/build/wlsqm_tpu_torch
    cache = os.path.join(ROOT, "build", "bench_port_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_KERNEL_CACHE_PATH"] = os.path.join(cache, "torch_kernels")
    sys.path.insert(0, ROOT)

    from bench_port import harness

    cell = harness.load_cell(args.workload)
    device = harness.device_or_exit(cell.chips)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          traced=bool(args.trace), device=device, t_start=T_START)
    out = harness.run(ctx)
    bad = harness.forbidden_loaded()
    if bad:
        print("bench_port: the run's process loaded %s" % ", ".join(bad), file=sys.stderr)
        return 3
    print("bench_port: %s seed %d trace %d: window %s, counts %s, values %s, notes %s"
          % (args.workload, args.seed, args.trace, ctx.counts.get("window_s"),
             {k: v for k, v in ctx.counts.items() if k != "window_s"}, ctx.values, ctx.notes),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]), file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
