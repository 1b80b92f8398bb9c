"""Readings that set a cell's limits: the program's numbers on many seeds and
the control's on a few, in one process on the card.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 2

Each seed runs the cell as ``run.py`` does (set-up, a short window at the
cell's own load, the check) and prints one JSON line with the numbers the
check compares.  With ``--control-seeds`` the reference computed in float32
(the precision below the configuration's float64) is judged in the
program's place on the same inputs: it has to fail a limit.  The benchmark's
own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload, seeds, judge, seconds, device, overrides=None):
    """Yield (seed, checks, result) for each seed."""
    import torch

    from bench_port import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in seeds:
        cell = harness.load_cell(workload)
        ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, traced=False,
                              device=device, t_start=time.perf_counter(), judge=judge,
                              overrides=overrides or {})
        out = harness.run(ctx)
        out["notes"] = ctx.notes
        yield seed, {k: c["value"] for k, c in out["checks"].items()}, out
        del ctx, out
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from bench_port import harness

    device = harness.device_or_exit(harness.load_cell(args.workload).chips)
    for judge, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed, checks, out in readings(args.workload, [int(s) for s in seeds.split(",") if s],
                                          judge, args.seconds, device):
            print(json.dumps({"workload": args.workload, "judge": judge, "seed": seed,
                              "checks": checks, "correct": out["correct"],
                              "attempted": out["attempted"], "notes": out["notes"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
