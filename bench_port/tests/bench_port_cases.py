"""What the benchmark's CPU tests share: each cell at a size a test run can
hold, run through the harness on the CPU (the look for a card skipped)."""

from __future__ import annotations

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402

CELLS = ("fit2d_o4_k30.planned", "fit2d_o4_k30.sens", "fit2d_o4_k30.irregular",
         "heat2d_o2_k28.step_f1")

#: the cells' sizes cut to a test's: cases a call, the planning cloud, the
#: heat cloud's points and the rows and points each check samples
TINY = {"cases": 2048, "plan_cases": 1024, "points": 4096, "sample_rows": 16,
        "sample_points": 128}


def run_cell(name: str, *, judge: str = "program", seed: int = 2**31 + 7,
             seconds: float = 0.3, overrides=None) -> tuple[dict, harness.Context]:
    """One run of a cell on the CPU at the tiny size."""
    torch.set_num_threads(1)
    cell = harness.load_cell(name)
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, traced=False,
                          device=torch.device("cpu"), t_start=time.perf_counter(),
                          judge=judge, overrides=dict(TINY, **(overrides or {})))
    return harness.run(ctx), ctx
