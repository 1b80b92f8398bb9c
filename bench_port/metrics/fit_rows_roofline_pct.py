"""The share of its roofline that K2 (``csrc/fit_rows.cu``) reaches in the window.

The least time of the window's K2 launches (``bench_port/lib/bounds.py``
on the launch's shapes: each input read once, each output written once,
against the H100 SXM's published peaks) over K2's device time in the
profiler's trace.  None where the window has no K2 launch, no bound for it,
or no device time for it.
"""

import re

KERNEL = re.compile(r"\bfit_rows_(thread|warp)\b")


def read(ctx):
    launches = ctx.counts.get("launches", {}).get("fit_rows", 0)
    bound_s = ctx.bounds.get("fit_rows")
    summary = ctx.trace.summary or {}
    device_s = sum(s for name, s in summary.get("kernels", {}).items() if KERNEL.search(name))
    if not launches or bound_s is None or device_s <= 0:
        return None
    return 100.0 * launches * bound_s / device_s
