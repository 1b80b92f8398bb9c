"""The program's own spans and counters of a traced window.

``wlsqm_tpu_torch.utils.profiling`` records spans and counters while a
``torch.profiler`` session records, and the drivers' ``Trace.start`` /
``Trace.stop`` bracket the window with one, so its registry holds the
window's spans and counters.  A program without that registry (an older
checkout) reads as empty: its metrics are then not reported.
"""

from __future__ import annotations


def _profiling(ctx):
    if not ctx.traced:
        return None
    from wlsqm_tpu_torch.utils import profiling

    if not hasattr(profiling, "totals"):
        return None
    return profiling


def spans(ctx) -> dict:
    """``{name: {"calls", "host_s", "stream_s"}}`` of the program's spans."""
    profiling = _profiling(ctx)
    return profiling.totals() if profiling else {}


def counters(ctx) -> dict:
    """``{name: total}`` of the program's counters."""
    profiling = _profiling(ctx)
    return profiling.counters() if profiling else {}


def per(ctx, unit: str, total):
    """``total`` over ``ctx.counts[unit]`` ("calls" or "steps"); None where
    either is missing."""
    n = ctx.counts.get(unit, 0)
    return None if not n or total is None else total / n


def span_sum(ctx, names, clock: str):
    """Seconds of ``clock`` ("host_s" or "stream_s") summed over the spans
    ``names``; None unless every one of them was recorded on that clock."""
    got = spans(ctx)
    if not all(n in got and got[n][clock] is not None for n in names):
        return None
    return sum(got[n][clock] for n in names)
