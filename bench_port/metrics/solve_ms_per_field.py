"""Milliseconds of ``api.solve`` a field: the benchmark's span around each
call (CUDA events in stream order), its mean over the calls, over the mean
fields a call that the program counts at ``engine.solve_fields`` (F for an
(F, B, K) right-hand side, 1 for (B, K)) over its ``engine.solve`` calls.
The mean over the span's own calls leaves out how many of them fell before
the window (the stepper's warm-up): every call of a cell has one size.  None
where the program has no such counter."""

from bench_port.lib import program


def read(ctx):
    calls = len(ctx.spans._events.get("api.solve", ()))
    total = ctx.spans.totals().get("api.solve")
    fields = program.counters(ctx).get("engine.solve_fields")
    solves = program.spans(ctx).get("engine.solve", {}).get("calls")
    if not calls or total is None or not fields or not solves:
        return None
    return 1e3 * (total / calls) / (fields / solves)
