"""Milliseconds a call in the f64 engine's tail of the certified split: the
span around ``engine.fit_batch`` (the module attribute the route calls
through; CUDA events in stream order), summed over the window, over the
calls."""


def read(ctx):
    n = ctx.counts.get("calls", 0)
    total = ctx.spans.totals().get("engine.fit_batch")
    if not n or total is None:
        return None
    return 1e3 * total / n
