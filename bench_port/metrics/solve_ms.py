"""Milliseconds a step in ``api.solve`` on the prepared factors: the span
around the call (CUDA events in stream order), summed over the window,
over the steps."""


def read(ctx):
    n = ctx.counts.get("steps", 0)
    total = ctx.spans.totals().get("api.solve")
    if not n or total is None:
        return None
    return 1e3 * total / n
