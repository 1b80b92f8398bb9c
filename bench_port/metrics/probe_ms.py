"""Milliseconds a call in the gate's conditioning probe: the span around
``condprobe.probe`` (the module attribute the route calls through; CUDA
events in stream order), summed over the window, over the calls."""


def read(ctx):
    n = ctx.counts.get("calls", 0)
    total = ctx.spans.totals().get("condprobe.probe")
    if not n or total is None:
        return None
    return 1e3 * total / n
