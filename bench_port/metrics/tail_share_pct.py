"""The share of the window's fitted cases that the gate handed to the f64
engine: the cases counted at ``engine.fit_batch`` over all cases."""


def read(ctx):
    cases = ctx.counts.get("cases", 0)
    if not cases or not ctx.spans.traced:
        return None
    return 100.0 * ctx.spans.counters.get("engine.fit_batch.cases", 0) / cases
