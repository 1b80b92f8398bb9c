"""Ruiz sweeps a call in the f64 engine's tail: the program's counter
``engine.ruiz_sweeps`` (the equilibration loop's trips, one host read
each), over the calls."""

from bench_port.lib import program


def read(ctx):
    return program.per(ctx, "calls", program.counters(ctx).get("engine.ruiz_sweeps"))
