"""Milliseconds a step of the Euler flow's pointwise work: the stream
seconds of the program's spans ``euler.flux`` (the 8 flux fields of each
stage's state) and ``euler.rk`` (each stage's SSP-RK3 combination), summed
over the window, over the steps."""

from bench_port.lib import program

PARTS = ("euler.flux", "euler.rk")


def read(ctx):
    total = program.span_sum(ctx, PARTS, "stream_s")
    return None if total is None else 1e3 * program.per(ctx, "steps", total)
