"""Milliseconds a call in the rows wrapper's passes around K2: the stream
seconds of the program's spans ``fit_rows.prescale`` (the scale, the DOF
de-scale factors and the scaled known values) and ``fit_rows.finish``
(the de-scale of fi and sens), over the calls."""

from bench_port.lib import program

PARTS = ("fit_rows.prescale", "fit_rows.finish")


def read(ctx):
    total = program.span_sum(ctx, PARTS, "stream_s")
    return None if total is None else 1e3 * program.per(ctx, "calls", total)
