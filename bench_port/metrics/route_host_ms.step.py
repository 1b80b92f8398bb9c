"""Milliseconds a step of the stepper's host checks: the host seconds of
the program's spans ``gather.checks`` (the gather's checks and its
launch) and ``api.checks`` (``solve``'s checks), over the steps."""

from bench_port.lib import program

PARTS = ("gather.checks", "api.checks")


def read(ctx):
    total = program.span_sum(ctx, PARTS, "host_s")
    return None if total is None else 1e3 * program.per(ctx, "steps", total)
