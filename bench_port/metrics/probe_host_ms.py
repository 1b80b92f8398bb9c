"""Milliseconds a call of the gate's probe on the host after its screen:
the host seconds of the program's spans ``condprobe.host_copy`` (the
sample's copy to the host), ``condprobe.assemble`` (its NumPy normal
matrices) and ``condprobe.svd`` (``np.linalg.cond``), over the calls."""

from bench_port.lib import program

PARTS = ("condprobe.host_copy", "condprobe.assemble", "condprobe.svd")


def read(ctx):
    total = program.span_sum(ctx, PARTS, "host_s")
    return None if total is None else 1e3 * program.per(ctx, "calls", total)
