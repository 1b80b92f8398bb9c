"""Milliseconds a call of the route's host work in ``fit_many``: the host
seconds of the program's spans ``api.checks`` (its checks and conversions
before the dispatch) and ``api.kernel`` (the kernel wrapper's call: its
checks and the launch), over the calls.  The rows wrapper's passes
(``fit_rows.prescale``, ``fit_rows.finish``) run inside ``api.kernel`` and
are the Wrappers layer's (``rows_passes_ms``): their host seconds, which
include the host's wait for the card in the prescale, are left out."""

from bench_port.lib import program

PARTS = ("api.checks", "api.kernel")
WRAPPER = ("fit_rows.prescale", "fit_rows.finish")


def read(ctx):
    got = program.spans(ctx)
    if not all(n in got for n in PARTS):
        return None
    total = (sum(got[n]["host_s"] for n in PARTS)
             - sum(got[n]["host_s"] for n in WRAPPER if n in got))
    return 1e3 * program.per(ctx, "calls", total)
