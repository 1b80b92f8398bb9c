"""The device's idle share over the traced window of the planned and sens cells
(``bench_port.lib.trace.idle_pct``)."""

from bench_port.lib.trace import idle_pct as read  # noqa: F401
