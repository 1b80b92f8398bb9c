"""The plain reference of ``fit2d_o4_k30``: an exact weighted least-squares
fit of each case, in plain torch (see ``bench_port/lib/wls_ref.py``)."""

from bench_port.lib.wls_ref import fit, fit_blocks, gap  # noqa: F401
