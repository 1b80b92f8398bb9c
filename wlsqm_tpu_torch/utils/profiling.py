"""Lightweight profiling hooks.

Port of :mod:`wlsqm_tpu.utils.profiling`.  The reference has no built-in
tracing; its examples use a wall-clock timer.  These helpers cover the two
conveniences users reach for: a wall-clock timer that waits for the card's
outstanding work, and a one-call wrapper around ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["Timer", "device_trace"]


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock timer context that waits for outstanding device work.

    With ``sync`` (the default) it calls ``torch.cuda.synchronize()`` on
    entry and exit when the card is in use, so the time covers the work
    queued inside the block.

    >>> with Timer("solve") as t:
    ...     fi, _ = wtt.solve(prep, fk)
    >>> t.seconds
    """

    def __init__(self, label: str = "", sync: bool = True, quiet: bool = False):
        self.label = label
        self.sync = sync
        self.quiet = quiet
        self.seconds = None

    def __enter__(self):
        if self.sync:
            _synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _synchronize()
        self.seconds = time.perf_counter() - self._t0
        if not self.quiet and self.label:
            print(f"[{self.label}] {self.seconds:.4f} s")
        return False


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity when the card is in use) and write it to ``logdir`` as a
    Chrome trace (``trace.json``; chrome://tracing, Perfetto).  Yields the
    profiler, whose ``key_averages()`` tabulates the ops."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
