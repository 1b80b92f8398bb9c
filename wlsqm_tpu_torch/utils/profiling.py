"""Lightweight profiling hooks.

Port of :mod:`wlsqm_tpu.utils.profiling`.  The reference has no built-in
tracing; its examples use a wall-clock timer.  These helpers cover the two
conveniences users reach for: a wall-clock timer that waits for the card's
outstanding work, and a one-call wrapper around ``torch.profiler``.

The port's own spans and counters live here too.  The program opens
:func:`span` around each part of its route, gate, engine and wrappers, and
adds to :func:`count` where it already holds a host integer.  Both record
only while a ``torch.profiler`` session records (:func:`device_trace`, or
any profiler an operator starts): then a span is a ``record_function``
event of that trace, so it shares the profiler's one clock with the
device's kernels, and its host seconds (and stream seconds, for a span
given its device) add to a registry read by :func:`totals` and
:func:`counters`.  With no profiler recording, a span
is one attribute read and a shared no-op context: no allocation, no device
call, no synchronisation.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["Timer", "device_trace", "span", "count", "totals", "counters", "reset"]


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


# ---------------------------------------------------------------------------
# The program's spans and counters
# ---------------------------------------------------------------------------

#: what :func:`span` returns while no profiler records
_OFF = contextlib.nullcontext()

_LOCK = threading.Lock()
_SPANS: dict = {}       # name -> [calls, host_s, stream_s, pending [(device, start, end)]]
_COUNTERS: dict = {}    # name -> int


class _Span:
    """A span while a profiler records: a ``record_function`` event, the
    host clock at both ends and, on a CUDA ``device``, a pair of CUDA events
    on that device's current stream."""

    __slots__ = ("name", "_device", "_rf", "_t0", "_start")

    def __init__(self, name: str, device):
        self.name = name
        self._device = device

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._start = None
        if self._device is not None and self._device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._device))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self._t0
        pair = None
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            pair = (self._device, self._start, end)
        with _LOCK:
            entry = _SPANS.setdefault(self.name, [0, 0.0, 0.0, []])
            entry[0] += 1
            entry[1] += host_s
            if pair is not None:
                entry[3].append(pair)
            elif self._device is None:
                entry[2] = None
            elif entry[2] is not None:
                entry[2] += host_s                  # on the CPU the stream is the host
        self._rf.__exit__(*exc)
        return False


def span(name: str, device: torch.device | None = None):
    """A context manager that records the block as the span ``name`` while
    a ``torch.profiler`` session records, and does nothing otherwise.

    Recording, it is a ``record_function`` event of the profiler's trace,
    and its host seconds (``time.perf_counter``) add to the registry that
    :func:`totals` reads.  Given the ``device`` its work runs on, its stream
    seconds do too: on a CUDA device a pair of CUDA events on that device's
    current stream (~50 µs under a profiler that traces the card), on the
    CPU the host seconds.  Without a device its stream seconds are None.
    Event pairs wait in the registry until :func:`totals` reads them.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to the counter ``name`` while a profiler
    records.  A counter never reads the device."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def totals() -> dict:
    """``{name: {"calls", "host_s", "stream_s"}}`` of every span recorded
    since the last :func:`reset` (``stream_s`` None for a span opened
    without a device).  Synchronises each device that has pending event
    pairs, once."""
    with _LOCK:
        pending = [e for e in _SPANS.values() if e[3]]
        for dev in {d for e in pending for d, _, _ in e[3]}:
            torch.cuda.synchronize(dev)
        for e in pending:
            if e[2] is not None:
                e[2] += sum(a.elapsed_time(b) for _, a, b in e[3]) / 1e3
            e[3].clear()
        return {name: {"calls": e[0], "host_s": e[1], "stream_s": e[2]}
                for name, e in _SPANS.items()}


def counters() -> dict:
    """``{name: total}`` of every counter since the last :func:`reset`."""
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    """Empty the registry of spans and counters."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()
