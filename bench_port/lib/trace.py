"""Spans, counters and the device trace of a run.

Spans are recorded by the benchmark's own code around the calls it makes
into each layer of the port, and around the module attributes through
which the port calls its own layers (``Spans.wrap``).  In a traced run a
span is a pair of CUDA events in stream order, named for the profiler by
``record_function``; in an untraced run a span records nothing, so the
timed path is the same as a user's.  Host spans (set-up) are taken on the
host clock in every run: they cost nothing.

``Trace`` runs ``torch.profiler`` over the window and reduces its events
to what the per-layer readers and the breakdown need: device time by
kernel name, the union of device intervals (busy time), and the idle gaps
named by the innermost span the host was in.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re
import time

import torch

WINDOW = "bench.window"
#: the names of the spans this benchmark records
SPAN_NAME = re.compile(r"^(api|condprobe|engine|gather|step|bench)\.")


class Spans:
    """Program spans and counters of one run."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.host_s = collections.defaultdict(float)    # name -> seconds (host clock)
        self.counters = collections.defaultdict(int)
        self._events = collections.defaultdict(list)   # name -> [(start, end)]
        self._restore = []

    @contextlib.contextmanager
    def host(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host_s[name] += time.perf_counter() - t0

    @contextlib.contextmanager
    def span(self, name: str):
        """A span in stream order; nothing unless the run is traced."""
        if not self.traced:
            yield
            return
        with torch.profiler.record_function(name):
            cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if cuda:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self._events[name].append((start, end))
                else:
                    self._events[name].append(time.perf_counter() - t0)

    def wrap(self, module, attr: str, name: str, count=None) -> None:
        """In a traced run, put ``module.attr`` inside a span of ``name``;
        ``count(*args)`` adds to the counter ``name + ".cases"``."""
        if not self.traced:
            return
        inner = getattr(module, attr)

        def wrapped(*args, **kwargs):
            if count is not None:
                self.counters[name + ".cases"] += int(count(*args, **kwargs))
            self.counters[name + ".calls"] += 1
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(module, attr, wrapped)
        self._restore.append((module, attr, inner))

    def unwrap(self) -> None:
        for module, attr, inner in reversed(self._restore):
            setattr(module, attr, inner)
        self._restore.clear()

    def totals(self) -> dict:
        """Seconds in each span over the run (synchronises the device)."""
        out, synced = {}, False
        for name, evs in self._events.items():
            total = 0.0
            for ev in evs:
                if isinstance(ev, float):
                    total += ev
                    continue
                if not synced:
                    torch.cuda.synchronize()
                    synced = True
                total += ev[0].elapsed_time(ev[1]) / 1e3
            out[name] = total
        return out


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between them as (start, end) pairs, over sorted input."""
    total, gaps, cur_s, cur_e = 0, [], None, None
    for s, e in intervals:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


class Trace:
    """``torch.profiler`` over a traced run's window."""

    def __init__(self, traced: bool):
        self.traced = traced
        self._prof = None
        self.summary = None

    def start(self) -> None:
        if not self.traced:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.summary = summarise(self._prof.profiler.kineto_results.events())
        self._prof = None


def _annotation(e) -> bool:
    """Whether a device event is a span mirrored onto the device's timeline
    (the profiler's user annotations), not device work."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "annotation" in str(kind()).lower()
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def summarise(events) -> dict:
    """Device intervals, kernel times and idle gaps inside the window span.

    Returns busy_s, window_s, kernels {name: seconds}, device_ops (the ten
    longest by name) and idle_gaps (gap seconds summed by the innermost
    benchmark span the host was in at each gap's middle, ten largest).
    """
    window, device, spans = None, [], []
    for e in events:
        dt = str(e.device_type()).rsplit(".", 1)[-1]
        name = e.name()
        ours = name == WINDOW or SPAN_NAME.match(name)
        if dt == "CPU":
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif ours:
                spans.append((e.start_ns(), e.end_ns(), name))
        elif dt == "CUDA" and not ours and not _annotation(e):
            # kernels, copies and sets; the profiler also mirrors each span
            # onto the device's timeline, which is no device work
            device.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {}, "device_ops": [],
                "idle_gaps": []}
    w0, w1 = window
    inside = sorted((max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1)
    busy, gaps = _union((s, e) for s, e, _ in inside)
    kernels = collections.defaultdict(float)
    for s, e, n in inside:
        kernels[n] += (e - s) / 1e9
    gaps = ([(w0, inside[0][0])] if inside and inside[0][0] > w0 else []) + gaps + (
        [(max(e for _, e, _ in inside), w1)] if inside else [(w0, w1)])
    spans.sort()
    starts = [s for s, _, _ in spans]
    named = collections.defaultdict(float)
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid, name = (g0 + g1) // 2, "host"
        # spans nest, so the innermost one around mid is the latest-starting
        # one that still holds it; look back a bounded way
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if spans[j][1] >= mid:
                name = spans[j][2]
                break
        named[name] += (g1 - g0) / 1e9
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9, "kernels": dict(kernels),
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(named.items(), key=lambda kv: -kv[1])[:10]]}


def idle_pct(ctx):
    """The share of the traced window in which no operation ran on the
    device: one less the union of its kernel, copy and set intervals over
    the window.  None without a trace or device time."""
    summary = ctx.trace.summary or {}
    window, busy = summary.get("window_s", 0.0), summary.get("busy_s", 0.0)
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
