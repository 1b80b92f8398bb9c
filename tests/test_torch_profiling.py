"""utils.profiling of the port: the synchronising Timer and the trace
wrapper (the cases of tests/test_profiling.py; the JAX package's Timer
reports the same kind of result for the same kind of block), and the
port's own spans and counters, which record only under a profiler."""

import json
import os

import numpy as np
import pytest
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu.utils import profiling as jprofiling
from wlsqm_tpu_torch.utils import profiling
from wlsqm_tpu_torch.utils.profiling import Timer, device_trace

torch.set_num_threads(1)


def test_timer_measures_and_prints(capsys):
    with Timer("work") as t:
        float(torch.arange(1000.0).sum())
    assert t.seconds is not None and t.seconds >= 0.0
    assert "[work]" in capsys.readouterr().out


def test_timer_quiet_and_nosync(capsys):
    with Timer(sync=False, quiet=True) as t:
        sum(range(100))
    assert t.seconds >= 0.0
    assert capsys.readouterr().out == ""
    with jprofiling.Timer(sync=False, quiet=True) as tj:
        sum(range(100))
    assert set(vars(t)) <= set(vars(tj)) | {"_t0"}


def test_device_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with device_trace(logdir) as prof:
        float(torch.ones((64, 64), dtype=torch.float64).sum())
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
    assert any(e.key == "aten::sum" for e in prof.key_averages())


def test_timer_brackets_real_fit():
    rng = np.random.default_rng(42)
    xk = rng.uniform(-1, 1, (8, 20, 2))
    with Timer(quiet=True) as t:
        res = wtt.fit_many(xk, np.sin(xk[..., 0]), order=2, device="cpu")
        res.fi.numpy()
    assert t.seconds > 0.0


@pytest.fixture
def registry():
    """The module registry, empty before and after the test."""
    profiling.reset()
    yield profiling
    profiling.reset()


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _irregular_batch(B=2048, K=30, seed=3):
    """A 2D cloud whose neighbourhood radii are log-uniform over a decade:
    the auto route probes it and splits it between the kernel and a tail."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(-1, 1, (B, 2))
    r = np.exp(np.log(0.1) + rng.uniform(0, 1, B) * np.log(10.0))
    xk = xi[:, None, :] + rng.uniform(-1, 1, (B, K, 2)) * r[:, None, None]
    fk = np.sin(3 * xk[..., 0]) * np.cos(2 * xk[..., 1]) + 0.3 * xk[..., 0] * xk[..., 1]
    return xk, fk, xi


AUTO = dict(order=4, weighting=wtt.WEIGHT_CENTER, backend="auto", device="cpu")


def test_spans_are_a_shared_noop_without_a_profiler(registry):
    assert registry.span("api.checks") is registry.span("engine.solve")
    with registry.span("a"):
        registry.count("b", 3)
    xk, fk, xi = _irregular_batch(B=256)
    wtt.fit_many(xk, fk, xi, **AUTO)
    assert registry.totals() == {} and registry.counters() == {}


def test_nested_spans_are_profiler_events_and_counters_add(registry):
    with _profile() as prof:
        with registry.span("outer.part"):
            with registry.span("inner.part"):
                float(torch.arange(100.0).sum())
            with registry.span("inner.part"):
                registry.count("inner.items", 2)
        registry.count("inner.items", 5)
    names = {e.name for e in prof.events()}
    assert {"outer.part", "inner.part"} <= names
    got = registry.totals()
    assert got["outer.part"]["calls"] == 1 and got["inner.part"]["calls"] == 2
    assert got["inner.part"]["host_s"] > 0
    assert got["outer.part"]["host_s"] >= got["inner.part"]["host_s"]
    # without a device a span has no stream clock
    assert got["outer.part"]["stream_s"] is None
    assert registry.counters() == {"inner.items": 7}
    # the profiler has stopped: nothing more is recorded
    with registry.span("outer.part"):
        registry.count("inner.items")
    assert registry.totals()["outer.part"]["calls"] == 1
    assert registry.counters() == {"inner.items": 7}


def test_a_span_on_the_cpu_times_its_stream_on_the_host(registry):
    """Given the CPU as its device, a span's stream seconds are its host
    seconds, whether or not the process has touched a card."""
    with _profile():
        with registry.span("fit_rows.prescale", torch.device("cpu")):
            float(torch.arange(100.0).sum())
    got = registry.totals()["fit_rows.prescale"]
    assert got["calls"] == 1 and got["host_s"] > 0
    assert got["stream_s"] == got["host_s"]


def test_the_auto_route_records_the_gate_and_the_tail(registry):
    """A 2D order-4 batch of 2,048 cases on the auto route: the probe's
    four parts, the split and the engine's tail, each once, and the tail's
    Ruiz sweeps; the tail's one solve counts one field."""
    xk, fk, xi = _irregular_batch()
    with _profile():
        wtt.fit_many(xk, fk, xi, **AUTO)
    got, n = registry.totals(), registry.counters()
    for name in ("api.checks", "condprobe.screen", "condprobe.host_copy",
                 "condprobe.assemble", "condprobe.svd", "api.kernel", "api.split_select"):
        assert got[name]["calls"] == 1 and got[name]["host_s"] > 0, name
    for name in ("engine.assemble", "engine.ruiz", "engine.factor", "engine.solve",
                 "api.split_scatter"):
        assert got[name]["calls"] == 1, name
    assert n == {"engine.ruiz_sweeps": n["engine.ruiz_sweeps"], "engine.solve_fields": 1}
    assert n["engine.ruiz_sweeps"] >= 1


def test_the_route_and_wrapper_spans_of_the_kernel_and_stepper_paths(registry):
    """A forced rows-kernel fit with sensitivities, a prepared solve and a
    gather, each under the profiler: the wrapper's passes, the route's
    checks and the gather's checks."""
    from wlsqm_tpu_torch.ops import gather

    xk, fk, xi = _irregular_batch(B=64, K=20)
    with _profile():
        wtt.fit_many(xk, fk, xi, order=2, backend="kernel", do_sens=True, device="cpu")
    got = registry.totals()
    for name in ("api.checks", "api.kernel", "fit_rows.prescale", "fit_rows.finish"):
        assert got[name]["calls"] == 1, name
    # the wrapper's passes carry their device's stream clock; the route's do not
    assert got["fit_rows.prescale"]["stream_s"] == got["fit_rows.prescale"]["host_s"]
    assert got["api.kernel"]["stream_s"] is None
    registry.reset()
    prep = wtt.prepare(xk, xi, order=2, device="cpu")
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (256, 2))
    idx = np.argsort(((pts[:, None] - pts[None]) ** 2).sum(-1), axis=1)[:, :8]
    plan = gather.plan_window_gather(idx, 256)
    with _profile():
        wtt.solve(prep, torch.as_tensor(fk))
        gather.gather_rows(torch.as_tensor(pts[:, 0]), idx, plan)
    got = registry.totals()
    assert got["api.checks"]["calls"] == got["engine.solve"]["calls"] == 1
    assert got["gather.checks"]["calls"] == 1
    assert "engine.assemble" not in got           # prepared before the profiler


@pytest.mark.parametrize("backend", ["auto", "engine"])
def test_the_profiler_leaves_the_result_bit_identical(registry, backend):
    xk, fk, xi = _irregular_batch()
    kw = dict(AUTO, backend=backend)
    off = wtt.fit_many(xk, fk, xi, **kw)
    with _profile():
        on = wtt.fit_many(xk, fk, xi, **kw)
    assert registry.totals()
    assert torch.equal(on.fi, off.fi) and torch.equal(on.iterations, off.iterations)


def test_the_euler_step_records_its_flux_and_rk_spans_and_the_fields_solved(registry):
    """One SSP-RK3 step of the Euler example under the profiler: the flux
    and the RK combination once a stage, each with a stream clock (the host
    on the CPU), and 8 fields counted a stage; a single-field solve counts
    1."""
    from wlsqm_tpu_torch.examples import euler_flow as ef

    flow = ef.setup(16, 12, device="cpu")
    U, dt = flow.initial(), ef.cfl_dt(16)
    with _profile():
        flow.step(U, dt)
    got = registry.totals()
    for name in ("euler.flux", "euler.rk"):
        assert got[name]["calls"] == 3 and got[name]["stream_s"] == got[name]["host_s"] > 0
    assert got["engine.solve"]["calls"] == 3
    assert registry.counters() == {"engine.solve_fields": 24}
    registry.reset()
    fk = flow.gather(ef.flux_fields(U))
    with _profile():
        wtt.solve(flow.prep, fk.permute(2, 0, 1))
        wtt.solve(flow.prep, fk[..., 0])
    assert registry.counters() == {"engine.solve_fields": 9}


def test_the_euler_spans_and_the_field_counter_record_nothing_without_a_profiler(registry):
    from wlsqm_tpu_torch.examples import euler_flow as ef

    flow = ef.setup(16, 12, device="cpu")
    U = flow.initial()
    flow.step(U, ef.cfl_dt(16))
    wtt.solve(flow.prep, flow.gather(ef.flux_fields(U))[..., 0])
    assert registry.totals() == {} and registry.counters() == {}
