"""The multi-field cells, ``heat2d_o2_k28.step_f3`` and
``euler2d_o3_k24.rk3``, at a tiny size on the CPU (the look for a card
skipped): ``correct`` under the program and not under the control or a
broken step, and their per-layer readers on a traced run."""

import time

import pytest
import torch

import bench_port_cases
from bench_port import harness
from bench_port_cases import run_cell

#: the new cells and their tiny sizes: the Euler cloud at nside 32
NEW = {"heat2d_o2_k28.step_f3": {}, "euler2d_o3_k24.rk3": {"nside": 32, "points": 1024}}


@pytest.mark.parametrize("name", sorted(NEW))
def test_the_program_is_correct(name):
    out, ctx = run_cell(name, overrides=NEW[name])
    assert out["correct"] and out["failed"] == 0 and ctx.attempted > 3, out["checks"]
    assert set(ctx.values) == {"setup_s", "step_ms"}


@pytest.mark.parametrize("name", sorted(NEW))
def test_the_control_is_not_correct(name):
    out, _ = run_cell(name, judge="control", overrides=NEW[name])
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]


@pytest.mark.parametrize("fault", ["altered", "late", "stale"])
def test_a_broken_flow_step_is_not_correct(monkeypatch, fault):
    """The Euler step: a DOF altered where it is produced; one altered on
    the fifth step's second stage only (every stage is checked); a stage
    that leaves its state unchanged."""
    from wlsqm_tpu_torch.examples import euler_flow as ef

    if fault == "stale":
        inner_step = ef.Flow.step

        def step(self, U, dt, keep=None):
            out = inner_step(self, U, dt, keep=keep)
            return U.clone() if keep is not None else out

        monkeypatch.setattr(ef.Flow, "step", step)
    else:
        inner = ef.wtt.solve
        calls = []

        def solve(prep, fk, *a, **kw):
            fi, sens = inner(prep, fk, *a, **kw)
            calls.append(1)
            if fault == "altered" or len(calls) == 3 * 3 + 3 * 4 + 2:
                fi = fi.clone()
                fi[..., ::7, 1] *= 1 + 1e-6
            return fi, sens

        monkeypatch.setattr(ef.wtt, "solve", solve)
    out, ctx = run_cell("euler2d_o3_k24.rk3", overrides=NEW["euler2d_o3_k24.rk3"])
    assert not out["correct"] and out["failed"] > 0, out["checks"]
    if fault == "late":
        assert out["failed"] == 1 and ctx.attempted > 5


def _traced(name, **overrides):
    from wlsqm_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    profiling.reset()
    ctx = harness.Context(cell=harness.load_cell(name), seed=2**31 + 13, seconds=0.3,
                          traced=True, device=torch.device("cpu"),
                          t_start=time.perf_counter(),
                          overrides=dict(bench_port_cases.TINY, **overrides))
    return harness.run(ctx), ctx


@pytest.mark.parametrize("name", ["heat2d_o2_k28.step_f1"] + sorted(NEW))
def test_the_new_readers_read_the_cells_that_list_them(name):
    """``solve_ms_per_field`` is the span's mean a call over the fields a
    call; ``flow_pointwise_ms`` reads the Euler cell alone."""
    out, ctx = _traced(name, **NEW.get(name, {}))
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    fields = {"heat2d_o2_k28.step_f1": 1, "heat2d_o2_k28.step_f3": 3,
              "euler2d_o3_k24.rk3": 8}[name]
    stages = 3 if name.startswith("euler") else 1
    # the span also holds the warm-up's calls in the stepper, not in the flow
    calls = len(ctx.spans._events["api.solve"])
    assert calls >= stages * ctx.counts["steps"]
    want = 1e3 * ctx.spans.totals()["api.solve"] / calls / fields
    assert m["solve_ms_per_field"] == pytest.approx(want, rel=1e-9)
    assert ("flow_pointwise_ms" in m) == name.startswith("euler")
    if name.startswith("euler"):
        assert calls == stages * ctx.counts["steps"]
        assert 0 < m["flow_pointwise_ms"] < m["solve_ms"]


def test_a_program_without_the_field_counter_reports_no_share_a_field(monkeypatch):
    """A program without the counter ``engine.solve_fields`` (an older
    checkout's): the reader returns None and the line leaves it out."""
    from wlsqm_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "count", lambda name, n=1: None)
    out, _ = _traced("heat2d_o2_k28.step_f3")
    assert out["correct"] and "solve_ms_per_field" not in out["metrics"]
    assert "solve_ms" in out["metrics"]
