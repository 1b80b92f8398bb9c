"""``correct`` fails where it should: the control (the reference in float32
judged in the program's place) and a broken timed path, each cell at a
tiny size on the CPU, the look for a card skipped."""

import dataclasses

import pytest

from bench_port_cases import CELLS, run_cell

FIT_CELLS = [c for c in CELLS if c.startswith("fit2d")]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    out, _ = run_cell(name, judge="control")
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]


def _broken_fit_many(monkeypatch, fault):
    from wlsqm_tpu_torch import api

    inner = api.fit_many

    def fit_many(xk, fk, xi, **kw):
        res = inner(xk, fk, xi, **kw)
        fi, sens = res.fi.clone(), None if res.sens is None else res.sens.clone()
        if fault == "altered":           # an answer altered where it is produced
            fi[::5, -1] *= 1 + 1e-6
            fi[::5, -1] += 1e-6
        elif fault == "half":            # half of the batch left out
            fi[fi.shape[0] // 2:] = 0.0
            if sens is not None:
                sens[sens.shape[0] // 2:] = 0.0
        return type(res)(fi=fi, sens=sens, iterations=res.iterations,
                         cond_scaled=res.cond_scaled)

    monkeypatch.setattr(api, "fit_many", fit_many)


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("name", FIT_CELLS)
def test_a_broken_fit_is_not_correct(monkeypatch, name, fault):
    _broken_fit_many(monkeypatch, fault)
    out, _ = run_cell(name)
    assert not out["correct"] and out["failed"] > 0, out["checks"]


def test_altered_sensitivities_are_not_correct(monkeypatch):
    from wlsqm_tpu_torch import api

    inner = api.fit_many

    def fit_many(xk, fk, xi, **kw):
        res = inner(xk, fk, xi, **kw)
        sens = res.sens.clone()
        sens[::3, 0, :] += 1e-8
        return type(res)(fi=res.fi, sens=sens, iterations=res.iterations,
                         cond_scaled=res.cond_scaled)

    monkeypatch.setattr(api, "fit_many", fit_many)
    out, _ = run_cell("fit2d_o4_k30.sens")
    c = out["checks"]["sens_gap"]
    assert not out["correct"] and c["value"] > c["limit"]


def test_an_altered_certified_case_is_not_correct(monkeypatch):
    """The irregular cell holds a case to its own bar: an error of 1e-9 on
    every case fails on the well-conditioned ones (a kernel's certified
    part, where the bar is 1e-10), though the mix's worst-conditioned cases
    have bars above it."""
    from wlsqm_tpu_torch import api

    inner = api.fit_many

    def fit_many(xk, fk, xi, **kw):
        res = inner(xk, fk, xi, **kw)
        fi = res.fi.clone()
        fi[:, 0] += 1e-9 * fi.abs().amax(1).clamp_min(1.0)
        return type(res)(fi=fi, sens=res.sens, iterations=res.iterations,
                         cond_scaled=res.cond_scaled)

    monkeypatch.setattr(api, "fit_many", fit_many)
    out, ctx = run_cell("fit2d_o4_k30.irregular")
    c = out["checks"]["fi_over_bar"]
    assert not out["correct"] and c["value"] > c["limit"], out["checks"]
    assert ctx.notes["worst_gap"] < 1e-8


def test_a_plan_on_another_route_stops_the_run(monkeypatch):
    """The planned cell replays the plan that certifies K1; a plan that routes
    elsewhere stops the run rather than timing another path."""
    from wlsqm_tpu_torch import api

    inner = api.plan_fit_many

    def plan_fit_many(*a, **kw):
        plan = inner(*a, **kw)
        return dataclasses.replace(plan, route=dataclasses.replace(plan.route, path="engine"))

    monkeypatch.setattr(api, "plan_fit_many", plan_fit_many)
    with pytest.raises(RuntimeError, match="routes to"):
        run_cell("fit2d_o4_k30.planned")


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half", "late"])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    """The heat step: a solve whose DOFs are zero leaves the state unchanged;
    a DOF altered where it is produced; half the points left unsolved; a DOF
    altered on the fifth step only (every step is checked)."""
    from wlsqm_tpu_torch import api

    inner = api.solve
    calls = []

    def solve(prep, fk, *a, **kw):
        fi, sens = inner(prep, fk, *a, **kw)
        fi = fi.clone()
        calls.append(1)
        if fault == "late":
            if len(calls) == 2 + 5:                # two warm-up steps, then the fifth
                fi[..., :, 3] *= 1 + 1e-6
        elif fault == "unchanged":
            fi.zero_()
        elif fault == "altered":
            fi[..., ::5, 3] *= 1 + 1e-6
        else:
            fi[..., fi.shape[-2] // 2:, :] = 0.0
        return fi, sens

    monkeypatch.setattr(api, "solve", solve)
    out, ctx = run_cell("heat2d_o2_k28.step_f1")
    assert not out["correct"] and out["failed"] > 0, out["checks"]
    if fault == "late":
        assert out["failed"] == 1 and ctx.attempted > 5
    if fault == "unchanged":
        assert out["checks"]["u_gap"]["value"] > out["checks"]["u_gap"]["limit"]

