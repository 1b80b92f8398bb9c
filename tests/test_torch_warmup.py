"""warmup of the port: the reference's configurations, their reports, and
route warming from a plan or from representative geometry (the cases of
tests/test_warmup.py, on the CPU, where nothing is built and the kernels'
plain versions run)."""

import numpy as np
import pytest
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu.warmup import DEFAULT_CONFIGS as JAX_CONFIGS
from wlsqm_tpu_torch.fitter import defs
from wlsqm_tpu_torch.warmup import DEFAULT_CONFIGS

torch.set_num_threads(1)


def test_default_configs_are_the_references():
    assert DEFAULT_CONFIGS == JAX_CONFIGS
    assert all("dimension" in c and "K" in c for c in DEFAULT_CONFIGS)


def test_warmup_planned_config_runs_and_reports():
    (rep,) = wtt.warmup([dict(dimension=2, order=2, K=12, weighting=defs.WEIGHT_UNIFORM)],
                        device="cpu")
    assert rep["path"] in ("kernel", "xla", "kernel-split")
    assert rep["assembly"] == "moments"
    assert rep["compile_s"] > 0 and rep["run_s"] > 0
    assert "route" in rep and rep["config"]["K"] == 12
    assert set(rep["launches"]) == {"fit_moment", "fit_rows", "cond_estimate@fit_moment",
                                    "cond_estimate@fit_rows", "gather_rows"}


@pytest.mark.parametrize("cfg,assembly", [
    (dict(dimension=2, order=2, K=12, assembly="rows", refine_steps=1), "rows"),
    (dict(dimension=3, order=2, K=16, assembly="moments"), "moments"),
    (dict(dimension=2, order=2, K=12, precision="ds"), "moments"),
])
def test_warmup_explicit_kernel_config(cfg, assembly):
    """An explicit body runs the kernel directly, a 3D moment body included
    (forced, as ``fit_pallas(assembly="moments")`` is)."""
    (rep,) = wtt.warmup([dict(cfg, weighting=defs.WEIGHT_UNIFORM)], device="cpu")
    assert rep["path"] == "kernel" and rep["assembly"] == assembly
    assert assembly in rep["route"]


def test_warmup_with_representative_geometry_and_plan():
    rng = np.random.default_rng(42)
    xi = rng.uniform(-1, 1, (64, 2))
    xk = xi[:, None, :] + rng.uniform(-0.4, 0.4, (64, 10, 2))
    (rep,) = wtt.warmup([dict(dimension=2, order=2, xk=xk, xi=xi,
                              weighting=defs.WEIGHT_UNIFORM)], device="cpu")
    assert rep["compile_s"] > 0 and "xk" not in rep["config"]
    plan = wtt.plan_fit_many(xk, xi, order=2, weighting=defs.WEIGHT_UNIFORM, device="cpu")
    (rep,) = wtt.warmup([dict(dimension=2, order=2, K=10, plan=plan,
                              weighting=defs.WEIGHT_UNIFORM)], device="cpu")
    assert rep["route"] == str(plan)


def test_warmup_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: warmup would build the kernels")
    with pytest.raises(RuntimeError, match="CUDA"):
        wtt.warmup([dict(dimension=2, order=2, K=12)])
