"""Package boundary of the port: it imports without JAX."""

import ast
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX package's examples, each with a counterpart of the same name in the port
EXAMPLES = ("ibvp_heat", "euler_flow", "adjoint_data_recovery", "gradient_stencil_design",
            "response_surface", "sudoku_lhs", "wlsqm_tour", "expertsolver_example",
            "distributed_pipeline", "jit_plan_sharding", "drivers_benchmark")


def test_import_leaves_jax_out():
    code = ("import sys, wlsqm_tpu_torch, wlsqm_tpu_torch.ops.fit_kernel, "
            "wlsqm_tpu_torch.ops.fit_rows, wlsqm_tpu_torch.ops.gather, "
            "wlsqm_tpu_torch.utils.interop, wlsqm_tpu_torch.utils.neighbors, "
            "wlsqm_tpu_torch.fitter.interp, wlsqm_tpu_torch.fitter.polyeval, "
            "wlsqm_tpu_torch.fitter.condprobe, wlsqm_tpu_torch.fitter.calibration, "
            "wlsqm_tpu_torch.fitter.ladder, wlsqm_tpu_torch.fitter.expert, "
            "wlsqm_tpu_torch.fitter.simple, wlsqm_tpu_torch.fitter.impl, "
            "wlsqm_tpu_torch.fitter.infra, wlsqm_tpu_torch.utils.lapackdrivers, "
            "wlsqm_tpu_torch.utils.ptrwrap, "
            "wlsqm_tpu_torch.examples.ibvp_heat, wlsqm_tpu_torch.examples.euler_flow, "
            "wlsqm_tpu_torch.examples.adjoint_data_recovery, "
            "wlsqm_tpu_torch.examples.gradient_stencil_design, "
            "wlsqm_tpu_torch.examples.response_surface, wlsqm_tpu_torch.examples.sudoku_lhs, "
            "wlsqm_tpu_torch.examples.wlsqm_tour, wlsqm_tpu_torch.examples.expertsolver_example, "
            "wlsqm_tpu_torch.examples.distributed_pipeline, "
            "wlsqm_tpu_torch.examples.jit_plan_sharding, "
            "wlsqm_tpu_torch.examples.drivers_benchmark, wlsqm_tpu_torch.native, "
            "wlsqm_tpu_torch.parallel.sharding, wlsqm_tpu_torch.utils.serialization, "
            "wlsqm_tpu_torch.utils.profiling, wlsqm_tpu_torch.warmup; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'wlsqm_tpu' not in sys.modules; print('ok')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_public_names():
    import wlsqm_tpu_torch as wtt

    for name in ("fit", "fit_many", "fit_stream", "plan_fit_many", "FitPlan", "FitResult",
                 "Prepared", "prepare", "solve", "interpolate", "WEIGHT_CENTER",
                 "number_of_dofs", "i2_X4", "b3_XYZ2", "ExpertSolver",
                 "set_compat_precision", "compat_precision", "interpolate_fit",
                 "lambdify_fit", "warmup",
                 "interpolate_continuous"):
        assert hasattr(wtt, name), name
    from wlsqm_tpu_torch import config
    from wlsqm_tpu_torch.fitter import simple, tables
    from wlsqm_tpu_torch.ops import solve

    # the JAX package's last three public helpers the port lacked
    for mod, name in ((tables, "derivative_order"), (solve, "solve"),
                      (config, "default_dtype")):
        assert callable(getattr(mod, name, None)), name
    assert len(simple.__all__) == 18
    for name in simple.__all__:
        assert getattr(wtt, name) is getattr(simple, name), name


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke run exits non-zero and prints no result."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke run would really run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def _imported_modules(path):
    """Every module an ``import`` statement of the file names, at any depth."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_and_smoke_run_read_nothing_of_the_jax_side():
    """chip_smoke.py and every module of the port, its examples included,
    import neither jax, the JAX package, its benchmark script (bench.py
    imports both) nor anything of ``examples/`` (the JAX package's examples,
    and their sampler ``sudoku_lhs``, of which the port keeps a copy)."""
    files = [os.path.join(ROOT, "chip_smoke.py")] + glob.glob(
        os.path.join(ROOT, "wlsqm_tpu_torch", "**", "*.py"), recursive=True)
    assert len(files) > 20
    for mod in ("fitter/expert.py", "fitter/simple.py", "fitter/impl.py",
                "fitter/infra.py", "utils/lapackdrivers.py", "utils/ptrwrap.py",
                *("examples/%s.py" % name for name in EXAMPLES)):
        assert os.path.join(ROOT, "wlsqm_tpu_torch", mod) in files, mod
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "wlsqm_tpu", "bench", "examples",
                               "sudoku_lhs"), (path, mod)


def test_every_example_has_its_counterpart():
    """Each script of ``examples/`` has a file of the same name in the
    port's examples, and each of those but the sampler has a ``run``."""
    import importlib

    names = sorted(os.path.basename(p)[:-3]
                   for p in glob.glob(os.path.join(ROOT, "examples", "*.py")))
    assert names == sorted(EXAMPLES)
    for name in EXAMPLES:
        mod = importlib.import_module("wlsqm_tpu_torch.examples." + name)
        assert callable(getattr(mod, "sample" if name == "sudoku_lhs" else "run")), name
