"""The port's compat surface: reference-style names and modules.

The name list and README example of tests/test_wlsqm_compat.py on
``wlsqm_tpu_torch``, the reference's module names (``fitter.impl``,
``fitter.infra``, ``utils.lapackdrivers``, ``utils.ptrwrap``) against the
JAX package's, and the routing knobs of ``config``.
"""

import numpy as np
import pytest
import torch

import wlsqm_tpu as wt
import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch import config as tconfig

torch.set_num_threads(1)

COMPAT_NAMES = (
    "fit_1D", "fit_2D", "fit_3D",
    "fit_1D_many_parallel", "fit_2D_many_parallel", "fit_3D_many_parallel",
    "ExpertSolver", "interpolate_fit", "lambdify_fit", "interpolate_continuous",
    "WEIGHT_UNIFORM", "WEIGHT_CENTER", "ALGO_BASIC", "ALGO_ITERATIVE",
    "number_of_dofs", "set_compat_precision", "compat_precision",
)


@pytest.fixture(autouse=True)
def _restore_knobs():
    saved = tconfig._COMPAT_PRECISION, tconfig._ITER_COUNT_FIDELITY
    yield
    tconfig._COMPAT_PRECISION, tconfig._ITER_COUNT_FIDELITY = saved


def test_reference_style_imports():
    from wlsqm_tpu_torch.fitter import (  # noqa: F401
        defs, expert, impl, infra, interp, polyeval, simple,
    )
    from wlsqm_tpu_torch.utils import lapackdrivers, ptrwrap  # noqa: F401
    from wlsqm_tpu_torch.utils.lapackdrivers import ScalingAlgo  # noqa: F401

    for name in COMPAT_NAMES:
        assert hasattr(wtt, name), "wlsqm_tpu_torch.%s missing" % name
        assert hasattr(wt, name), name


def test_every_public_name_of_the_jax_namespace_but_the_waiting_ones():
    """What ``wlsqm_tpu/__init__.py`` exports, the port exports too, now
    that nothing waits: ``fit_stream`` and ``warmup`` (ROADMAP A8, A13)
    are ported; only the version and the module names are not compared."""
    names = {n for n in dir(wt) if not n.startswith("_")}
    modules = {"api", "config", "fitter", "ops", "utils", "parallel", "native"}
    missing = sorted(n for n in names - modules if not hasattr(wtt, n))
    assert missing == [], missing
    assert callable(wtt.fit_stream) and callable(wtt.warmup)


def test_reference_readme_example(rng):
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return 1.0 + 2.0 * x + 3.0 * y + 5.0 * x**2 + 2.0 * x * y
    xk = rng.uniform(-1, 1, (30, 2))
    fi = np.zeros(wtt.number_of_dofs(2, 2))
    wtt.fit_2D(xk=xk, fk=f(xk), xi=np.zeros(2), fi=fi, sens=None, do_sens=False,
               order=2, knowns=0, weighting_method=wtt.WEIGHT_UNIFORM, debug=False,
               device="cpu")
    np.testing.assert_allclose(fi, [1.0, 2.0, 3.0, 10.0, 2.0, 0.0], atol=1e-10)
    model = wtt.lambdify_fit(np.zeros(2), fi, 2, 2, device="cpu")
    np.testing.assert_allclose(model(0.3, -0.2), f(np.array([0.3, -0.2])), atol=1e-10)


@pytest.mark.parametrize("mask", [0, 0b1, 0b101, 0b111111, 0b100000])
def test_infra_remap_matches_jax(mask):
    from wlsqm_tpu.fitter import infra as jinfra
    from wlsqm_tpu_torch.fitter import infra

    for a, b in zip(infra.remap(6, mask), jinfra.remap(6, mask)):
        np.testing.assert_array_equal(a, b)
    assert infra.number_of_dofs is wtt.number_of_dofs
    assert infra.number_of_reduced_dofs(6, mask) == jinfra.number_of_reduced_dofs(6, mask)


def test_impl_aliases_are_the_engine():
    from wlsqm_tpu.fitter import impl as jimpl
    from wlsqm_tpu_torch.fitter import engine, impl

    assert impl.__all__ == jimpl.__all__
    for name in impl.__all__:
        assert getattr(impl, name) is getattr(engine, name)


def test_ptrwrap():
    from wlsqm_tpu_torch.utils.ptrwrap import PointerWrapper

    p = PointerWrapper()
    assert p.ptr is None
    p.set_ptr("x")
    assert p.ptr == "x"


def test_compat_precision_knob():
    assert wtt.compat_precision() in ("ds", "f64")
    with pytest.raises(ValueError, match="'ds'.*'f64'"):
        wtt.set_compat_precision("bogus")
    wtt.set_compat_precision("f64")
    assert wtt.compat_precision() == "f64" == tconfig.compat_precision()
    wtt.set_compat_precision("ds")
    assert wtt.compat_precision() == "ds"


def test_iter_count_fidelity_scoped_default(monkeypatch):
    monkeypatch.setattr(tconfig, "_ITER_COUNT_FIDELITY", None)
    assert tconfig.iter_count_fidelity() is False
    assert tconfig.iter_count_fidelity(compat=True) is True
    tconfig.set_iter_count_fidelity(False)
    assert tconfig.iter_count_fidelity(compat=True) is False
    tconfig.set_iter_count_fidelity(True)
    assert tconfig.iter_count_fidelity() is True
    tconfig.set_iter_count_fidelity(None)
    assert tconfig.iter_count_fidelity(compat=True) is True


def test_knob_environment_variables(monkeypatch):
    """The JAX package's variables, parsed the same way."""
    from wlsqm_tpu import config as jconfig

    name = "WLSQM_TPU_ITER_COUNT_FIDELITY"
    monkeypatch.delenv(name, raising=False)
    assert tconfig._env_tristate(name) is None
    for value in ("0", "false", "off", "no", "", "1", "true", "yes"):
        monkeypatch.setenv(name, value)
        assert tconfig._env_tristate(name) is jconfig._env_tristate(name)
    import subprocess
    import sys

    code = ("import wlsqm_tpu_torch.config as c; "
            "print(c.compat_precision(), c.iter_count_fidelity())")
    env = dict(__import__("os").environ, WLSQM_TPU_NO_KERNEL_COMPAT="1",
               WLSQM_TPU_ITER_COUNT_FIDELITY="0")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.split() == ["f64", "False"], out.stderr


def test_api_iterative_auto_route_honours_count_fidelity(monkeypatch):
    """Set explicitly, count fidelity keeps ``fit_many(iterative=True)``'s
    auto route and its plan on the engine, as in the JAX package (its
    api-scope default is off)."""
    from torch_port_cases import roomy_units
    from wlsqm_tpu_torch.ops import fit_kernel, fit_rows

    roomy_units(monkeypatch)
    rng = np.random.default_rng(3)
    xk = rng.uniform(-1, 1, (64, 30, 2))
    fk = np.sin(xk[..., 0])
    calls = []
    for mod, name in ((fit_rows, "fit_rows"), (fit_kernel, "fit_kernel")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _real=real, **k: calls.append(1) or _real(*a, **k))
    kw = dict(order=2, iterative=True, max_iter=3, device="cpu")
    wtt.fit_many(xk, fk, **kw)
    assert wtt.plan_fit_many(xk, **{k: v for k, v in kw.items() if k != "max_iter"}
                             ).route.path == "kernel"
    assert len(calls) == 1
    tconfig.set_iter_count_fidelity(True)
    wtt.fit_many(xk, fk, **kw)
    assert wtt.plan_fit_many(xk, order=2, iterative=True, device="cpu").route.path == "xla"
    assert len(calls) == 1
