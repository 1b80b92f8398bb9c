"""The last three helpers of the JAX package's public modules, in the port.

``fitter.tables.derivative_order`` on every (dimension, DOF) pair;
``ops.solve.solve``, the one-shot factor-and-solve, for each solver name
against the JAX function within 1e-12 relative (one well-conditioned SPD
batch, so two f64 factorizations differ by ~cond * eps); and
``config.default_dtype``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wlsqm_tpu import config as jconfig
from wlsqm_tpu.fitter import tables as jtables
from wlsqm_tpu.ops import solve as jsolve
from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import tables
from wlsqm_tpu_torch.ops import solve as solve_ops

torch.set_num_threads(1)


@pytest.mark.parametrize("dimension", [1, 2, 3])
def test_derivative_order_is_the_jax_packages(dimension):
    n = tables.EXPONENTS[dimension].shape[0]
    got = [tables.derivative_order(dimension, d) for d in range(n)]
    assert got == [jtables.derivative_order(dimension, d) for d in range(n)]
    assert all(isinstance(v, int) for v in got) and got[0] == 0 and max(got) == 4


@pytest.mark.parametrize("solver", ["chol", "lu", "chol_unrolled"])
def test_one_shot_solve_is_the_jax_packages(solver):
    rng = np.random.default_rng(7)
    n, B = 15, 64
    M = rng.standard_normal((B, n, n))
    A = M + M.transpose(0, 2, 1) + 2 * n * np.eye(n)
    b = rng.standard_normal((B, n, 3))
    got = solve_ops.solve(torch.as_tensor(A), torch.as_tensor(b), solver).numpy()
    ref = np.asarray(jsolve.solve(jnp.asarray(A), jnp.asarray(b), solver=solver))
    assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)
    assert np.abs(A @ got - b).max() <= 1e-12 * np.abs(b).max()
    with pytest.raises(ValueError):
        solve_ops.solve(torch.as_tensor(A), torch.as_tensor(b), "qr")


def test_default_dtype_is_float64():
    assert config.default_dtype() is torch.float64 is config.DTYPE
    assert jconfig.default_dtype() == jnp.float64
