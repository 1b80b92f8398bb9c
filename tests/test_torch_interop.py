"""Prepared state carried from the JAX package into the port.

JAX ``engine.prepare`` → NumPy → ``prepared_from_numpy`` → the port's
``solve_prepared`` equals JAX's ``solve_prepared`` on the same state to
1e-12 relative to max(|ref|, 1) per case: both solve with the SAME
factorization, so only the RHS contraction and substitution order differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_cases import cloud, rel_err
from wlsqm_tpu.fitter import engine as jengine
from wlsqm_tpu_torch.fitter import engine
from wlsqm_tpu_torch.utils.interop import prepared_from_numpy

torch.set_num_threads(1)

TOL = 1e-12


def _carry(jprep):
    fields = {}
    for f in dataclasses.fields(jprep):
        v = getattr(jprep, f.name)
        if f.name in ("dimension", "solver", "precision"):
            continue
        fields[f.name] = (tuple(np.asarray(a) for a in v) if f.name == "fac"
                          else None if v is None else np.asarray(v))
    return prepared_from_numpy(fields, dimension=jprep.dimension,
                               solver=jprep.solver, precision=jprep.precision,
                               device="cpu")


@pytest.mark.parametrize("dim", [2, 3])
def test_solve_prepared_matches_jax(dim):
    rng = np.random.default_rng(30 + dim)
    K = {2: 30, 3: 56}[dim]
    case = cloud(rng, 256, K, dim, orders=(0, 1, 2, 3, 4), weightings=(1, 2),
                 knowns=True, radius=(0.3, 1.0))
    jprep = jax.jit(jengine.prepare, static_argnames=("dimension", "NO"))(
        *(jnp.asarray(case[k]) for k in
          ("xk", "nk", "xi", "order", "knowns", "weighting")),
        dimension=dim, NO=case["NO"])
    prep = _carry(jprep)
    assert isinstance(prep, engine.Prepared) and prep.c.shape[2] == case["NO"]
    jfi, jsens = jengine.solve_prepared(jprep, jnp.asarray(case["fk"]),
                                        jnp.asarray(case["fi0"]), do_sens=True)
    fi, sens = engine.solve_prepared(prep, torch.as_tensor(case["fk"]),
                                     torch.as_tensor(case["fi0"]), do_sens=True)
    assert rel_err(fi.numpy(), np.asarray(jfi)) <= TOL
    assert rel_err(sens.numpy(), np.asarray(jsens)) <= TOL


def test_rejects_emulated_precision_state():
    with pytest.raises(ValueError):
        prepared_from_numpy({}, dimension=2, solver="chol", precision="ds")
    with pytest.raises(ValueError):
        prepared_from_numpy({"c_lo": np.zeros(3)}, dimension=2, solver="chol",
                            precision="f64")
