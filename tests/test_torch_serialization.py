"""Prepared-state checkpointing of the port, and files shared with the JAX package.

Both round trips of the port (npz in the JAX package's flat layout, and the
``torch.save`` pair) give back a Prepared whose solve is bit-identical; a
file saved by either package loads in the other, and ``solve`` then agrees
with the saving package's to 1e-13 relative to max(|ref|, 1) per case (two
f64 back-substitutions on one factor: ~1e-15 apart).  The cases of
tests/test_serialization.py, the orbax one as the torch.save pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wlsqm_tpu as wt
import wlsqm_tpu_torch as wtt
from torch_port_cases import rel_err
from wlsqm_tpu.utils import serialization as jser
from wlsqm_tpu_torch.utils import serialization as ser

torch.set_num_threads(1)

TOL = 1e-13
SOLVERS = ["chol", "lu", "chol_unrolled"]


def _geometry(rng, B=12, K=25):
    return rng.uniform(-1, 1, (B, K, 2)), rng.standard_normal((B, K))


@pytest.mark.parametrize("solver", SOLVERS)
def test_roundtrip_npz_and_torch(tmp_path, solver):
    xk, fk = _geometry(np.random.default_rng(42))
    prep = wtt.prepare(xk, np.zeros((12, 2)), order=3, solver=solver, device="cpu")
    fi1, _ = wtt.solve(prep, fk)
    ser.save_prepared(str(tmp_path / "prep.npz"), prep)
    back = ser.load_prepared(str(tmp_path / "prep.npz"), device="cpu")
    ser.save_prepared_torch(tmp_path / "prep.pt", prep)
    back_t = ser.load_prepared_torch(tmp_path / "prep.pt", device="cpu")
    for p in (back, back_t):
        assert (p.dimension, p.solver) == (prep.dimension, prep.solver)
        assert torch.equal(wtt.solve(p, fk)[0], fi1)
        assert torch.equal(wtt.solve(p, fk, do_sens=True)[1].nan_to_num(),
                           wtt.solve(prep, fk, do_sens=True)[1].nan_to_num())


def test_state_dict_pair_roundtrip():
    """The flat-dict layer shared by both file forms: string keys, the JAX
    package's names, and usable with any checkpointer."""
    rng = np.random.default_rng(42)
    xk = rng.uniform(-1, 1, (32, 12, 2))
    prep = wtt.prepare(xk, np.zeros((32, 2)), order=2, device="cpu")
    state = ser.prepared_state_dict(prep)
    jstate = jser.prepared_state_dict(wt.prepare(xk, np.zeros((32, 2)), order=2))
    assert set(state) == set(jstate)
    for k in state:
        assert state[k].dtype.kind == np.asarray(jstate[k]).dtype.kind, k
        assert state[k].shape == np.asarray(jstate[k]).shape, k
    back = ser.prepared_from_state_dict(state, device="cpu")
    fk = np.sin(xk[..., 0])
    assert torch.equal(wtt.solve(prep, fk)[0], wtt.solve(back, fk)[0])


@pytest.mark.parametrize("solver", SOLVERS)
def test_files_cross_between_the_packages(tmp_path, solver):
    """A file written by either package loads in the other; solve agrees
    with the saving package's solve to 1e-13 (unrolled Cholesky, LU pivots
    and the dense factor all carried)."""
    rng = np.random.default_rng(43)
    xk, fk = _geometry(rng, B=40)
    xi = np.zeros((40, 2))
    jprep = wt.prepare(xk, xi, order=3, solver=solver, precision="f64")
    jfi = np.asarray(wt.solve(jprep, jnp.asarray(fk))[0])
    jser.save_prepared(str(tmp_path / "jax.npz"), jprep)
    tprep = ser.load_prepared(str(tmp_path / "jax.npz"), device="cpu")
    assert tprep.solver == solver
    assert rel_err(wtt.solve(tprep, fk)[0].numpy(), jfi) <= TOL

    prep = wtt.prepare(xk, xi, order=3, solver=solver, device="cpu")
    fi = wtt.solve(prep, fk)[0].numpy()
    ser.save_prepared(str(tmp_path / "torch.npz"), prep)
    back = jser.load_prepared(str(tmp_path / "torch.npz"))
    assert back.solver == solver and back.precision == "f64"
    assert rel_err(np.asarray(wt.solve(back, jnp.asarray(fk))[0]), fi) <= TOL


def test_emulated_precision_state_is_refused(tmp_path):
    rng = np.random.default_rng(44)
    xk, _ = _geometry(rng)
    jprep = wt.prepare(xk, np.zeros((12, 2)), order=2, precision="mixed")
    jser.save_prepared(str(tmp_path / "mixed.npz"), jprep)
    with pytest.raises(ValueError, match="precision='f64'"):
        ser.load_prepared(str(tmp_path / "mixed.npz"), device="cpu")


def test_load_defaults_to_the_card(tmp_path):
    rng = np.random.default_rng(45)
    xk, _ = _geometry(rng)
    prep = wtt.prepare(xk, np.zeros((12, 2)), order=2, device="cpu")
    ser.save_prepared(str(tmp_path / "p.npz"), prep)
    if torch.cuda.is_available():
        assert ser.load_prepared(str(tmp_path / "p.npz")).c.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ser.load_prepared(str(tmp_path / "p.npz"))
