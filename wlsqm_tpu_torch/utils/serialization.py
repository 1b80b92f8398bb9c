"""Checkpointing prepared solver state.

Port of :mod:`wlsqm_tpu.utils.serialization`.  The reference cannot pickle
its ExpertSolver, whose prepared state lives in raw C buffers (reference:
TODO.md:73-81); here a :class:`~wlsqm_tpu_torch.fitter.engine.Prepared` is
a set of tensors, written to one ``.npz`` file in the JAX package's flat
layout (``c``, ``w``, the scalings and masks, ``fac_kind`` with ``fac_<i>``
or ``fac_L_<i>_<j>``, ``opt_*``, ``meta_*``), so a file written by either
package loads in the other.  Enough to stop and resume an IBVP run without
factoring again, or to ship prepared geometry between hosts.

Two conventions differ between the packages and are converted here: LU
pivots are 1-based in torch (LAPACK's) and 0-based in the file (JAX's), and
the JAX package's unrolled Cholesky (``solver="chol_unrolled"``) stores its
factor entry by entry (``fac_kind="unrolled"``), which loads as the dense
lower factor this package computes for that solver.  Only ``precision="f64"``
state exists here; a file of an emulated precision is refused.

The orbax pair of the JAX package becomes a ``torch.save`` / ``torch.load``
pair of the same flat state (:func:`save_prepared_torch`), and the dict
that :func:`prepared_state_dict` returns can sit in any larger checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch

from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import engine
from wlsqm_tpu_torch.ops import solve as solve_ops

__all__ = ["save_prepared", "load_prepared", "save_prepared_torch", "load_prepared_torch",
           "prepared_state_dict", "prepared_from_state_dict"]

_ARRAYS = ("c", "w", "row_scale", "col_scale", "active", "known", "unknown", "xi",
           "cond_orig", "cond_scaled", "ruiz_iters")
_OPTIONAL = ("A_scaled", "c_lo", "w_lo", "dof_scale")


def prepared_state_dict(prep: engine.Prepared) -> dict:
    """Flatten a Prepared into a flat {name: ndarray} dict in the JAX
    package's layout (round-trips through :func:`prepared_from_state_dict`)."""
    out = {name: getattr(prep, name).detach().cpu().numpy() for name in _ARRAYS}
    fac = [f.detach().cpu().numpy() for f in prep.fac]
    if prep.solver == solve_ops.SOLVER_LU:
        fac[1] = fac[1] - 1                 # LAPACK's 1-based pivots -> JAX's 0-based
    out["fac_kind"] = np.asarray("dense")
    out.update({"fac_%d" % i: f for i, f in enumerate(fac)})
    out["meta_dimension"] = np.asarray(prep.dimension)
    out["meta_solver"] = np.asarray(prep.solver)
    out["meta_precision"] = np.asarray(engine.PRECISION_F64)
    return out


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def prepared_from_state_dict(d: dict, device=None) -> engine.Prepared:
    """Rebuild a Prepared from a flat state dict (this package's or the JAX
    package's), on ``device`` (the card by default).  Values may be NumPy
    arrays, tensors or strings."""
    precision = str(_np(d["meta_precision"]))
    extra = [k for k in _OPTIONAL if "opt_" + k in d]
    if precision != engine.PRECISION_F64 or extra:
        raise ValueError("only precision='f64' prepared state exists in this package; "
                         "got precision %r with %s" % (precision, extra))
    device = config.resolve_device(device)
    solver = str(_np(d["meta_solver"]))
    solve_ops.check_solver(solver)
    kw = {}
    for name in _ARRAYS:
        a = _np(d[name])
        dtype = (torch.bool if name in ("active", "known", "unknown")
                 else torch.int32 if name == "ruiz_iters" else config.DTYPE)
        kw[name] = torch.as_tensor(a.copy(), dtype=dtype, device=device)
    if str(_np(d["fac_kind"])) == "unrolled":
        n = kw["c"].shape[-1]
        L = np.zeros(kw["c"].shape[:1] + (n, n))
        for i in range(n):
            for j in range(i + 1):
                L[:, i, j] = _np(d["fac_L_%d_%d" % (i, j)])
        fac = [L]
    else:
        fac = [_np(d["fac_%d" % i]) for i in range(sum(k.startswith("fac_") and
                                                       k[4:].isdigit() for k in d))]
    mat = _factor_layout(torch.as_tensor(fac[0], dtype=config.DTYPE, device=device), solver)
    kw["fac"] = ((mat, torch.as_tensor(fac[1] + 1, dtype=torch.int32, device=device))
                 if solver == solve_ops.SOLVER_LU else (mat,))
    return engine.Prepared(dimension=int(_np(d["meta_dimension"])), solver=solver, **kw)


def _factor_layout(mat: torch.Tensor, solver: str) -> torch.Tensor:
    """``mat`` in the memory layout the device's own factorisation returns
    (column-major matrices on the CPU): the triangular solves take another
    code path for another layout, and give other bits."""
    probe = solve_ops.factor(torch.eye(2, dtype=mat.dtype, device=mat.device).expand(
        2, 2, 2), solver)[0]
    return mat.mT.contiguous().mT if probe.mT.is_contiguous() else mat.contiguous()


def save_prepared(path: str, prep: engine.Prepared) -> None:
    """Write a Prepared to ``path`` (.npz, the JAX package's layout)."""
    np.savez_compressed(path, **prepared_state_dict(prep))


def load_prepared(path: str, device=None) -> engine.Prepared:
    """Read a Prepared written by either package from ``path``, onto
    ``device`` (the card by default)."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    return prepared_from_state_dict(d, device)


def save_prepared_torch(path, prep: engine.Prepared) -> None:
    """Write the flat state of a Prepared with ``torch.save`` (tensors and
    strings, loadable with ``weights_only=True``)."""
    torch.save({k: str(v) if v.dtype.kind in "US" else torch.from_numpy(np.array(v))
                for k, v in prepared_state_dict(prep).items()}, path)


def load_prepared_torch(path, device=None) -> engine.Prepared:
    """Restore a Prepared saved by :func:`save_prepared_torch`."""
    return prepared_from_state_dict(torch.load(path, map_location="cpu",
                                               weights_only=True), device)
