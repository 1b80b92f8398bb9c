"""Device and dtype configuration for wlsqm_tpu_torch.

WLSQM solves small, potentially ill-conditioned dense systems; the reference
implementation is float64 throughout (reference: wlsqm/fitter/impl.pyx,
README.md:76-78) and the parity bar is 1e-10 relative agreement.  Every
tensor of this package is ``torch.float64``; the global default dtype is left
alone.  The H100 runs FP64 natively, so there is no emulated-precision mode.

TF32 is switched off for matrix products and cuDNN: it keeps ~3 decimal
digits, which would matter for any float32 work a later kernel adds.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DTYPE = torch.float64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_dtype() -> torch.dtype:
    """The floating dtype of every fit: ``torch.float64`` (the JAX package's
    ``default_dtype``, which is float64 unless x64 is off; here it is always
    on)."""
    return DTYPE


def default_device() -> torch.device:
    """The device used when a caller passes none: the CUDA card.

    Raises when there is none: the package never moves to the CPU on its
    own.  A CPU run asks for it with ``device="cpu"``.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "wlsqm_tpu_torch computes on a CUDA device by default and none is "
            "available; pass device='cpu' to compute on the CPU")
    return torch.device("cuda")


def resolve_device(device, *tensors) -> torch.device:
    """An explicit ``device``, else the first CUDA tensor's device, else the
    card (:func:`default_device`).  NumPy arrays and CPU tensors go to the
    card: only ``device="cpu"`` computes on the CPU."""
    if device is not None:
        return torch.device(device)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            return t.device
    return default_device()


def as_tensor(x, device: torch.device, dtype: torch.dtype = DTYPE) -> torch.Tensor:
    """``x`` (tensor, NumPy array or scalar) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    if not a.flags.writeable:   # e.g. a view of a JAX array: torch wants to own it
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


def wants_grad(*tensors) -> bool:
    """Whether autograd would record an operation on any of ``tensors``."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, hint: str, *tensors) -> None:
    """Raise when autograd would record through a kernel launch: a kernel
    writes its outputs through a raw pointer, so they carry no gradient, or
    only the part the wrapper's own torch passes give."""
    if wants_grad(*tensors):
        raise ValueError("%s: the CUDA kernel has no backward, and an input requires "
                         "grad; %s, or call it under torch.no_grad()" % (name, hint))


# ---------------------------------------------------------------------------
# The compat surface's routing knobs (the JAX package's wlsqm_tpu/config.py
# l.77-162, same names, values and environment variables).
#
# The ``fit_*`` entries may send a kernel-covered batch through a CUDA fit
# kernel under the data gate (``api.fit_many(backend="auto", gate="data")``:
# a case keeps the kernel's result when its key times max|fk| / max(|fi|, 1)
# is under the calibration record's data edge, and is solved again by the
# f64 engine otherwise).  Every route computes in f64 here, so "ds" means
# only "kernel routing allowed".  "f64" keeps the ``fit_*`` entries on the
# f64 engine; ``WLSQM_TPU_NO_KERNEL_COMPAT`` set at process start does the
# same.  ``ExpertSolver`` solves on its prepared factor whatever this knob
# says (``wlsqm_tpu_torch.fitter.expert`` says why).
# ---------------------------------------------------------------------------

_COMPAT_PRECISION = ("f64" if os.environ.get("WLSQM_TPU_NO_KERNEL_COMPAT")
                     else "ds")


def set_compat_precision(mode: str) -> None:
    """Set the ``fit_*`` entries' routing: "ds" (kernel routing allowed; it
    computes in f64 all the same) or "f64" (the f64 engine only)."""
    global _COMPAT_PRECISION
    if mode not in ("ds", "f64"):
        raise ValueError(
            "compat precision must be 'ds' (kernel routing allowed) or "
            "'f64' (strict engine parity); got %r" % (mode,))
    _COMPAT_PRECISION = mode


def compat_precision() -> str:
    """The compat surface's routing ("ds" or "f64"); see
    :func:`set_compat_precision`."""
    return _COMPAT_PRECISION


# ALGO_ITERATIVE stops on exact stagnation of the f64 l-inf residual norm
# (reference: wlsqm/fitter/impl.pyx:1057-1061), so the count a kernel
# returns is decided by last-bit ties and may differ from the engine's by
# one.  Callers who branch on the count can pin iterative calls to the
# engine.  The default is scoped: on for the compat surface (the ``fit_*``
# iterative entries; ``ExpertSolver`` is on the engine anyway), whose users
# branch on the count (reference: wlsqm/fitter/simple.pyx:103-105); off for
# ``wlsqm_tpu_torch.api``.  ``set_iter_count_fidelity`` or the environment
# variable WLSQM_TPU_ITER_COUNT_FIDELITY overrides both scopes.

def _env_tristate(name: str):
    v = os.environ.get(name)
    if v is None:
        return None
    return v.strip().lower() not in ("", "0", "false", "off", "no")


_ITER_COUNT_FIDELITY = _env_tristate("WLSQM_TPU_ITER_COUNT_FIDELITY")


def set_iter_count_fidelity(enabled: bool | None) -> None:
    """Keep ALGO_ITERATIVE calls on the f64 engine, so their counts follow
    the engine's exact stagnation rule; ``None`` restores the scoped
    defaults (compat surface: on; ``wlsqm_tpu_torch.api``: off)."""
    global _ITER_COUNT_FIDELITY
    _ITER_COUNT_FIDELITY = None if enabled is None else bool(enabled)


def iter_count_fidelity(compat: bool = False) -> bool:
    """Whether iterative calls must keep the engine's count semantics;
    ``compat=True`` asks for the compat surface's scope (default on)."""
    if _ITER_COUNT_FIDELITY is not None:
        return _ITER_COUNT_FIDELITY
    return compat
