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

import numpy as np
import torch

DTYPE = torch.float64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
