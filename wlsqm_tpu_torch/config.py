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
    """The device used when a caller passes none: CUDA when present."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(device, *tensors) -> torch.device:
    """An explicit ``device``, else the first tensor's, else the default."""
    if device is not None:
        return torch.device(device)
    for t in tensors:
        if isinstance(t, torch.Tensor):
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
