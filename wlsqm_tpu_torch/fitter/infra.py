"""Problem-size helpers and DOF remapping (compat surface).

Port of :mod:`wlsqm_tpu.fitter.infra`.  The reference's ``infra`` module is
C-only memory infrastructure: a bump Allocator, CaseManager and per-case
Case structs with per-thread scratch (reference: wlsqm/fitter/infra.pyx).
Here the state is batched tensors inside
:class:`wlsqm_tpu_torch.fitter.engine.Prepared` and PyTorch's caching
allocator holds the temporaries, so what remains are the Python-useful
helpers: DOF counting and the original↔reduced DOF mappings implied by a
knowns bitmask (the engine reduces by masking, but the mappings help to read
reduced-system quantities).
"""

from __future__ import annotations

import numpy as np

from wlsqm_tpu_torch.fitter.defs import number_of_dofs, number_of_reduced_dofs

__all__ = ["number_of_dofs", "number_of_reduced_dofs", "remap"]


def remap(n: int, mask: int):
    """DOF index mappings between the full and knowns-reduced systems.

    Returns (o2r, r2o, nr): original→reduced and reduced→original index
    arrays (int32, -1 for non-existent entries) and the reduced DOF count
    (reference: wlsqm/fitter/infra.pyx:145-200).
    """
    o2r = np.full(n, -1, dtype=np.int32)
    r2o = np.full(n, -1, dtype=np.int32)
    k = 0
    for j in range(n):
        if not (mask >> j) & 1:
            o2r[j] = k
            r2o[k] = j
            k += 1
    return o2r, r2o, k
