"""The routing decision of a fit: :class:`Route`.

Port of the ``Route`` dataclass of :mod:`wlsqm_tpu.fitter.ladder`.  The
rest of that module (the precision ladder, the conditioning probe behind it
and the per-case split route) certifies the TPU's emulated f32-pair
arithmetic; the H100 runs FP64 natively, so the port's kernel computes in
f64 and is held to the f64 engine.  Whether any of the ladder comes over is
decided later, from H100 measurements (ROADMAP item A15); until then a
route has no split fields.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Route:
    """A hashable execution-path decision for one batch or bucket.

    path: "kernel" (a fused kernel, in ``kernel_precision`` arithmetic —
    always "f64" in this package — with the body named by ``assembly``:
    "moments" or "rows") or "xla" (the engine at ``precision``; the name is
    the JAX package's, kept so that a plan reads the same in both).
    """

    path: str
    refine_steps: int | None = None   # in-kernel sweeps (kernel path)
    precision: str = "f64"            # engine precision (xla path)
    kernel_precision: str = "f64"     # kernel arithmetic (kernel path)
    assembly: str = "moments"         # kernel assembly (kernel path)
