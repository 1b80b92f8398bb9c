"""Certified routing: the cheapest execution path that clears the accuracy bar.

Port of :mod:`wlsqm_tpu.fitter.ladder`.  The conditioning probe's error
model (:mod:`wlsqm_tpu_torch.fitter.condprobe`) becomes a *ladder*: rungs,
fastest first, each taken only where the device's calibration record
(:mod:`wlsqm_tpu_torch.fitter.calibration`) certifies it to the 1e-10 parity
bar.  The TPU package climbs through three emulated arithmetics and four
engine precisions; the H100 computes in FP64, so the rungs here are the two
kernel bodies and the engine:

1. **kernel, moment assembly**: the fastest body, when the per-case
   envelope ``f64_cert_unit_m * cond2(A_jacobi) * inv_s**order`` clears the
   bar for every sampled case;
2. **kernel, rows assembly**: the same against the rows body's own units
   (it also serves what the moment body's certified route does not cover:
   sensitivities and 3D);
3. **kernel, uncertified**: when the predicted floor exceeds
   ``beyond_parity_floor`` the problem is conditioning-limited — no two
   correct f64 normal-equation solves agree to 1e-10 there, the engine
   included — so the ladder keeps kernel speed and claims nothing; past
   ``kernel_max_floor`` (or a singular probe) the geometry counts as
   degenerate and fails safe to the engine;
4. **the f64 engine**: the reference algorithm (Ruiz scaling, Cholesky),
   the rung of last resort and the tail rung of the per-case split.

Between rungs 2 and 3 sits the middle band, where a sampled case misses the
envelope but most cases may not: there the per-case split
(``Route.path == "kernel-split"``) runs a kernel with its per-case key
(``emit_cond``) on ALL cases and re-solves on the engine exactly the cases
whose key exceeds the certified edge.  The TPU package guards that split
with a throughput model (the glue against its triple-single kernel); here
the alternative to the split is the engine for the WHOLE batch, which is
slower whenever any case certifies, so the split is an accuracy rung with no
speed guard (``chip_smoke.py``'s ``phase_certified`` times its parts).

The decision is made once per batch/bucket on concrete data and returned as
a hashable :class:`Route`, so it can also be captured in a
:class:`wlsqm_tpu_torch.api.FitPlan` and replayed with no inspection of the
data and no host synchronisation.
"""

from __future__ import annotations

import dataclasses

from wlsqm_tpu_torch.fitter import condprobe

__all__ = ["Route", "choose"]


@dataclasses.dataclass(frozen=True)
class Route:
    """A hashable execution-path decision for one batch or bucket.

    path: "kernel" (a fused kernel, in ``kernel_precision`` arithmetic —
    always "f64" in this package — with the body named by ``assembly``:
    "moments" or "rows"), "kernel-split" (per-case certified split: that
    kernel with its per-case ``emit_cond`` key on ALL cases, then the f64
    engine re-solving the cases whose key exceeds ``split_edge`` — up to a
    ``tail_frac`` window of them, gathered and scattered with static shapes,
    so a replay never waits for the host) or "xla" (the engine at
    ``precision``; the name is the JAX package's, kept so that a plan reads
    the same in both).
    """

    path: str
    refine_steps: int | None = None   # in-kernel sweeps (kernel path)
    precision: str = "f64"            # engine precision (xla path)
    mixed_steps: int | None = None    # the JAX engine's sweep dial; always None
    kernel_precision: str = "f64"     # kernel arithmetic (kernel path)
    assembly: str = "moments"         # kernel assembly (kernel path)
    split_edge: float | None = None   # per-case key gate (kernel-split)
    #: tail window as a fraction of the batch (margin included), so the
    #: static window scales with the replayed batch size
    tail_frac: float = 0.0
    tail_refine_steps: int | None = None  # the JAX tail kernel's sweeps; None: the engine


#: the split route engages only when at least this fraction of the planning
#: batch certifies for the kernel — below it the batch goes to the engine
SPLIT_MIN_FRAC = 0.5

#: static tail-window slack over the planning batch's measured tail
#: fraction: replayed batches whose tail outgrows the window leave the
#: overflow on the (uncertified) kernel result — the same
#: plan-representativeness contract FitPlan replay already carries
TAIL_MARGIN = 1.6

#: median slack of the per-case key over the exact spectral cond — used only
#: as a heuristic to predict the certified fraction from the sampled probe
#: before paying for the key; never in a certification decision
EST_OVER_COND_MED = 1.5


def choose(cond_amp, *, tol: float = condprobe.AUTO_TOL, kernel_ok: bool = True,
           moments_ok: bool = False) -> Route:
    """Pick the cheapest route whose predicted error clears ``tol``.

    ``cond_amp``: a :func:`wlsqm_tpu_torch.fitter.condprobe.probe` result
    (may be None for degenerate geometry — routes to the engine).
    ``kernel_ok``: the rows kernel takes this batch's configuration and
    shape; ``moments_ok``: the moment kernel does too.  Each body certifies
    against its OWN units and the fastest certified one wins.
    """
    engine_route = Route(path="xla", precision="f64")
    if cond_amp is None:
        return engine_route
    units = condprobe._units()   # per-device calibration record
    steps = condprobe.pick_from(cond_amp, tol=tol)
    if moments_ok and condprobe.accuracy_ok_from(cond_amp, tol=tol,
                                                 assembly="moments"):
        return Route(path="kernel", assembly="moments", refine_steps=steps)
    if kernel_ok and condprobe.accuracy_ok_from(cond_amp, tol=tol, assembly="rows"):
        return Route(path="kernel", assembly="rows", refine_steps=steps)
    cond, amp = cond_amp
    floor = units.f64_unit * float((cond * amp).max())
    if kernel_ok and units.beyond_parity_floor < floor <= units.kernel_max_floor:
        # conditioning-limited regime: kernel speed, no certification claim.
        # Near-singular or degenerate geometry (a floor beyond
        # kernel_max_floor, incl. inf from a singular probe) falls through
        # to the engine.
        return Route(path="kernel", assembly="moments" if moments_ok else "rows",
                     refine_steps=steps)
    return engine_route
