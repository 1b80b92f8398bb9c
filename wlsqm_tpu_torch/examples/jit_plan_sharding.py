"""Replaying a FitPlan: one routing decision, many calls, over shards.

Counterpart of the JAX package's ``examples/jit_plan_sharding.py``.
``fit_many(backend="auto")`` inspects the data (the conditioning probe, the
ladder) before it fits.  ``plan = plan_fit_many(xk, xi, order=...)``
captures that decision once on representative data, and
``fit_many(..., plan=plan)`` replays it with no inspection.  In the JAX
package this is what lets the call nest in ``jax.jit``, ``lax.scan`` and
``shard_map``.  PyTorch runs eagerly, so there is no trace to nest in; what
stands in their place here:

* ``jit``: a plain call of ``fit_many(plan=plan)``, which launches the
  planned kernel (the moment kernel on the card, its plain version on the
  CPU) with no probe;
* ``lax.scan``: a Python loop that replays the plan every step (a toy
  3-step relaxation that refits each step);
* ``shard_map``: the batch laid over :data:`SHARDS` logical shards of the
  device (:func:`wlsqm_tpu_torch.parallel.sharding.make_mesh` and
  ``distribute``), the plan replayed on each shard's cases; the joined
  result is held bit for bit against the one-device call (a kernel fits
  each case on its own).

Run: python -m wlsqm_tpu_torch.examples.jit_plan_sharding [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.parallel import sharding

B, K, ORDER = 1024, 25, 2
#: logical shards of the one device (the original's eight virtual devices)
SHARDS = 8


def run(device=None) -> dict:
    """Plan once, then replay on ``device`` (the card unless
    ``device="cpu"``).  Returns the plan's route, the replayed DOFs, the
    replays' finiteness and the sharded replay's bit identity to the
    one-device call.  Raises if a replay is not finite or the sharded
    replay differs from the one-device call."""
    device = config.resolve_device(device)
    rng = np.random.default_rng(0)
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.4, 0.4, (B, K, 2))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])
    xk_t, fk_t, xi_t = (torch.as_tensor(a, device=device) for a in (xk, fk, xi))

    plan = wtt.plan_fit_many(xk_t, xi_t, order=ORDER, device=device)
    fi = wtt.fit_many(xk_t, fk_t, xi_t, order=ORDER, plan=plan, device=device).fi

    u = fk_t
    for _ in range(3):
        model = wtt.fit_many(xk_t, u, xi_t, order=ORDER, plan=plan, device=device).fi[:, 0]
        u = u * 0.9 + 0.1 * model[:, None]

    mesh = sharding.make_mesh(devices=[device] * SHARDS)
    parts = sharding.distribute(mesh, xk, fk, xi)
    fi_sh = sharding.join([wtt.fit_many(a, b, c, order=ORDER, plan=plan, device=d).fi
                           for a, b, c, d in zip(*parts, mesh)])
    out = {"device": str(device), "B": B, "k": K, "fi": fi.cpu().numpy(),
           "route": plan.route.path,
           "assembly": plan.route.assembly if plan.route.path != "xla" else None,
           "fit_finite": bool(torch.isfinite(fi).all()),
           "relax_finite": bool(torch.isfinite(u).all()), "shards": len(mesh),
           "sharded_bit_equal": torch.equal(fi_sh, fi),
           "sharded_max_diff": float((fi_sh - fi).abs().max())}
    if not (out["fit_finite"] and out["relax_finite"]):
        raise RuntimeError("a replayed fit is not finite: %s" % (out,))
    if not out["sharded_bit_equal"]:
        raise RuntimeError("the sharded replay differs from the one-device call: %s" % (out,))
    return out


if __name__ == "__main__":
    res = run(device="cpu" if "--cpu" in sys.argv[1:] else None)
    print("plan: route=%s%s" % (res["route"], "" if res["assembly"] is None
                                else " (%s body)" % res["assembly"]))
    print("plan replay: (%d, 6) finite: %s" % (res["B"], res["fit_finite"]))
    print("replay loop ok:", res["relax_finite"])
    print("%d logical shards of %s: max|diff| vs single = %.1e"
          % (res["shards"], res["device"], res["sharded_max_diff"]))
