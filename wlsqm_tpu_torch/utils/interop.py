"""Carry prepared state across from the JAX package.

WLSQM has no learned weights: the state worth carrying over is the
prepared geometry of an expert-mode solve (basis rows, weights, scalings
and the Cholesky factor) and the window plan of an IBVP gather.
:func:`prepared_from_numpy` builds this package's
:class:`~wlsqm_tpu_torch.fitter.engine.Prepared` from the fields of a JAX
``Prepared`` turned into NumPy arrays, so that ``solve_prepared`` computes
the same thing in both packages; :func:`gather_plan_from_fields` builds a
:class:`~wlsqm_tpu_torch.ops.gather.GatherPlan` from
``dataclasses.asdict`` of a JAX ``GatherPlan``; :func:`route_from_fields`
and :func:`calibration_from_fields` do the same for a routing decision and
for a device's calibration record.  Nothing here imports JAX:
the caller does the conversion, e.g.
``{f.name: np.asarray(getattr(prep, f.name)) for f in fields(prep)}`` with
``fac`` given as its tuple of arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import calibration, engine, ladder
from wlsqm_tpu_torch.ops import gather

_BOOL = ("active", "known", "unknown")
_INT = ("ruiz_iters",)


def prepared_from_numpy(fields: dict, *, dimension: int, solver: str,
                        precision: str, device=None) -> engine.Prepared:
    """A port ``Prepared`` from a dict of NumPy arrays, on ``device``.

    fields: every tensor field of :class:`engine.Prepared` by name; ``fac``
    is an array or a tuple/list of arrays.  Keys of JAX-only fields (the
    emulated-precision parts: ``c_lo``, ``w_lo``, ``A_scaled``,
    ``dof_scale``) are accepted only when they hold None.  Only
    ``precision="f64"`` state exists in this package.
    """
    if precision != engine.PRECISION_F64:
        raise ValueError("only precision='f64' state can be carried over; got %r"
                         % (precision,))
    names = [f.name for f in dataclasses.fields(engine.Prepared)
             if f.name not in ("dimension", "solver")]
    extra = {k for k, v in fields.items() if k not in names and v is not None}
    if extra:
        raise ValueError("fields %s have no counterpart at precision f64" % sorted(extra))
    missing = [n for n in names if fields.get(n) is None]
    if missing:
        raise ValueError("missing Prepared fields %s" % missing)
    device = config.resolve_device(device)

    def conv(name, a):
        a = np.asarray(a)
        if name in _BOOL:
            return torch.as_tensor(a.astype(bool), device=device)
        if name in _INT:
            return torch.as_tensor(a.astype(np.int32), device=device)
        return config.as_tensor(a, device)

    kw = {n: conv(n, fields[n]) for n in names if n != "fac"}
    fac = fields["fac"]
    fac = tuple(fac) if isinstance(fac, (tuple, list)) else (fac,)
    kw["fac"] = tuple(config.as_tensor(np.asarray(f), device) for f in fac)
    return engine.Prepared(dimension=dimension, solver=solver, **kw)


def gather_plan_from_fields(fields: dict) -> gather.GatherPlan:
    """A port ``GatherPlan`` from the fields of a JAX one (``dataclasses.asdict``).

    Every field must be present and no other; ``meta`` and ``bad_blocks``
    become tuples of ints, the sizes ints.
    """
    names = {f.name for f in dataclasses.fields(gather.GatherPlan)}
    if set(fields) != names:
        raise ValueError("GatherPlan fields: missing %s, unknown %s"
                         % (sorted(names - set(fields)), sorted(set(fields) - names)))
    kw = {k: tuple(int(v) for v in np.asarray(fields[k]).ravel())
          if k in ("meta", "bad_blocks") else int(fields[k]) for k in names}
    return gather.GatherPlan(**kw)


#: the JAX package's arithmetics and engine precisions, all FP64 here
_JAX_PRECISIONS = ("f64", "ds", "dsts", "ts", "mixed", "fast")


def route_from_fields(fields: dict) -> ladder.Route:
    """A port ``Route`` from the fields of a JAX one (``dataclasses.asdict``).

    Every field must be present and no other.  The emulated arithmetics
    ("ds", "dsts", "ts") and engine precisions ("mixed", "fast") become
    "f64", and the sweep counts that belong to them (``mixed_steps``,
    ``tail_refine_steps``: the tail here is the engine) become None; path,
    assembly ("auto" reads as "moments", the JAX kernel's first choice),
    ``refine_steps``, ``split_edge`` and ``tail_frac`` carry over.
    """
    names = {f.name for f in dataclasses.fields(ladder.Route)}
    if set(fields) != names:
        raise ValueError("Route fields: missing %s, unknown %s"
                         % (sorted(names - set(fields)), sorted(set(fields) - names)))
    for key in ("precision", "kernel_precision"):
        if fields[key] not in _JAX_PRECISIONS:
            raise ValueError("unknown %s %r" % (key, fields[key]))
    if fields["path"] not in ("kernel", "kernel-split", "xla"):
        raise ValueError("unknown path %r" % (fields["path"],))
    edge, steps = fields["split_edge"], fields["refine_steps"]
    return ladder.Route(
        path=fields["path"],
        refine_steps=None if steps is None else int(steps),
        assembly="moments" if fields["assembly"] == "auto" else fields["assembly"],
        split_edge=None if edge is None else float(edge),
        tail_frac=float(fields["tail_frac"]))


def calibration_from_fields(fields: dict, *, f64_from: str) -> calibration.DeviceCalibration:
    """A port calibration record from the fields of a JAX one.

    A JAX ``DeviceCalibration`` holds units of three emulated arithmetics
    and none of FP64, so the caller names the one that stands for it:
    ``f64_from`` is "ds" or "ts" (the tests feed both packages one fake
    record this way).  The central unit is ``ds_unit`` (the only one a JAX
    record has); the envelopes come from ``<f64_from>`` as
    ``ds_cert_unit``/``ts_parity_unit`` and their ``_m`` and ``est_`` forms;
    the rows body has no key unit in a JAX record, so it takes the moment
    body's.
    """
    if f64_from not in ("ds", "ts"):
        raise ValueError("f64_from must name the JAX unit that stands for FP64: "
                         "'ds' or 'ts'; got %r" % (f64_from,))
    cert = "ds_cert_unit" if f64_from == "ds" else "ts_parity_unit"
    est = fields.get("est_%s_m" % cert)
    return calibration.DeviceCalibration(
        f64_unit=float(fields["ds_unit"]), f64_cert_unit=float(fields[cert]),
        f64_unit_m=float(fields["ds_unit_m"]),
        f64_cert_unit_m=float(fields[cert + "_m"]),
        est_f64_cert_unit=None if est is None else float(est),
        est_f64_cert_unit_m=None if est is None else float(est),
        beyond_parity_floor=float(fields["beyond_parity_floor"]),
        kernel_max_floor=float(fields["kernel_max_floor"]),
        certified=bool(fields["certified"]), source=str(fields["source"]))
