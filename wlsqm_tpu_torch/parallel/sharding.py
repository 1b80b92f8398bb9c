"""Data-parallel sharding of the case axis over a list of devices.

Port of :mod:`wlsqm_tpu.parallel.sharding`.  The reference's only
parallelism is OpenMP threads over independent local problems (reference:
wlsqm/fitter/simple.pyx prange sites); the JAX package lays the case axis
over a 1-D device mesh with ``shard_map``.  Here a **mesh is a list of
``torch.device``s** (:func:`make_mesh`), and a list may name one device
several times (logical shards of one card, or ``[torch.device("cpu")] * 4``
in the tests).

A **sharded array is a list of tensors**, one per mesh entry, on that
entry's device, split along the leading (case) axis by
``torch.tensor_split`` (:func:`distribute`; :func:`join` concatenates the
shards onto one device).  Every function takes whole arrays (NumPy or
tensors, split here) or such lists, and returns case-sharded results as
lists; a replicated result (the blended values of
:func:`sharded_interpolate_continuous`) is one tensor on the first device.

Each shard's work is queued on a CUDA stream of its own on its device
before any result is read, and the device's current stream waits on it
before the call returns, so shards on one card overlap as shards on several
cards do.  The engine's functions (:func:`sharded_fit_many`) read the host
inside their loops (Ruiz sweeps, ALGO_ITERATIVE), so their shards run in
one host thread each.  The fit needs no communication: the only
cross-shard traffic is the copies that stand for the JAX package's
all-gathers (the cloud in :func:`sharded_knn`, the coefficients in
:func:`replicated_coefficients` and :func:`sharded_interpolate_nearest`, the
values in :func:`sharded_gather_values`) and the sum that stands for its
``psum`` (:func:`sharded_interpolate_continuous`).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np
import torch

from wlsqm_tpu_torch import config
from wlsqm_tpu_torch.fitter import engine, interp
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows
from wlsqm_tpu_torch.ops import gather as gth
from wlsqm_tpu_torch.ops import solve as solve_ops
from wlsqm_tpu_torch.utils import neighbors

__all__ = ["make_mesh", "distribute", "join", "pad_cases", "sharded_fit_many",
           "sharded_fit_pallas", "replicated_coefficients",
           "sharded_interpolate_continuous", "sharded_knn",
           "sharded_build_neighborhoods", "sharded_interpolate_nearest",
           "sharded_gather_values", "sharded_solve_prepared"]


def make_mesh(n_devices: int | None = None, devices=None) -> list[torch.device]:
    """The first ``n_devices`` CUDA devices (all by default), as a list.

    ``devices`` overrides discovery (e.g. ``["cpu"] * 4`` for a CPU mesh,
    or ``["cuda:0"] * 4`` for four logical shards of one card).  Raises
    when there is no CUDA device and none is given.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] "
                               "(e.g. ['cpu'] * 4) for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError("make_mesh: n_devices=%d of %d devices" % (n_devices, len(devs)))
        devs = devs[:n_devices]
    return devs


def pad_cases(n: int, n_shards: int) -> int:
    """Smallest padded case count divisible by the shard count."""
    return ((n + n_shards - 1) // n_shards) * n_shards


def _mesh(mesh) -> list[torch.device]:
    devs = [torch.device(d) for d in mesh]
    if not devs:
        raise ValueError("the mesh names no device")
    return devs


def _sizes(n: int, d: int) -> list[int]:
    """The shard sizes ``torch.tensor_split`` gives n cases over d shards."""
    return [n // d + (i < n % d) for i in range(d)]


def _dtype(a) -> torch.dtype:
    """The dtype a whole array or a sharded one keeps (NumPy's own)."""
    first = a[0] if isinstance(a, (list, tuple)) else a
    if isinstance(first, torch.Tensor):
        return first.dtype
    return torch.as_tensor(np.asarray(a)[:0]).dtype


def _shards(mesh, a, dtype=config.DTYPE, sizes=None, dim=0) -> list[torch.Tensor]:
    """``a`` (a whole array, or a list of one tensor per mesh entry) as one
    tensor per mesh entry on that entry's device, split along ``dim``."""
    if isinstance(a, (list, tuple)) and len(a) == len(mesh) and all(
            isinstance(t, torch.Tensor) for t in a):
        return [t.to(device=d, dtype=dtype) for t, d in zip(a, mesh)]
    t = a if isinstance(a, torch.Tensor) else config.as_tensor(a, torch.device("cpu"),
                                                               dtype)
    parts = (torch.split(t, sizes, dim) if sizes is not None
             else torch.tensor_split(t, len(mesh), dim))
    return [p.to(device=d, dtype=dtype) for p, d in zip(parts, mesh)]


def _split_prepared(mesh, prep: engine.Prepared) -> list[engine.Prepared]:
    sizes = _sizes(prep.ncases, len(mesh))

    def split(t):
        return _shards(mesh, t, t.dtype, sizes)

    fields = {f.name: getattr(prep, f.name) for f in dataclasses.fields(prep)}
    parts = {k: split(v) for k, v in fields.items() if isinstance(v, torch.Tensor)}
    fac = [split(f) for f in prep.fac]
    return [dataclasses.replace(prep, fac=tuple(f[i] for f in fac),
                                **{k: v[i] for k, v in parts.items()})
            for i in range(len(mesh))]


def distribute(mesh, *arrays):
    """Lay arrays over the mesh, split along their leading (case) axis.

    Each array (NumPy, a tensor, or a :class:`~wlsqm_tpu_torch.fitter.engine.Prepared`)
    becomes a list of shards, one per mesh entry, on that entry's device.
    Returns the list for one array, a tuple of lists for several.
    """
    mesh = _mesh(mesh)
    out = tuple(_split_prepared(mesh, a) if isinstance(a, engine.Prepared)
                else _shards(mesh, a, _dtype(a)) for a in arrays)
    return out if len(out) != 1 else out[0]


def join(shards, device=None) -> torch.Tensor:
    """Concatenate a sharded array onto one device (the first shard's by
    default)."""
    device = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(device) for s in shards])


def _record(obj) -> None:
    """Mark the tensors in ``obj`` as used by each device's current stream,
    so the allocator does not hand their blocks back to the shard streams
    that made them while that stream may still read them."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            obj.record_stream(torch.cuda.current_stream(obj.device))
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _record(o)


_streams: dict = {}


def _stream(d: torch.device, i: int) -> torch.cuda.Stream:
    """Shard ``i``'s stream on device ``d``, made once and kept: the caching
    allocator reuses a freed block only on the stream that allocated it, so
    a fresh stream each call would allocate every shard's output anew."""
    key = (d, i)
    if key not in _streams:
        _streams[key] = torch.cuda.Stream(d)
    return _streams[key]


def _run(mesh, fn, args, threads: bool = False) -> list:
    """``fn(*args[i])`` for each mesh entry i, on a stream of its own.

    Each CUDA shard's stream first waits on its device's current stream
    (which made its inputs); every shard's work is queued before any result
    is read, and each device's current stream waits on the shard streams
    before this returns.  ``threads``: one host thread a shard, for bodies
    that read the host (the engine's loops).
    """
    streams = [_stream(d, i) if d.type == "cuda" else None for i, d in enumerate(mesh)]
    for s, d in zip(streams, mesh):
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(d))

    def one(i):
        if streams[i] is None:
            return fn(*args[i])
        with torch.cuda.device(mesh[i]), torch.cuda.stream(streams[i]):
            return fn(*args[i])

    if threads and len(mesh) > 1 and any(s is not None for s in streams):
        with concurrent.futures.ThreadPoolExecutor(len(mesh)) as pool:
            results = list(pool.map(one, range(len(mesh))))
    else:
        results = [one(i) for i in range(len(mesh))]
    for s, d in zip(streams, mesh):
        if s is not None:
            torch.cuda.current_stream(d).wait_stream(s)
    _record(results)
    return results


def sharded_fit_many(mesh, xk, fk, nk, xi, fi, order, knowns, weighting, *,
                     dimension: int, NO: int, do_sens: bool = False,
                     iterative: bool = False, max_iter: int = 10,
                     solver: str = solve_ops.SOLVER_CHOLESKY):
    """Fit a batch of cases sharded over the mesh: the f64 engine
    (:func:`wlsqm_tpu_torch.fitter.engine.fit_batch`) on each shard, with
    no communication.

    Inputs as for ``engine.fit_batch``, whole or sharded.  Returns
    (fi_out, sens, iterations, cond_scaled), each a list of shards: each
    shard holds what the engine computes for its cases alone, which on the
    CPU is the one-device result bit for bit.  On a card cuBLAS's batched
    products read the batch count (the rows past 16 x 65,535 of a 2^20-case
    call come from another kernel), so a shard may differ from the
    one-device call in the last bits (1.2e-13 measured on an H100).
    """
    mesh = _mesh(mesh)
    parts = [_shards(mesh, a, dt) for a, dt in (
        (xk, config.DTYPE), (fk, config.DTYPE), (nk, torch.int32), (xi, config.DTYPE),
        (fi, config.DTYPE), (order, torch.int32), (knowns, torch.int64),
        (weighting, torch.int32))]

    def local(*a):
        return engine.fit_batch(*a, dimension=dimension, NO=NO, do_sens=do_sens,
                                iterative=iterative, max_iter=max_iter, solver=solver)

    res = _run(mesh, local, list(zip(*parts)), threads=True)
    return tuple(list(r) for r in zip(*res))


def sharded_fit_pallas(mesh, xk, fk, nk, xi, fi_init=None, *, dimension: int,
                       order: int, weighting: int, knowns: int = 0,
                       refine_steps: int | None = None):
    """The CUDA fit kernels sharded over the case axis.

    Keeps the JAX package's name (its body runs the Pallas kernel); here
    each shard runs :func:`wlsqm_tpu_torch.ops.fit_kernel.fit_kernel` (the
    moment kernel: dims 1-3, knowns) where it covers the configuration, as
    ``fit_pallas(assembly="auto")`` takes the moment body, else
    :func:`wlsqm_tpu_torch.ops.fit_rows.fit_rows`, on its own cases; on CPU
    devices their plain versions.  Shards may be any size.  Returns fi as a
    list of shards, each the one-device kernel's bits for its cases.
    """
    mesh = _mesh(mesh)
    rs = fit_kernel.DEFAULT_REFINE_STEPS if refine_steps is None else refine_steps
    moments = fit_kernel.supported(dimension, order, knowns, weighting)
    if not (moments or fit_rows.supported(dimension, order, knowns, weighting)):
        raise ValueError("sharded_fit_pallas: no kernel covers dim=%d order=%d knowns=%d "
                         "weighting=%d" % (dimension, order, knowns, weighting))
    parts = [_shards(mesh, a, dt) for a, dt in (
        (xk, config.DTYPE), (fk, config.DTYPE), (nk, torch.int32), (xi, config.DTYPE))]
    fi0 = ([None] * len(mesh) if fi_init is None else _shards(mesh, fi_init))
    kw = dict(dimension=dimension, order=order, weighting=weighting, knowns=knowns,
              refine_steps=rs)

    def local(xk_, fk_, nk_, xi_, fi0_):
        if moments:
            return fit_kernel.fit_kernel(xk_, fk_, nk_, xi_, fi0_, **kw)
        return fit_rows.fit_rows(xk_, fk_, nk_, xi_, fi0_, **kw)[0]

    return _run(mesh, local, list(zip(*parts, fi0)))


def replicated_coefficients(mesh, fi) -> list[torch.Tensor]:
    """The (small) coefficient arrays of every shard, whole, on every device:
    one copy of the whole array per mesh entry (the JAX package's
    all-gather; reference analogue: the kNN/radius patching of
    wlsqm/fitter/expert.pyx:830-986)."""
    mesh = _mesh(mesh)
    return _whole_on(mesh, fi, _dtype(fi))


def _whole_on(mesh, a, dtype=config.DTYPE) -> list[torch.Tensor]:
    """A whole array on every device: a sharded one joined, a whole one
    copied (once per distinct device)."""
    if isinstance(a, (list, tuple)):
        return [join(_shards(mesh, a, dtype), d) for d in mesh]
    t = a if isinstance(a, torch.Tensor) else config.as_tensor(a, torch.device("cpu"),
                                                               dtype)
    return [t.to(device=d, dtype=dtype) for d in mesh]


def sharded_interpolate_continuous(mesh, fi, xi, x, r, *, dimension: int,
                                   order: int, diff: int = 0) -> torch.Tensor:
    """Continuous patched-model interpolation over a sharded cloud.

    The local models (fi (B, no), xi (B, dim)) are sharded; the queries x
    (Q, dim) go to every shard.  Each shard blends its own models into
    partial (weighted sum, weight) accumulators with
    :func:`wlsqm_tpu_torch.fitter.interp.interpolate_continuous`, and one
    sum over the shards combines them (the JAX package's ``psum``).
    Returns (Q,) blended values on the first device (NaN where no model is
    within r).
    """
    mesh = _mesh(mesh)
    fi_s, xi_s = _shards(mesh, fi), _shards(mesh, xi)
    x_all = _whole_on(mesh, x)

    def local(fi_, xi_, x_):
        return interp.interpolate_continuous(fi_, xi_, x_, r, dimension=dimension,
                                             order=order, diff=diff, device=x_.device)

    parts = _run(mesh, local, list(zip(fi_s, xi_s, x_all)))
    num = sum(p[0].to(mesh[0]) for p in parts)
    den = sum(p[1].to(mesh[0]) for p in parts)
    return num / den


def sharded_knn(mesh, points, queries, k: int):
    """k-NN over a cloud, the queries sharded over the mesh.

    Each shard holds the whole cloud (the JAX package all-gathers it) and
    answers its own queries with the device backend of
    :func:`wlsqm_tpu_torch.utils.neighbors.knn`.  Returns (indices (M, k)
    int64 into the whole cloud, squared distances (M, k)), each a list of
    query shards.
    """
    mesh = _mesh(mesh)
    p_all = _whole_on(mesh, points)
    q_s = _shards(mesh, queries)

    def local(p, q):
        return neighbors.knn(p, q, k, backend="device", device=p.device)

    res = _run(mesh, local, list(zip(p_all, q_s)))
    return [r[0] for r in res], [r[1] for r in res]


def sharded_build_neighborhoods(mesh, points, values, centers, k: int,
                                exclude_self: bool = False):
    """Neighbourhood assembly over sharded centres and the whole cloud.

    Sharded counterpart of
    :func:`wlsqm_tpu_torch.utils.neighbors.build_neighborhoods`: returns
    (xk (M, k, dim), fk (M, k), nk (M,)), each a list of centre shards,
    ready for :func:`sharded_fit_many`.
    """
    mesh = _mesh(mesh)
    kq = k + 1 if exclude_self else k
    idx, _ = sharded_knn(mesh, points, centers, kq)
    p_all, v_all = _whole_on(mesh, points), _whole_on(mesh, values)
    xk, fk, nk = [], [], []
    for i, p, v in zip(idx, p_all, v_all):
        if exclude_self:
            i = i[:, 1:]
        xk.append(p[i])
        fk.append(v[i])
        nk.append(torch.full((i.shape[0],), k, dtype=torch.int32, device=p.device))
    return xk, fk, nk


def sharded_interpolate_nearest(mesh, fi, xi, x, *, dimension: int, order: int,
                                diff: int = 0) -> list[torch.Tensor]:
    """Nearest-model (Voronoi) evaluation over a sharded cloud.

    The local models (fi, xi) and the queries x are sharded.  Each shard
    holds every model (the JAX package all-gathers the small coefficient
    and origin arrays), picks the nearest origin of each of its queries by
    brute force and evaluates that model (reference:
    wlsqm/fitter/expert.pyx:830-895).  Returns (Q,) values as a list of
    query shards.
    """
    mesh = _mesh(mesh)
    fi_all, xi_all = _whole_on(mesh, fi), _whole_on(mesh, xi)
    q_s = _shards(mesh, x)

    def local(fi_, xi_, q):
        idx = neighbors.knn(xi_, q, 1, backend="device", device=q.device)[0][:, 0]
        return interp.eval_fit(fi_[idx], xi_[idx], q[:, None, :], dimension=dimension,
                               order=order, diff=diff, device=q.device)[:, 0]

    return _run(mesh, local, list(zip(fi_all, xi_all, q_s)))


def sharded_gather_values(mesh, values, idx, plan: gth.GatherPlan | None = None):
    """Shard-local neighbour-value gather for a distributed IBVP step.

    ``values`` (n,) or (n, F) — per-point field values, whole or sharded;
    ``idx`` (B, K) — indices into the whole cloud, sharded over cases.  Each
    shard holds the whole value array (the JAX package all-gathers it) and
    gathers its own cases' rows.

    With a ``plan`` (:class:`wlsqm_tpu_torch.ops.gather.GatherPlan` built
    for the whole ``idx`` and cloud; any other raises, as in
    :func:`~wlsqm_tpu_torch.ops.gather.gather_rows`) each shard launches
    the gather kernel on its own cases on a card, however the cases split:
    the CUDA kernel reads any index, so the TPU kernel's need for whole
    plan blocks per shard does not arise.  With ``plan=None`` the plain
    gather ``values[idx]`` serves, as in the reference.  Returns (B, K) or
    (B, K, F) values as a list of case shards, bit-identical to
    ``values[idx]``.
    """
    mesh = _mesh(mesh)
    v_all = _whole_on(mesh, values, _dtype(values))
    idx_s = _shards(mesh, idx, torch.int32)
    if plan is None:
        return _run(mesh, lambda v, i: v[i.long()], list(zip(v_all, idx_s)))
    gth._check_plan("sharded_gather_values", v_all[0].shape[0],
                    (sum(i.shape[0] for i in idx_s), idx_s[0].shape[1]), plan)
    return _run(mesh, lambda v, i: gth._gather("sharded_gather_values", v, i),
                list(zip(v_all, idx_s)))


def sharded_solve_prepared(mesh, prep, fk, fi_init=None, *, do_sens: bool = False):
    """:func:`~wlsqm_tpu_torch.fitter.engine.solve_prepared` over a
    case-sharded Prepared, with no communication.

    ``prep`` is a :class:`~wlsqm_tpu_torch.fitter.engine.Prepared` (split
    here) or a list of them from :func:`distribute`; ``fk`` is (B, K) for
    one field or (F, B, K) for F fields sharing the geometry (the
    reference's guest-solver pattern, wlsqm/fitter/expert.pyx:110-124).
    Every case solves on the shard that owns its factor.  Returns (fi,
    sens) as lists of shards along the case axis (sens None unless
    ``do_sens``).
    """
    mesh = _mesh(mesh)
    preps = prep if isinstance(prep, (list, tuple)) else _split_prepared(mesh, prep)
    sizes = [p.ncases for p in preps]
    axis = 1 if np.ndim(fk[0] if isinstance(fk, (list, tuple)) else fk) == 3 else 0
    fk_s = _shards(mesh, fk, config.DTYPE, sizes, axis)
    if fi_init is None:
        fi_s = [f.new_zeros(f.shape[:-1] + (p.no_max,)) for f, p in zip(fk_s, preps)]
    else:
        fi_s = _shards(mesh, fi_init, config.DTYPE, sizes, axis)
    res = _run(mesh, lambda p, f, g: engine.solve_prepared(p, f, g, do_sens),
               list(zip(preps, fk_s, fi_s)))
    return [r[0] for r in res], ([r[1] for r in res] if do_sens else None)
