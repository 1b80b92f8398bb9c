"""The window gather: ``u[idx]`` for the IBVP step's neighbour lookup.

Port of :mod:`wlsqm_tpu.ops.gather`.  Every time step of a meshless PDE
solver gathers the neighbour values ``fk = u[idx]`` of every case before it
solves (``examples/ibvp_heat.py`` of the JAX package; the port's
:mod:`wlsqm_tpu_torch.examples.ibvp_heat`).  The TPU kernel
(``_gather_kernel``, ``wlsqm_tpu/ops/gather.py:168``) copies two
contiguous windows of ``u`` per block of 16 cases into VMEM and selects
with a one-hot matmul, because a TPU core cannot gather from HBM; the
windows come from a host plan (:func:`plan_window_gather`) that relies on a
Morton-ordered cloud (:func:`morton_order`).

A Hopper thread loads any address, so the CUDA kernel ``csrc/gather.cu``
is a direct gather that copies bits, exact for every 4- and 8-byte payload.
One thread writes one 16-byte vector of the output with a streaming store,
reading its pieces from their rows, where the row width and the pointers'
alignment allow (:func:`_vector_plan` decides), one 32-bit word otherwise.
It serves every row, the plan's overflow blocks included.  The plan API
stays: it is the JAX package's interface, it checks that ``u``
and ``idx`` belong together, and its ``coverage`` records the locality
that Morton order buys (the kernel's reads of ``u`` then hit the L2).

* :func:`gather_rows_plain` — ``u[idx]``, what the CPU runs and what the
  kernel is checked against;
* :func:`gather_rows`, :func:`gather_rows_pair` — the wrappers: a CPU
  tensor runs the plain version, a CUDA tensor launches the kernel or
  raises.  :data:`LAUNCHES` counts kernel launches;
* :func:`gather_local` — the shard form, for one shard's slice of a plan
  (the JAX package's signature).

The kernel has no backward, as the JAX kernel has no reverse mode: a ``u``
that requires grad is refused (differentiate through ``u[idx]``).

Usage::

    perm = morton_order(pts); pts = pts[perm]   # once, at setup
    plan = plan_window_gather(idx, n)           # once per neighbourhood set
    out  = gather_rows(u, idx, plan)            # every step; == u[idx]
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import numpy as np
import torch

from wlsqm_tpu_torch import config, native
from wlsqm_tpu_torch.utils import profiling

__all__ = ["morton_order", "plan_window_gather", "gather_rows", "gather_rows_pair",
           "gather_local", "gather_rows_plain", "GatherPlan", "BLOCK_T", "WINDOW",
           "LAUNCHES"]

#: cases per block of the plan (a multiple of 8)
BLOCK_T = 16

#: width of each of the plan's two windows per block
WINDOW = 1024

#: number of CUDA kernel launches made by :func:`gather_rows` and
#: :func:`gather_rows_pair`
LAUNCHES = 0

_SRC = os.path.join(native.CSRC, "gather.cu")
_ENTRY = "wlsqm_gather_words"


def morton_order(pts) -> np.ndarray:
    """Permutation ordering points along a Morton (Z-order) curve.

    Sorting the cloud with this permutation makes kNN neighbour indices
    spatially local.  Returns ``perm`` such that ``pts[perm]`` is
    Morton-ordered; the same permutation as the JAX package's.
    """
    pts = np.asarray(pts)
    if pts.ndim == 1:
        return np.argsort(pts, kind="stable")
    lo = pts.min(axis=0)
    span = np.maximum(pts.max(axis=0) - lo, 1e-300)
    bits = 21 if pts.shape[1] <= 2 else 16
    q = ((pts - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    code = np.zeros(len(pts), np.uint64)
    for b in range(bits):
        for a in range(pts.shape[1]):
            code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * pts.shape[1] + a)
    return np.argsort(code, kind="stable")


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Static window layout of a neighbourhood set (the JAX ``GatherPlan``)."""

    meta: tuple        # flattened (s1, s2, thr) per block, tuple of ints
    bad_blocks: tuple  # block ids whose two windows do not hold their rows
    nblk: int
    T: int             # cases per block
    K: int
    n: int             # rows of the cloud the plan was built for
    n_pad: int         # padded u rows (>= max(start) + WINDOW)
    window: int

    @property
    def coverage(self) -> float:
        """Fraction of blocks whose rows lie in their two windows."""
        return 1.0 - len(self.bad_blocks) / max(self.nblk, 1)


def plan_window_gather(idx, n: int, *, block_t: int = BLOCK_T,
                       window: int = WINDOW,
                       max_bad_frac: float = 0.25) -> GatherPlan | None:
    """Per-block dual windows of ``idx``; None if too many blocks overflow.

    idx: (B, K) int array (NumPy or tensor) of row indices into a
    length-``n`` array; an index outside [0, n) raises.  O(B·K log K) host
    work, done once per neighbourhood structure.  Same plan as the JAX
    package's, field for field.
    """
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
    B, K = idx.shape
    if block_t % 8:
        raise ValueError("block_t must be a multiple of 8; got %d" % block_t)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError("plan_window_gather: indices must lie in [0, %d); got "
                         "[%d, %d]" % (n, idx.min(), idx.max()))
    pad_b = (-B) % block_t
    if pad_b:
        idx = np.concatenate([idx, np.repeat(idx[-1:], pad_b, axis=0)])
    nblk = idx.shape[0] // block_t
    blocks = np.sort(idx.reshape(nblk, block_t * K), axis=1)
    gaps = np.diff(blocks, axis=1)
    gpos = gaps.argmax(axis=1)
    r = np.arange(nblk)
    left_hi = blocks[r, gpos]
    right_lo = blocks[r, np.minimum(gpos + 1, blocks.shape[1] - 1)]
    lo = blocks[:, 0]
    hi = blocks[:, -1]
    # window starts aligned down to 128 rows, as the TPU kernel's lane
    # tiling needs; overflow is judged against the aligned starts
    s1 = ((lo // 128) * 128).astype(np.int64)
    s2 = ((right_lo // 128) * 128).astype(np.int64)
    left_ok = left_hi - s1 < window
    right_ok = hi - s2 < window
    bad = ~(left_ok & right_ok)
    if bad.mean() > max_bad_frac:
        return None
    thr = right_lo.astype(np.int32)        # idx >= thr -> window 2
    # single-cluster blocks: everything through window 1
    single = hi - s1 < window
    thr = np.where(single, np.int32(n + window), thr)
    s2 = np.where(single, s1, s2)
    n_pad = int(max(n, max(s1.max(initial=0), s2.max(initial=0)) + window))
    n_pad = -(-n_pad // 128) * 128
    meta = np.stack([s1.astype(np.int32), s2.astype(np.int32), thr], axis=1)
    return GatherPlan(meta=tuple(int(v) for v in meta.ravel()),
                      bad_blocks=tuple(int(b) for b in np.nonzero(bad)[0]),
                      nblk=nblk, T=block_t, K=K, n=int(n), n_pad=n_pad,
                      window=window)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def gather_rows_plain(u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``u[idx]``: u (n,) or (n, F), idx (B, K) -> (B, K) or (B, K, F)."""
    return u[idx.long()]


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def load() -> native.Library:
    """The kernel's shared library, built with nvcc on first use."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    return native.build("gather", [_SRC], {},
                        {_ENTRY: (i32, [vp, vp, vp, vp, vp, i64, i64, i32, i32, vp])})


def _vector_plan(row_bytes: int, u_ptr: int, out_ptr: int):
    """The kernel instance for rows of ``row_bytes`` bytes: the piece width
    ``load`` (16, 8 or 4 bytes) of the vector instance, whose threads each
    write one 16-byte vector of the output from pieces of that width, or
    None for the word instance.

    The vector instance takes rows of any whole number of words with
    ``out_ptr`` 16-byte aligned (rows of 1, 2, 3, 4 or 6 words by a
    template of their width, the rest by one with the width an argument);
    ``load`` is the widest of 16, 8 and 4 bytes that divides the row and ``u_ptr``.
    Pass the OR of both planes' pointers for the pair (the OR's alignment is
    the smaller one).  Width and alignment decide, never a failure.
    """
    if row_bytes % 4 or row_bytes <= 0 or out_ptr % 16:
        return None
    return next(b for b in (16, 8, 4) if row_bytes % b == 0 and u_ptr % b == 0)


def _launch(words, idx, out) -> None:
    """Launch the kernel on the current stream: ``out[p][r, :] =
    words[p][idx[r], :]`` for each plane p of ``words`` (a list of one or
    two (n, W) int32 tensors) into the matching ``out`` tensor (R, W), with
    idx (R,) int32.  The instance comes from :func:`_vector_plan`.  Checks
    device, dtype, shape and contiguity, and raises on a refused launch (the
    C entry returns ``cudaGetLastError()``).  Does not synchronise."""
    global LAUNCHES
    if not 1 <= len(words) == len(out) <= 2:
        raise ValueError("gather kernel takes one or two planes")
    n, W = words[0].shape
    R = idx.shape[0]
    dev = idx.device
    for t, shape, dtype in [(idx, (R,), torch.int32),
                            *[(w, (n, W), torch.int32) for w in words],
                            *[(o, (R, W), torch.int32) for o in out]]:
        if (t.device != dev or t.device.type != "cuda" or tuple(t.shape) != shape
                or t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(
                "gather kernel wants contiguous %s %s on one CUDA device; got "
                "%s %s on %s (idx on %s)"
                % (dtype, shape, t.dtype, tuple(t.shape), t.device, dev))
    if n == 0 or W == 0:
        raise ValueError("gather kernel: u has no rows or no words")
    if R == 0:
        return
    second = len(words) == 2
    u_ptrs = [w.data_ptr() for w in words]
    out_ptrs = [o.data_ptr() for o in out]
    load_bytes = _vector_plan(4 * W, functools.reduce(int.__or__, u_ptrs),
                              functools.reduce(int.__or__, out_ptrs))
    lib = load().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = getattr(lib, _ENTRY)(
            u_ptrs[0], u_ptrs[1] if second else None, idx.data_ptr(), out_ptrs[0],
            out_ptrs[1] if second else None, n, R, W, load_bytes or 0, stream)
    if status != 0:
        raise RuntimeError("gather kernel launch failed: CUDA error %d" % status)
    LAUNCHES += 1


def _check_plan(name, n, shape, plan: GatherPlan):
    """Raise unless a cloud of ``n`` rows and indices of ``shape`` (B, K) are
    those ``plan`` was built for."""
    if n != plan.n:
        raise ValueError("%s: u has %d rows but the GatherPlan was built for n=%d; "
                         "rebuild the plan for this cloud" % (name, n, plan.n))
    B, K = shape
    if K != plan.K or -(-B // plan.T) != plan.nblk:
        raise ValueError("%s: idx has shape %s but the GatherPlan was built for K=%d "
                         "and %d blocks of %d; rebuild the plan for these indices"
                         % (name, tuple(shape), plan.K, plan.nblk, plan.T))


def _as_idx(idx, device) -> torch.Tensor:
    """idx as an int32 tensor on ``device`` (no copy when it already is)."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(idx), dtype=torch.int32, device=device)


def _words(u2d: torch.Tensor) -> torch.Tensor:
    """(n, F) payload as its (n, F·itemsize/4) int32 words (a view)."""
    return u2d.contiguous().view(torch.int32)


_GRAD_HINT = "differentiate through u[idx] (gather_rows_plain)"


def _gather(name: str, u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``u[idx]`` for u (n,) or (n, F) and idx (B, K) int32 on u's device:
    the plain version on the CPU, the kernel on every row on the card."""
    config.refuse_grad(name, _GRAD_HINT, u)
    squeeze = u.ndim == 1
    u2d = u[:, None] if squeeze else u
    if u2d.element_size() not in (4, 8):
        raise TypeError("%s supports 4- and 8-byte dtypes; got %s" % (name, u.dtype))
    if u.device.type == "cpu":
        return gather_rows_plain(u, idx)
    B, K = idx.shape
    words = _words(u2d)
    out = torch.empty((B * K, words.shape[1]), dtype=torch.int32, device=u.device)
    _launch([words], idx.reshape(-1), [out])
    res = out.view(u.dtype).reshape(B, K, u2d.shape[1])
    return res[..., 0] if squeeze else res


def gather_rows(u: torch.Tensor, idx, plan: GatherPlan) -> torch.Tensor:
    """``u[idx]`` through the gather kernel; u (n,) or (n, F), idx (B, K).

    Bit-identical to ``u[idx]`` for every 4- and 8-byte dtype (float64,
    float32, int32, int64, ...): the kernel copies bits.  A CPU
    tensor runs :func:`gather_rows_plain`; a CUDA tensor launches the kernel
    for every row, or raises.  Returns the shape and dtype of ``u[idx]``.
    Its host work, the checks and the launch, is the span ``gather.checks``.
    """
    with profiling.span("gather.checks"):
        idx = _as_idx(idx, u.device)
        _check_plan("gather_rows", u.shape[0], idx.shape, plan)
        return _gather("gather_rows", u, idx)


def gather_local(v_all: torch.Tensor, idx_s, meta_s, bad_s, *, window: int, TKp: int,
                 n_pad: int, T: int) -> torch.Tensor:
    """One shard's ``v_all[idx_s]`` against the whole value array.

    The shard form of :func:`gather_rows`, with the JAX package's signature
    (``wlsqm_tpu/ops/gather.py:417``, less ``interpret``), for a caller
    that holds one shard's slice of a plan: ``meta_s`` is the shard's slice
    of the plan's per-block windows, (Bs / T, 3) or flat, ``bad_s`` its
    overflow rows as shard-local case rows, padded with 0.  The TPU kernel
    needs the windows at run time and patches the overflow rows with a
    plain gather; the CUDA kernel reads any index, so it gathers every row
    of ``idx_s`` itself and ``meta_s`` / ``bad_s`` / ``window`` / ``TKp`` /
    ``n_pad`` are checked, not read.  (:func:`wlsqm_tpu_torch.parallel.
    sharding.sharded_gather_values` needs no slice of the plan: it launches
    the kernel on each shard's indices however the cases split.)

    v_all (n,) or (n, F) of a 4- or 8-byte dtype; idx_s (Bs, K) int with
    ``Bs == (number of blocks in meta_s) * T``.  Bit-identical to
    ``v_all[idx_s]``.
    """
    idx_s = _as_idx(idx_s, v_all.device)
    n_meta = meta_s.numel() if isinstance(meta_s, torch.Tensor) else np.size(meta_s)
    bad = np.asarray(bad_s.cpu() if isinstance(bad_s, torch.Tensor) else bad_s)
    Bs, K = idx_s.shape
    n = v_all.shape[0]
    if n_meta % 3 or Bs != (n_meta // 3) * T:
        raise ValueError("gather_local: idx_s has %d rows but meta_s holds %d blocks of "
                         "T=%d" % (Bs, n_meta // 3, T))
    if TKp < T * K or n_pad < n or window <= 0:
        raise ValueError("gather_local: the layout (window=%d, TKp=%d, n_pad=%d) does not "
                         "hold blocks of %d x %d over %d rows" % (window, TKp, n_pad, T, K, n))
    if bad.size and (bad.min() < 0 or bad.max() >= Bs):
        raise ValueError("gather_local: overflow rows must lie in [0, %d)" % Bs)
    return _gather("gather_local", v_all, idx_s)


def gather_rows_pair(u_pair, idx, plan: GatherPlan):
    """``(hi[idx], lo[idx])`` for a float32 (hi, lo) pair, in one launch.

    The JAX package's gather for an IBVP field kept as a double-single
    pair.  hi and lo: (n,) or (n, F) tensors of one shape, cast to float32
    (NumPy arrays become CPU tensors).  Bit-exact for any payload, NaN and
    inf included.  Returns the gathered pair with the trailing-axis
    convention of ``u[idx]``.
    """
    hi, lo = (p if isinstance(p, torch.Tensor) else torch.from_numpy(np.array(p))
              for p in u_pair)
    config.refuse_grad("gather_rows_pair", _GRAD_HINT, hi, lo)
    hi = hi.to(torch.float32)
    lo = lo.to(device=hi.device, dtype=torch.float32)
    if hi.shape != lo.shape:
        raise ValueError("gather_rows_pair: (hi, lo) planes must have identical "
                         "shapes, got %s vs %s" % (tuple(hi.shape), tuple(lo.shape)))
    idx = _as_idx(idx, hi.device)
    _check_plan("gather_rows_pair", hi.shape[0], idx.shape, plan)
    if hi.device.type == "cpu":
        return gather_rows_plain(hi, idx), gather_rows_plain(lo, idx)
    squeeze = hi.ndim == 1
    planes = [_words(p[:, None] if squeeze else p) for p in (hi, lo)]
    B, K = idx.shape
    out = [torch.empty((B * K, planes[0].shape[1]), dtype=torch.int32, device=hi.device)
           for _ in planes]
    _launch(planes, idx.reshape(-1), out)
    res = [o.view(torch.float32).reshape(B, K, -1) for o in out]
    if squeeze:
        return res[0][..., 0], res[1][..., 0]
    return res[0], res[1]
