"""On-demand native builds, loaded with ctypes: the CUDA kernels and the
host k-d tree.

Port of :mod:`wlsqm_tpu.native` (the on-demand g++ build of the k-d tree),
which also builds the package's CUDA sources.  Each library is compiled at
its first use — never at import, so the package imports on machines without
``nvcc`` — into ``build/wlsqm_tpu_torch/<name>-<hash>/`` beside the
package, keyed by a hash of the compiler, the sources, the generated
headers, the flags and the ``-D`` defines.  The library is written under a
temporary name and renamed into place, so concurrent builds never load a
half-written file.  A failed build raises with the compiler's output.

* :func:`build` — nvcc on ``wlsqm_tpu_torch/csrc/*.cu``, at a kernel's
  first use on a CUDA device.  The sources expose a plain C interface (no
  PyTorch headers): the build takes seconds, where a PyTorch extension takes
  minutes.
* :func:`load`, :func:`available`, :class:`KDTree` — the multithreaded
  k-d tree (``kdtree.cpp``, a copy of the JAX package's) built with g++
  ``-O3 -march=native``; its hash also covers what ``-march=native`` means
  on this host, so a tree built for one CPU is not loaded on another.  Host
  code for neighbour search (the role scipy's cKDTree plays for the
  reference, wlsqm/fitter/expert.pyx:38,679);
  :func:`wlsqm_tpu_torch.utils.neighbors.host_tree` prefers it and takes
  scipy's only where there is no g++.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "wlsqm_tpu_torch")

#: Hopper only: keep the "a" so sm_90a-only instructions stay available.
#: ``-Xptxas -v`` prints each kernel's registers, stack and spills into the
#: build log.  ``-fmad=false``: the sources write each fused multiply-add as
#: ``fma()`` and the compiler contracts nothing else, so a kernel's bits do
#: not depend on what else was compiled into it.
HERE = os.path.dirname(os.path.abspath(__file__))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    """A loaded shared library and how it was built."""

    lib: ctypes.CDLL
    path: str
    build_seconds: float   # 0.0 when an earlier build was reused
    log: str               # nvcc's output (the ptxas resource report)


_lock = threading.Lock()   # guards _loaded; never held across an nvcc run
_loaded: dict[str, Library] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the default toolkit."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _write(path: str, text: str) -> None:
    tmp = "%s.tmp%d.%d" % (path, os.getpid(), threading.get_ident())
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def build(name: str, sources: list[str], headers: dict[str, str],
          signatures: dict[str, tuple], defines: tuple[str, ...] = (), *,
          compiler: str | None = None, flags: tuple[str, ...] = NVCC_FLAGS,
          host_key: str = "", includes: tuple[str, ...] = ()) -> Library:
    """Compile ``sources`` with the generated ``headers`` and load the result.

    headers: file name -> text, written into the build directory, which is
    on the include path.  signatures: C function name -> (restype,
    argtypes), set on the loaded library.  defines: ``NAME=value`` macros
    (one source can give several libraries).  compiler and flags: nvcc and
    :data:`NVCC_FLAGS` unless given; host_key: anything else the library's
    bits depend on (part of the hash); includes: headers beside the sources
    that they include (hashed, not compiled).  No lock is held while the compiler
    runs, so builds of different libraries started from threads run at once.
    """
    compiler = compiler or nvcc()
    dflags = ["-D" + d for d in defines]
    key = hashlib.sha256()
    for part in [compiler, " ".join(flags), " ".join(dflags), host_key]:
        key.update(part.encode())
    for src in (*sources, *includes):
        with open(src, "rb") as f:
            key.update(f.read())
    for fname in sorted(headers):
        key.update(fname.encode() + headers[fname].encode())
    digest = key.hexdigest()[:16]
    with _lock:
        if digest in _loaded:
            return _loaded[digest]

    out_dir = os.path.join(BUILD_ROOT, "%s-%s" % (name, digest))
    path = os.path.join(out_dir, "lib%s.so" % name)
    log_path = os.path.join(out_dir, "build.log")
    seconds = 0.0
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        for fname, text in headers.items():
            _write(os.path.join(out_dir, fname), text)
        tmp = "%s.tmp%d.%d" % (path, os.getpid(), threading.get_ident())
        cmd = [compiler, *flags, *dflags, "-I", out_dir, "-o", tmp, *sources]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError("%s failed (exit %d): %s\n%s%s" % (
                os.path.basename(compiler), proc.returncode, " ".join(cmd), proc.stdout,
                proc.stderr))
        _write(log_path, proc.stdout + proc.stderr)
        os.replace(tmp, path)
    with open(log_path) as f:
        log = f.read()
    lib = ctypes.CDLL(path)
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    with _lock:
        return _loaded.setdefault(digest, Library(lib=lib, path=path,
                                                  build_seconds=seconds, log=log))


# ---------------------------------------------------------------------------
# The host k-d tree
# ---------------------------------------------------------------------------

GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")


def _march_native(gxx: str) -> str:
    """What ``-march=native`` expands to on this host (the cc1 command line)."""
    proc = subprocess.run([gxx, "-march=native", "-E", "-v", "-x", "c++", "-"],
                          input="", capture_output=True, text=True)
    return "\n".join(line for line in proc.stderr.splitlines() if "cc1" in line)


@functools.cache
def load() -> Library | None:
    """The k-d tree's library, built with g++ at first use; None where there
    is no g++ (callers then use scipy).  A failed build raises."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    c_i64, c_int, c_dbl, c_vp = ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    p_dbl, p_i64 = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    return build("kdtree", [os.path.join(HERE, "kdtree.cpp")], {}, {
        "wlsqm_kdtree_build": (c_vp, [p_dbl, c_i64, c_int]),
        "wlsqm_kdtree_free": (None, [c_vp]),
        "wlsqm_kdtree_knn": (None, [c_vp, p_dbl, c_i64, c_int, p_i64, p_dbl, c_int]),
        "wlsqm_kdtree_radius": (None, [c_vp, p_dbl, c_i64, c_dbl, p_i64, p_i64, c_int]),
    }, compiler=gxx, flags=GXX_FLAGS, host_key=_march_native(gxx))


def available() -> bool:
    """Whether the native k-d tree can be built here (there is a g++)."""
    return load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class KDTree:
    """Native k-d tree over an (N, dim) float64 cloud.

    The slice of ``scipy.spatial.cKDTree`` the package uses:
    ``query(x, k)`` and ``query_ball_point(x, r)``, multithreaded over
    queries (``nthreads``, default every core).
    """

    def __init__(self, data, nthreads: int | None = None):
        lib = load()
        if lib is None:
            raise RuntimeError("native kdtree unavailable: no g++ on this host")
        self._lib = lib.lib
        data = np.ascontiguousarray(np.atleast_2d(data), dtype=np.float64)
        self.n, self.dim = data.shape
        self._data = data   # the tree copies the points; kept for the caller's view
        self._handle = self._lib.wlsqm_kdtree_build(_dptr(data), self.n, self.dim)
        self._nthreads = nthreads or (os.cpu_count() or 1)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.wlsqm_kdtree_free(handle)
            self._handle = None

    def query(self, x, k: int = 1, workers: int | None = None):
        """k nearest neighbours: (distances (m, k), indices (m, k)), squeezed
        to (m,) when k == 1, as scipy's.  ``workers`` (scipy's name; -1 for
        every core) overrides the tree's thread count."""
        x = np.ascontiguousarray(np.atleast_2d(x), dtype=np.float64)
        m = x.shape[0]
        idx = np.empty((m, k), dtype=np.int64)
        d2 = np.empty((m, k), dtype=np.float64)
        self._lib.wlsqm_kdtree_knn(self._handle, _dptr(x), m, k, _iptr(idx), _dptr(d2),
                                   self._threads(workers))
        d = np.sqrt(d2)
        if k == 1:
            return d[:, 0], idx[:, 0]
        return d, idx

    def _threads(self, workers) -> int:
        if workers is None:
            return self._nthreads
        return (os.cpu_count() or 1) if workers < 0 else int(workers)

    def query_ball_point(self, x, r: float):
        """All indices within radius r of each query, ascending: one list for
        a single (dim,) query, a list of m lists for an (m, dim) batch, as
        scipy's."""
        single = np.ndim(x) == 1
        x = np.ascontiguousarray(np.atleast_2d(x), dtype=np.float64)
        m = x.shape[0]
        counts = np.zeros(m, dtype=np.int64)
        self._lib.wlsqm_kdtree_radius(self._handle, _dptr(x), m, float(r), _iptr(counts),
                                      None, self._nthreads)
        flat = np.empty(int(counts.sum()), dtype=np.int64)
        self._lib.wlsqm_kdtree_radius(self._handle, _dptr(x), m, float(r), _iptr(counts),
                                      _iptr(flat), self._nthreads)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        out = [flat[offsets[i]:offsets[i + 1]].tolist() for i in range(m)]
        return out[0] if single else out
