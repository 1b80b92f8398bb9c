"""On-demand nvcc build of the package's CUDA sources, loaded with ctypes.

Counterpart of :mod:`wlsqm_tpu.native` (the on-demand g++ build of the
k-d tree).  Each library is compiled from ``wlsqm_tpu_torch/csrc/*.cu`` at
its first use on a CUDA device — never at import, so the package imports on
machines without ``nvcc`` — into ``build/wlsqm_tpu_torch/<name>-<hash>/``
beside the package, keyed by a hash of the sources, the generated headers,
the flags and the ``-D`` defines.  The library is written under a temporary name and renamed
into place, so concurrent builds never load a half-written file.  A
failed build raises with the compiler's output.

The sources expose a plain C interface (no PyTorch headers): the build takes
seconds, where a PyTorch extension takes minutes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "wlsqm_tpu_torch")

#: Hopper only: keep the "a" so sm_90a-only instructions stay available.
#: ``-Xptxas -v`` prints each kernel's registers, stack and spills into the
#: build log.  ``-fmad=false``: the sources write each fused multiply-add as
#: ``fma()`` and the compiler contracts nothing else, so a kernel's bits do
#: not depend on what else was compiled into it.
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
          signatures: dict[str, tuple], defines: tuple[str, ...] = ()) -> Library:
    """Compile ``sources`` with the generated ``headers`` and load the result.

    headers: file name -> text, written into the build directory, which is
    on the include path.  signatures: C function name -> (restype,
    argtypes), set on the loaded library.  defines: ``NAME=value`` macros
    (one source can give several libraries).  No lock is held while nvcc
    runs, so builds of different libraries started from threads run at once.
    """
    compiler = nvcc()
    dflags = ["-D" + d for d in defines]
    key = hashlib.sha256()
    for part in [compiler, " ".join(NVCC_FLAGS), " ".join(dflags)]:
        key.update(part.encode())
    for src in sources:
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
        cmd = [compiler, *NVCC_FLAGS, *dflags, "-I", out_dir, "-o", tmp, *sources]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (exit %d): %s\n%s%s" % (
                proc.returncode, " ".join(cmd), proc.stdout, proc.stderr))
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
