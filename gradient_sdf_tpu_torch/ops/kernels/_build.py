"""Build the package's CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` source is compiled by `nvcc` into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), under
`gradient_sdf_tpu_torch/_build/<hash>/`, where the hash covers the sources
and the flags. A file lock serializes concurrent builds; a finished
library is reused. Nothing is downloaded: the build reads the sources in
this checkout and the CUDA toolkit only.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libgsdf_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_seconds = None   # wall time of this process's build (0.0 if reused)
build_log = ""         # the compiler's output (ptxas register/spill report)


def find_nvcc() -> str:
    """nvcc on PATH, then in $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _declare(lib):
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gsdf_scatter_add_f32.argtypes = [vp, vp, vp, i64, i64, ctypes.c_int, vp]
    lib.gsdf_scatter_add_f32.restype = ctypes.c_int


def load():
    """Return the loaded kernel library, building it first if needed.
    Raises RuntimeError with the compiler's output if the build fails."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = os.path.join(BUILD_ROOT, _digest(sources))
    lib_path = os.path.join(out_dir, LIB_NAME)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(BUILD_ROOT, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.isfile(lib_path):
                tmp = lib_path + f".tmp{os.getpid()}"
                cmd = [find_nvcc()] + NVCC_FLAGS + ["-o", tmp] + sources
                proc = subprocess.run(cmd, capture_output=True, text=True)
                build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                        f"{build_log}")
                os.replace(tmp, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    _declare(lib)
    _lib = lib
    return _lib
