"""Build the package's CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` source is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), under
`gradient_sdf_tpu_torch/_build/<hash>/`, where the hash covers the sources
and the flags. A file lock serializes concurrent builds; a finished
library is reused, and the compiler's output is kept beside it. Nothing is downloaded: the build reads the sources in
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
LOG_NAME = "build.log"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags for single sources. The march decides which voxel a probe reads by
# rounding o + s*d, the GN residual pass which voxel a point reads by
# rounding (R x + t) / vs, fusion's walk which voxel a sample lands in by
# rounding ((z + k vs) R h + t) / vs: all three are built without fused
# multiply-adds, so that each and its plain PyTorch version round alike (see
# the notes in the sources).
SOURCE_FLAGS = {"raycast_march.cu": ["-fmad=false"],
                "gn_track.cu": ["-fmad=false"],
                "fuse_integrate.cu": ["-fmad=false"]}

_lib = None
build_seconds = None   # wall time of this process's build (0.0 if reused)
build_log = ""         # the build's compiler output (ptxas register/spill
                       # report), read back from LOG_NAME if it was reused
lib_path = None        # the loaded shared library's file


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
    """Hash of the flags, the sources and the headers they share."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(s).encode())
        h.update(" ".join(SOURCE_FLAGS.get(os.path.basename(s), [])).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _declare(lib):
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    # idx, five field pointers, sample stride, out, row stride, n, out_size,
    # nf, stream
    lib.gsdf_scatter_add_f32.argtypes = (
        [vp] * 6 + [i64, vp, i64, i64, i64, ctypes.c_int, vp])
    lib.gsdf_scatter_add_f32.restype = ctypes.c_int
    # acc, five fields, num_active, num_blocks, voxels_per_block, with_grad,
    # stream
    lib.gsdf_merge_clear_f32.argtypes = (
        [vp] * 7 + [i64, i64, ctypes.c_int, vp])
    lib.gsdf_merge_clear_f32.restype = ctypes.c_int
    # blocks, threads, stream: the empty kernel that measures the launch floor
    lib.gsdf_empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, vp]
    lib.gsdf_empty_launch.restype = ctypes.c_int
    # origins, dirs, s0, s_end, directory, coarse_occ, dist, weight, found,
    # s_mid, s_star, stats and touched (or both null); n, num_blocks; width,
    # dir_dim, block_shape, coarse_factor; ten float32 constants; max_steps,
    # bisect_steps; stream
    lib.gsdf_raycast_march_f32.argtypes = (
        [vp] * 13 + [i64] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] * 10
        + [ctypes.c_int] * 2 + [vp])
    lib.gsdf_raycast_march_f32.restype = ctypes.c_int
    declare_gn_track_loop(lib)
    # mode, int[3] out: the loop's cluster shape and how many fit
    lib.gsdf_gn_cluster_shape.argtypes = [ctypes.c_int, vp]
    lib.gsdf_gn_cluster_shape.restype = ctypes.c_int
    # stream: the empty kernel at the loop's one-cluster launch
    lib.gsdf_gn_cluster_empty.argtypes = [vp]
    lib.gsdf_gn_cluster_empty.restype = ctypes.c_int
    # sums, R, t, status, damping, conv_sq, stream
    lib.gsdf_gn_step_f32.argtypes = [vp] * 4 + [ctypes.c_float] * 2 + [vp]
    lib.gsdf_gn_step_f32.restype = ctypes.c_int
    # fusion's two passes: a FuseArgs structure (fuse_integrate.FuseArgs),
    # the integrate pass's field count, stream
    lib.gsdf_fuse_claim_f32.argtypes = [vp, vp]
    lib.gsdf_fuse_claim_f32.restype = ctypes.c_int
    lib.gsdf_fuse_integrate_f32.argtypes = [vp, ctypes.c_int, vp]
    lib.gsdf_fuse_integrate_f32.restype = ctypes.c_int
    # field count, int[4] out: CTAs an SM holds, SMs, threads, cooperative
    lib.gsdf_fuse_integrate_shape.argtypes = [ctypes.c_int, vp]
    lib.gsdf_fuse_integrate_shape.restype = ctypes.c_int
    # stream: the empty cooperative launch at the integrate pass's grid
    lib.gsdf_fuse_coop_empty.argtypes = [vp]
    lib.gsdf_fuse_coop_empty.restype = ctypes.c_int


def declare_gn_track_loop(lib):
    """The argument types of `gsdf_gn_track_loop_f32`: pts, n, R, t,
    directory, five fields, status, sums; mode, dir_dim, block_shape,
    slot_lo, slot_hi, num_iterations, do_step; vs, grad_scale, damping,
    conv_sq; stream."""
    vp = ctypes.c_void_p
    lib.gsdf_gn_track_loop_f32.argtypes = (
        [vp, ctypes.c_int64] + [vp] * 10 + [ctypes.c_int] * 7
        + [ctypes.c_float] * 4 + [vp])
    lib.gsdf_gn_track_loop_f32.restype = ctypes.c_int


def _compile(sources, out_dir, target) -> str:
    """One `nvcc -c` per source, all started together, then one link.
    Returns the compilers' output; raises RuntimeError if a step fails."""
    nvcc = find_nvcc()
    tag = f".tmp{os.getpid()}"
    jobs = []
    for src in sources:
        obj = os.path.join(
            out_dir, os.path.splitext(os.path.basename(src))[0] + tag + ".o")
        cmd = ([nvcc] + NVCC_FLAGS + SOURCE_FLAGS.get(os.path.basename(src), [])
               + ["-c", "-o", obj, src])
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = ""
    failed = None
    for cmd, _, proc in jobs:
        log += proc.communicate()[0]
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed is None:
            tmp = target + tag
            cmd = [nvcc, "-shared", "-o", tmp] + objs
            link = subprocess.run(cmd, capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed = (link.returncode, cmd)
            else:
                os.replace(tmp, target)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if failed is not None:
        raise RuntimeError(
            f"nvcc failed ({failed[0]}): {' '.join(failed[1])}\n{log}")
    return log


def load():
    """Return the loaded kernel library, building it first if needed.
    Raises RuntimeError with the compiler's output if the build fails."""
    global _lib, build_seconds, build_log, lib_path
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
            log_path = os.path.join(out_dir, LOG_NAME)
            if not (os.path.isfile(lib_path) and os.path.isfile(log_path)):
                build_log = _compile(sources, out_dir, lib_path)
                with open(log_path, "w") as f:
                    f.write(build_log)
            else:
                with open(log_path) as f:
                    build_log = f.read()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    _declare(lib)
    _lib = lib
    return _lib
