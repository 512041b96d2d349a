"""Build the package's host C sources at first use and load them with ctypes.

Each `native/<name>.c` is compiled by the host C compiler (`cc`, or `$CC`)
into its own shared library under `gradient_sdf_tpu_torch/_build/host-<hash>/`,
where the hash covers the source and the flags. A file lock serializes
concurrent builds (test workers, the smoke's phases); a finished library is
reused. A failed build raises: there is no fallback to Python code.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")
CFLAGS = ["-O2", "-std=c99", "-shared", "-fPIC"]

_libs: dict = {}


def find_cc() -> str:
    """`$CC`, else `cc` on PATH."""
    cc = os.environ.get("CC") or shutil.which("cc")
    if not cc:
        raise RuntimeError("no C compiler found (set $CC or put cc on PATH); "
                           "the package's native decoders cannot be built")
    return cc


def library_path(name: str) -> str:
    src = os.path.join(_HERE, name + ".c")
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"host-{h.hexdigest()[:16]}", f"lib{name}.so")


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `native/<name>.c`, building it first if
    needed. Raises RuntimeError with the compiler's output if the build fails."""
    if name in _libs:
        return _libs[name]
    path = library_path(name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(BUILD_ROOT, "host-build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.isfile(path):
                tmp = f"{path}.tmp{os.getpid()}"
                cmd = [find_cc()] + CFLAGS + ["-o", tmp,
                                              os.path.join(_HERE, name + ".c")]
                out = subprocess.run(cmd, capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(f"{' '.join(cmd)} failed ({out.returncode}):"
                                       f"\n{out.stdout}{out.stderr}")
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(path)
    _libs[name] = lib
    return lib
