"""Build and load the port's CUDA kernels.

Each kernel source under `csrc/` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface and loaded with `ctypes`. The build
happens at first use, never at import, into `_build/` beside this package's
sources (listed in `.gitignore`). The library's file name carries a hash of
the source, of every header under `csrc/` (`*.cuh`, which a source may
include) and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()  # guards _LOCKS
_LOCKS: Dict[str, threading.Lock] = {}  # one per kernel: builds run in parallel
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"path", "seconds" (0.0 when a built library was reused), "log"}
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    root = os.environ.get("CUDA_HOME")
    if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
        return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's install prefix
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def digest(name: str, csrc_dir: str = CSRC_DIR) -> str:
    """The build key of `<csrc_dir>/<name>.cu`: a hash of it, of every
    `*.cuh` header beside it, and of the nvcc flags."""
    h = hashlib.sha256()
    paths = [os.path.join(csrc_dir, f"{name}.cu")]
    paths += sorted(glob.glob(os.path.join(csrc_dir, "*.cuh")))
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read()
                     + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(source: str, out: str) -> str:
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{source}:\n{log}")
    os.replace(tmp, out)  # atomic: a racing build never sees a torn file
    return log


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process.
    Different kernels may build at the same time from different threads."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        source = os.path.join(CSRC_DIR, f"{name}.cu")
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"lib{name}-{digest(name)}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.exists(path):
            log = _compile(source, path)
        BUILD_INFO[name] = {"path": path,
                            "seconds": time.perf_counter() - t0, "log": log}
        lib = ctypes.CDLL(path)
        _LIBS[name] = lib
        return lib
