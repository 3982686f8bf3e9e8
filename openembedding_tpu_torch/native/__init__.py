"""Native (C++) Criteo parser of the port, bound with ctypes.

Port of `openembedding_tpu/native/__init__.py` on the port's own copy of the
source (`oetpu_data.cpp`): the streaming TSV reader, the TFRecord reader and
the frequency-relabel preprocessor. The library is built with `g++` at first
use, never at import, into the port's `_build/` directory (listed in
`.gitignore`), never next to the source. Its file name carries a hash of the
source, of the compiler flags and of the host's CPU model (the build is
`-march=native`), so an edited source, another flag set or a build directory
copied from another machine is rebuilt and a stale library is never loaded. Hosts without zlib's headers get
a build with gzip support compiled out (`-DOETPU_NO_ZLIB`): a `.gz` input
then fails loudly at read time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "oetpu_data.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

# -march=native: the library is built on the machine that runs it
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")
ZLIB_FLAGS = ("-lz",)
NO_ZLIB_FLAGS = ("-DOETPU_NO_ZLIB",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

NUM_DENSE = 13
NUM_SPARSE = 26


def _cpu_model() -> str:
    """What `-march=native` compiles for: the CPU's model line."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path(extra_flags: Sequence[str]) -> str:
    """Where the library built with CXX_FLAGS + `extra_flags` lives: its
    name carries a hash of the source, of every flag and of the CPU model."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + tuple(extra_flags)).encode())
    h.update(_cpu_model().encode())
    return os.path.join(BUILD_DIR, f"liboetpu_data-{h.hexdigest()[:16]}.so")


def _compile(extra_flags: Sequence[str]) -> Tuple[Optional[str], str]:
    """Build with `extra_flags` unless that build exists -> (its path, "")
    or (None, the compiler's message)."""
    out = library_path(extra_flags)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # unique per builder: concurrent processes (pytest-xdist) and threads
    # must not share a temporary file
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp, *extra_flags]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        return None, proc.stderr
    os.replace(tmp, out)  # atomic: a racing build never sees a torn file
    return out, ""


def build() -> str:
    """Compile the shared library if no build of this source and these
    flags exists; returns its path. Tries with zlib first, then without."""
    with _lock:
        path, _ = _compile(ZLIB_FLAGS)
        if path is None:
            path, err = _compile(NO_ZLIB_FLAGS)
            if path is None:
                raise RuntimeError(f"native build failed:\n{err}")
        return path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on failure."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise RuntimeError(_build_error)
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError) as e:
        _build_error = str(e)
        raise
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.oetpu_reader_create.restype = ctypes.c_void_p
    lib.oetpu_reader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.oetpu_reader_next.restype = ctypes.c_int
    lib.oetpu_reader_next.argtypes = [ctypes.c_void_p, f32, f32, i64]
    lib.oetpu_reader_destroy.restype = None
    lib.oetpu_reader_destroy.argtypes = [ctypes.c_void_p]
    lib.oetpu_hash_category.restype = ctypes.c_int64
    lib.oetpu_hash_category.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                        ctypes.c_uint64]
    lib.oetpu_preprocess.restype = ctypes.c_int64
    lib.oetpu_preprocess.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int, i64]
    lib.oetpu_tfr_create.restype = ctypes.c_void_p
    lib.oetpu_tfr_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.oetpu_tfr_next.restype = ctypes.c_int
    lib.oetpu_tfr_next.argtypes = [ctypes.c_void_p, f32, f32, i64]
    lib.oetpu_tfr_destroy.restype = None
    lib.oetpu_tfr_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except (RuntimeError, OSError):
        return False


class _NativeReader:
    """One pass over the files per `_one_pass`, through a C reader handle
    (`<prefix>_create` / `_next` / `_destroy`); `repeat` restarts the pass.
    Each batch is a fresh set of arrays."""

    _prefix = ""
    _what = ""

    def __init__(self, paths: Sequence[str], batch_size: int, *,
                 host_id: int, num_hosts: int, num_threads: int,
                 drop_remainder: bool, repeat: bool):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError(p)
        self.paths = [os.fspath(p) for p in paths]
        self.batch_size = batch_size
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.num_threads = num_threads
        self.drop_remainder = drop_remainder
        self.repeat = repeat
        self._lib = load()

    def _create(self, arr):
        raise NotImplementedError

    def _one_pass(self) -> Iterator[Dict]:
        lib = self._lib
        create = self._create
        next_fn = getattr(lib, f"{self._prefix}_next")
        destroy = getattr(lib, f"{self._prefix}_destroy")
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        handle = create(arr)
        try:
            while True:
                labels = np.empty((self.batch_size,), np.float32)
                dense = np.empty((self.batch_size, NUM_DENSE), np.float32)
                sparse = np.empty((self.batch_size, NUM_SPARSE), np.int64)
                n = next_fn(handle, labels, dense, sparse)
                if n < 0:
                    raise IOError(f"native {self._what} failed on "
                                  f"{self.paths}")
                if n == 0:
                    return
                if n < self.batch_size:
                    if self.drop_remainder:
                        return
                    labels, dense, sparse = labels[:n], dense[:n], sparse[:n]
                yield {"sparse": {"categorical": sparse}, "dense": dense,
                       "label": labels}
                if n < self.batch_size:
                    return
        finally:
            destroy(handle)

    def __iter__(self) -> Iterator[Dict]:
        while True:
            yield from self._one_pass()
            if not self.repeat:
                return


class NativeCriteoReader(_NativeReader):
    """Streaming batches from Criteo TSV files (plain or `.gz`) via the C++
    pipeline: the same dict batches as `data.criteo.read_criteo_tsv`'s
    Python engine, byte for byte."""

    _prefix = "oetpu_reader"
    _what = "TSV reader (unreadable input?)"

    def __init__(self, paths: Sequence[str], batch_size: int, *,
                 id_space: int = 1 << 25, host_id: int = 0,
                 num_hosts: int = 1, num_threads: int = 4,
                 drop_remainder: bool = True, repeat: bool = False):
        self.id_space = id_space
        super().__init__(paths, batch_size, host_id=host_id,
                         num_hosts=num_hosts, num_threads=num_threads,
                         drop_remainder=drop_remainder, repeat=repeat)

    def _create(self, arr):
        return self._lib.oetpu_reader_create(
            arr, len(self.paths), self.batch_size, self.id_space,
            self.host_id, self.num_hosts, self.num_threads)


class NativeCriteoTFRecordReader(_NativeReader):
    """Streaming batches from the reference's TFRecord benchmark format
    (`test/benchmark/criteo_tfrecord.py` schema) with no TensorFlow: C++
    record framing (masked-CRC32C verified) and a proto-wire parser for the
    fixed Example schema, files read one after another. Yields RAW
    categorical columns; `data.criteo.read_criteo_tfrecord` folds them."""

    _prefix = "oetpu_tfr"
    _what = "TFRecord reader (corrupt frame or malformed Example)"

    def __init__(self, paths: Sequence[str], batch_size: int, *,
                 host_id: int = 0, num_hosts: int = 1, num_threads: int = 4,
                 drop_remainder: bool = True, repeat: bool = False):
        super().__init__(paths, batch_size, host_id=host_id,
                         num_hosts=num_hosts, num_threads=num_threads,
                         drop_remainder=drop_remainder, repeat=repeat)

    def _create(self, arr):
        return self._lib.oetpu_tfr_create(
            arr, len(self.paths), self.batch_size, self.host_id,
            self.num_hosts, self.num_threads)


def preprocess(in_path: str, out_path: str, min_count: int = 10) -> np.ndarray:
    """Frequency relabel (reference `test/criteo_preprocess.cpp`): rewrites
    the TSV with each categorical column renumbered by descending frequency
    (0 = rare). Returns the per-column vocab sizes (26,)."""
    lib = load()
    vocab = np.zeros((NUM_SPARSE,), np.int64)
    rows = lib.oetpu_preprocess(os.fspath(in_path).encode(),
                                os.fspath(out_path).encode(), min_count, vocab)
    if rows < 0:
        raise IOError(f"preprocess failed with code {rows} "
                      f"({in_path!r} -> {out_path!r})")
    return vocab
