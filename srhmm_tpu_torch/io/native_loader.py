"""ctypes bindings for the native batched .perfil loader (counterpart of
``srhmm_tpu/io/native_loader.py``).

Builds srhmm_tpu_torch/native/loader.cpp on first use (g++ -O3 -shared) into
build/srhmm_tpu_torch/native/ under the repository root, and rebuilds it
when the source is newer than the library.  A file lock serializes builds
across threads and processes, and the library is renamed into place, so no
caller loads a half-written one.  There is no fallback: when the library
cannot be built, native_available() is False and scan_perfil /
load_batch_native raise NativeLoaderUnavailable.  See loader.cpp for the
layout contract.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "loader.cpp"
# beside the CUDA kernels' libraries (ops/kernels/build.py BUILD_ROOT)
LIBRARY = PACKAGE_DIR.parent / "build" / "srhmm_tpu_torch" / "native" / "libsrhmm_loader.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class NativeLoaderUnavailable(RuntimeError):
    """The native loader could not be built or loaded."""


def _build() -> None:
    """Compile SOURCE into LIBRARY unless a library newer than the source
    exists; one build at a time (flock on a lock file beside it)."""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    with open(LIBRARY.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
            return
        tmp = LIBRARY.with_name(f".{LIBRARY.name}.{os.getpid()}")
        cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeLoaderUnavailable(f"g++ not found: {e}") from e
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeLoaderUnavailable(f"g++ failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, LIBRARY)


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the library once per process."""
    _build()
    try:
        lib = ctypes.CDLL(str(LIBRARY))
    except OSError as e:
        raise NativeLoaderUnavailable(f"cannot load {LIBRARY}: {e}") from e
    paths_t, i64, i32 = ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int32
    lib.srhmm_scan_perfil.argtypes = [paths_t, i64, ctypes.POINTER(i64)]
    lib.srhmm_scan_perfil.restype = i32
    for fn, elem in ((lib.srhmm_load_batch_f32, ctypes.c_float), (lib.srhmm_load_batch_f64, ctypes.c_double)):
        fn.argtypes = [paths_t, i64, ctypes.POINTER(elem), ctypes.POINTER(i32), ctypes.POINTER(i32), i64, i64, i32]
        fn.restype = i32
    return lib


def native_available() -> bool:
    try:
        _library()
    except NativeLoaderUnavailable:
        return False
    return True


def _paths_array(paths: list[str]):
    return (ctypes.c_char_p * len(paths))(*(p.encode() for p in paths))


def scan_perfil(paths: list[str]) -> np.ndarray:
    """(N, 2) int64 array of (frames, dim) per file; zeros on failure."""
    lib = _library()
    out = np.zeros((len(paths), 2), np.int64)
    lib.srhmm_scan_perfil(_paths_array(paths), len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def load_batch_native(
    paths: list[str],
    t_max: int,
    dim: int,
    dtype=np.float32,
    n_threads: int = 8,
    strict: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Load .perfil files into a padded (B, t_max, dim) array + (B,) lengths
    using the native worker pool (float32 or float64).  strict: a file that
    fails to open, or whose dimension is not `dim`, raises IOError."""
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(f"load_batch_native: float32 or float64, not {dtype}")
    if t_max < 0 or dim <= 0:
        raise ValueError(f"load_batch_native: t_max {t_max}, dim {dim}")
    lib = _library()
    f32 = dtype == np.float32
    fn = lib.srhmm_load_batch_f32 if f32 else lib.srhmm_load_batch_f64
    feats = np.zeros((len(paths), t_max, dim), dtype)
    lengths = np.zeros(len(paths), np.int32)
    status = np.zeros(len(paths), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn(
        _paths_array(paths),
        len(paths),
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)),
        lengths.ctypes.data_as(i32p),
        status.ctypes.data_as(i32p),
        t_max,
        dim,
        n_threads,
    )
    if strict and (status != 0).any():
        bad = [(paths[i], int(status[i])) for i in np.nonzero(status)[0][:5]]
        raise IOError(f"native loader failures (path, code): {bad}")
    return feats, lengths
